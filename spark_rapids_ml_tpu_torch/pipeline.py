"""Pipeline / PipelineModel — parity with ``org.apache.spark.ml.Pipeline``.

Port of the reference's ``pipeline.py``. A pipeline chains transformers
and estimators: ``fit`` walks the stages, fitting each estimator on the
current dataset and transforming the dataset forward through every
fitted stage; the result is a ``PipelineModel`` of pure transformers.
Persistence stores each stage under ``stages/<i>_<uid>`` with its import
path (the reference's twin path for this package's classes), so
heterogeneous stage types round-trip, in either package.

Fitted pipelines FUSE (``pipeline_fusion/``): ``PipelineModel.transform``
of a plain 2-D array or tensor runs the stages' serving kernels as one
composite on the device, with host contact only at ingest and egress,
and returns what the stage-at-a-time loop returns, bit for bit. A tensor
is served where it lives and its result stays there; a host array goes
to the device in the blocks and the dtype (float64) of the families' own
host routes and comes back as numpy. ``Pipeline.fit`` of a plain host
array or ``(X, y)`` pair places it on the fit's device once, in its own
dtype, so every stage (and every tuning fold that
``tuning._DeviceFolds`` slices) works on rows that stay on the device.
DataFrame / pandas datasets keep the stage-at-a-time path: their
contract is the intermediate columns each stage appends.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import is_device_array
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model, Transformer
from spark_rapids_ml_tpu_torch.core.ingest import numpy_dtype
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    load_metadata,
    persisted_class_path,
    resolve_component_class,
    resolve_persisted_class,
    save_metadata,
)
from spark_rapids_ml_tpu_torch.core.serving import HOST_DTYPE, serve_blocks, serve_rows
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.pipeline_fusion import fuse_pipeline_stages, fusion_fit_enabled, fusion_mode
from spark_rapids_ml_tpu_torch.serving.signature import tree_map

def save_stages(owner, path: str, stages: List[Any], class_name: str) -> None:
    """Persist ``stages`` under ``<path>/stages/<i>_<uid>`` with import
    paths in the metadata, so heterogeneous stage types round-trip."""
    save_metadata(
        owner,
        path,
        class_name=class_name,
        extra_metadata={
            "stageUids": [s.uid for s in stages],
            "stageClasses": [persisted_class_path(type(s)) for s in stages],
        },
    )
    for i, stage in enumerate(stages):
        if not isinstance(stage, MLReadable):
            raise TypeError(
                f"stage {stage.uid} ({type(stage).__name__}) is not persistable"
            )
        stage.save(os.path.join(path, "stages", f"{i}_{stage.uid}"))


def load_stages(path: str, expected_class: str):
    """Load (metadata, stages) written by :func:`save_stages` — or by
    upstream Spark's ``Pipeline.SharedReadWrite``, whose metadata puts
    ``stageUids`` inside ``paramMap`` and records NO python class paths
    (each stage directory's own metadata ``class`` — a JVM name — is the
    only type information; ``resolve_component_class`` maps it)."""
    metadata = load_metadata(path, expected_class=expected_class)
    uids = metadata.get("stageUids")
    if uids is None:
        uids = metadata.get("paramMap", {}).get("stageUids", [])
    classes = metadata.get("stageClasses")
    stages: List[Any] = []
    for i, uid in enumerate(uids):
        stage_path = os.path.join(path, "stages", f"{i}_{uid}")
        if classes:
            klass = resolve_persisted_class(classes[i])
        else:
            klass = resolve_component_class(stage_path)
        stages.append(klass.load(stage_path))
    return metadata, stages


def _stage_device_capable(stage: Any) -> bool:
    """Whether a stage consumes and produces tensors in place: the
    ``_device_foldable`` estimator families, and every fitted model that
    declares a serving signature (their transforms keep a tensor where
    it lives)."""
    return bool(getattr(stage, "_device_foldable", False)) or (
        getattr(stage, "serving_signature", None) is not None
    )


def _supervised(stage: Any) -> bool:
    """A stage whose fit consumes labels (Spark: it declares labelCol)."""
    has = getattr(stage, "hasParam", None)
    return bool(has and has("labelCol"))


def _plain_matrix(x: Any) -> bool:
    """A 2-D numeric host array (the fusable, device-placeable shape)."""
    return (
        isinstance(x, np.ndarray)
        and x.ndim == 2
        and np.issubdtype(x.dtype, np.number)
    )


class Pipeline(Estimator, MLReadable):
    """``Pipeline(stages=[...]).fit(df)`` — Spark's sequential composition."""

    def __init__(self, uid: Optional[str] = None, stages: Optional[List[Any]] = None):
        super().__init__(uid)
        self.stages = list(stages or [])

    def setStages(self, value: List[Any]) -> "Pipeline":
        self.stages = list(value)
        return self

    def getStages(self) -> List[Any]:
        return self.stages

    def copy(self, extra=None) -> "Pipeline":
        """Stage-aware copy (Spark's Pipeline.copy): stages are copied
        too, each receiving the ``extra`` entries addressed to it (Param
        identity is (owner uid, name) — a tuning grid targets INNER
        stage params, which the flat ``Params.copy`` could never land).
        """
        extra = dict(extra or {})
        stages = []
        for stage in self.stages:
            if hasattr(stage, "copy"):
                sub = {
                    p: v for p, v in extra.items()
                    if getattr(p, "parent", None) == stage.uid
                }
                stages.append(stage.copy(sub))
            else:  # pragma: no cover - foreign stage objects pass through
                stages.append(stage)
        that = Pipeline(self.uid, stages)
        own = {
            p: v for p, v in extra.items()
            if getattr(p, "parent", None) == self.uid
        }
        return self._copyValues(that, own)

    @property
    def _device_foldable(self) -> bool:
        """Tuning loops (``tuning._device_fold_prep``) may hand this
        pipeline fold slices that stay on the device when EVERY stage
        consumes tensors in place: the CrossValidator/TrainValidationSplit
        inner transform→fit chain then runs fold to model with no host
        hop between the feature stages and the downstream estimator."""
        return bool(self.stages) and all(
            _stage_device_capable(s) for s in self.stages
        )

    def _save_impl(self, path: str) -> None:
        save_stages(self, path, self.stages, "org.apache.spark.ml.Pipeline")

    @classmethod
    def _load_impl(cls, path: str) -> "Pipeline":
        metadata, stages = load_stages(path, "Pipeline")
        return cls(metadata["uid"], stages)

    def _device_ingest(self, dataset: Any) -> Any:
        """Place a plain-array dataset on the fit's device ONCE for the
        whole fit, in its own dtype: every stage then fits and transforms
        tensors through the families' tensor routes, and the intermediate
        features never touch the host. Anything that isn't a plain
        numeric array (or an (X, y) pair of them) — DataFrames, pandas,
        streaming sources, tensors — is returned unchanged."""
        if not fusion_fit_enabled() or not self._device_foldable:
            return dataset
        placed = None
        if _plain_matrix(dataset):
            placed = _to_device(dataset)
        elif (
            isinstance(dataset, tuple)
            and len(dataset) == 2
            and _plain_matrix(dataset[0])
            and isinstance(dataset[1], np.ndarray)
            and np.issubdtype(np.asarray(dataset[1]).dtype, np.number)
        ):
            placed = (_to_device(dataset[0]), _to_device(np.asarray(dataset[1]).ravel()))
        if placed is None:
            return dataset
        emit(
            "pipeline_fusion", action="fit_device_ingest",
            pipeline=self.uid, stages=len(self.stages),
        )
        return placed

    @staticmethod
    def _stage_fit_input(stage: Any, current: Any) -> Any:
        """What ``stage.fit`` consumes: supervised stages see the whole
        (X, y) pair, unsupervised feature stages see the features alone
        (a labeled dataset flowing through a PCA stage must not hand the
        labels to the eigensolver)."""
        if (
            isinstance(current, tuple)
            and len(current) == 2
            and not _supervised(stage)
        ):
            return current[0]
        return current

    @staticmethod
    def _advance(transformer: Any, current: Any) -> Any:
        """Transform the dataset forward one stage. For (X, y) pairs only
        the features transform; the labels ride along for the downstream
        supervised stages."""
        if isinstance(current, tuple) and len(current) == 2:
            return (transformer.transform(current[0]), current[1])
        return transformer.transform(current)

    def fit(self, dataset: Any) -> "PipelineModel":
        fitted: List[Transformer] = []
        current = self._device_ingest(dataset)
        for i, stage in enumerate(self.stages):
            if isinstance(stage, Estimator):
                model = stage.fit(self._stage_fit_input(stage, current))
                fitted.append(model)
                if i < len(self.stages) - 1:
                    current = self._advance(model, current)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(self.stages) - 1:
                    current = self._advance(stage, current)
            else:
                raise TypeError(
                    f"pipeline stage {i} is neither Estimator nor Transformer: "
                    f"{type(stage).__name__}"
                )
        return PipelineModel(self.uid, fitted)


def _to_device(a: np.ndarray) -> torch.Tensor:
    """A host array on the fit's device, in its own dtype."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(_device.resolve_device())


class PipelineModel(Model):
    """Fitted pipeline: transform passes the dataset through every stage.

    Plain-array and tensor transforms FUSE: when every stage declares a
    serving signature and the chain's widths line up, the whole pipeline
    runs as ONE composite kernel on the device (``pipeline_fusion/``):
    the same results as the staged loop, bit for bit, with no
    intermediate host arrays. An unfusable chain warns a structured
    :class:`~spark_rapids_ml_tpu_torch.pipeline_fusion.FusionFallbackWarning`
    once and keeps the stage-at-a-time loop. ``TPUML_PIPELINE_FUSION=off``
    disables the fused path entirely.
    """

    def __init__(self, uid: Optional[str] = None, stages: Optional[List[Transformer]] = None):
        super().__init__(uid)
        self.stages = list(stages or [])

    def copy(self, extra=None) -> "PipelineModel":
        """Model.copy preserves fitted stages (Spark's contract)."""
        that = PipelineModel(self.uid, list(self.stages))
        return self._copyValues(that, extra)

    def serving_signature(self):
        """The fused pipeline's serving contract: ONE composite kernel
        over every stage's serving kernel, weights and static config — a
        :class:`~spark_rapids_ml_tpu_torch.pipeline_fusion.CompositeSignature`.
        Raises ``TypeError`` when any stage lacks a signature or the
        chain's widths do not line up (the contract for non-servable
        models)."""
        return fuse_pipeline_stages(self.stages, pipeline=self.uid, strict=True)

    def _fusable_input(self, dataset: Any):
        """The 2-D array or tensor to feed the fused kernel, or None when
        this dataset keeps the staged loop (DataFrame/pandas contracts
        carry intermediate columns; 1-D rows, tuples and streams stay
        staged)."""
        if fusion_mode() == "off" or len(self.stages) < 2:
            return None
        if _plain_matrix(dataset):
            return dataset
        if is_device_array(dataset) and dataset.dim() == 2:
            return dataset
        return None

    def transform(self, dataset: Any) -> Any:
        x = self._fusable_input(dataset)
        if x is not None:
            sig = fuse_pipeline_stages(self.stages, pipeline=self.uid)
            if sig is not None and int(x.shape[1]) == sig.n_features:
                return _serve_fused(sig, x)
        current = dataset
        for stage in self.stages:
            current = stage.transform(current)
        return current

    def _save_impl(self, path: str) -> None:
        save_stages(self, path, self.stages, "org.apache.spark.ml.PipelineModel")

    @classmethod
    def _load_impl(cls, path: str) -> "PipelineModel":
        metadata, stages = load_stages(path, "PipelineModel")
        return cls(metadata["uid"], stages)


def _serve_fused(sig, x: Any) -> Any:
    """The composite on ``x`` through ``core/serving``'s bucketed program
    cache (on the card, one CUDA graph per row bucket for the whole
    chain): a tensor where it lives (the result stays there); a host
    array in float64 blocks of ``stream_block_rows()`` rows on the
    platform's device, each block's result back as numpy — the blocks,
    buckets and dtype of the families' own host routes, so the result is
    theirs bit for bit."""
    if is_device_array(x):
        device = _device.device_of(x)
        return serve_rows(sig.kernel, x, sig.weights_on(device), static=sig.static, name=sig.name)
    device = _device.resolve_device()
    out = serve_blocks(sig.kernel, np.asarray(x), sig.weights_on(device, host=True), static=sig.static,
                       name=sig.name, device=device, dtype=HOST_DTYPE, host_dtype=numpy_dtype(HOST_DTYPE))
    if out is not None:
        return out
    # No rows: the contract's empty arrays, as the staged loop gives them.
    return tree_map(lambda s: torch.zeros(tuple(s.shape), dtype=s.dtype).numpy(),
                    sig.output_spec(0, HOST_DTYPE))


__all__ = ["Pipeline", "PipelineModel"]
