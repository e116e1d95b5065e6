"""The fuser: stage serving signatures -> one composite kernel.

Port of the reference's ``pipeline_fusion/fuser.py``. Three pieces:

- :func:`composite_kernel` builds (and caches, per chain of stage kernels
  and selects) ONE Python callable that runs the whole stage chain on the
  device: each stage's kernel on the previous stage's selected output,
  each stage's ``select`` applied in place, so a stage's outputs the
  pipeline contract never exposes are never copied anywhere. The cache
  makes the function object stable across ``serving_signature()`` calls
  and across pipelines that share a chain shape, as the reference's AOT
  program cache needs it to be.
- :func:`fuse_signatures` packs the per-stage signatures into a
  :class:`CompositeSignature`: prefixed static dicts (``s0_precision``,
  ``s1_n_classes``, ...), the stages' weight tuples passed positionally,
  and an output spec taken through the terminal stage's ``select`` on
  ``"meta"`` tensors.
- :func:`fuse_pipeline_stages` applies the chain rules to a
  ``PipelineModel``'s stages and either returns the composite or
  (non-strict) warns a structured :class:`FusionFallbackWarning` and
  returns None so the caller keeps the stage-at-a-time path.

The composite is the stages' kernels one after the other with every
intermediate on the device. ``core/serving.py``'s bucketed program cache
captures it as one CUDA graph per row bucket on the card; the kernel
cache keeps its function object, and so its program key, stable across
calls.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from spark_rapids_ml_tpu_torch.observability import costs as _costs
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature, tree_leaves
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

FUSION_ENV = "TPUML_PIPELINE_FUSION"
FUSION_FIT_ENV = "TPUML_PIPELINE_FUSION_FIT"


def fusion_mode() -> str:
    """``auto`` (fuse array transforms when the whole chain is fusable)
    or ``off`` (always stage-at-a-time)."""
    return env_choice(FUSION_ENV, ("auto", "off"), "auto")


def fusion_fit_enabled() -> bool:
    """Whether ``Pipeline.fit`` may place a plain-array dataset on the
    device once and feed every stage intermediates that stay there."""
    return env_choice(FUSION_FIT_ENV, ("auto", "off"), "auto") == "auto"


class FusionFallbackWarning(UserWarning):
    """A pipeline could not fuse; transform falls back stage-at-a-time.

    Structured: ``pipeline`` (uid), ``stage`` (index or None for
    chain-level reasons), ``reason`` — so callers and tests can assert
    WHY a chain degraded instead of pattern-matching message text.
    """

    def __init__(self, pipeline: str, reason: str, stage: Optional[int] = None):
        self.pipeline = pipeline
        self.reason = reason
        self.stage = stage
        where = f" (stage {stage})" if stage is not None else ""
        super().__init__(
            f"pipeline {pipeline} not fused{where}: {reason}; "
            "transform runs stage-at-a-time"
        )


@dataclass
class CompositeSignature(ServingSignature):
    """A fused pipeline's serving contract: a :class:`ServingSignature`
    plus the chain's provenance, the stage families it composes.
    ``weights`` is a tuple of per-stage weight tuples, passed positionally
    to the composite kernel (``host_weights`` likewise, for host input);
    ``static`` is the prefixed union of the stages' static dicts."""

    stage_names: Tuple[str, ...] = ()


#: Composite kernels by (stage kernels, stage selects): ONE function
#: object per chain shape.
_COMPOSITE_KERNELS: Dict[tuple, Callable] = {}  # guarded-by: _KERNEL_LOCK
_KERNEL_LOCK = make_lock("pipeline_fusion.kernels")


def _demux_static(static: Dict[str, Any], n_stages: int) -> List[Dict[str, Any]]:
    """Split ``{"s0_precision": ..., "s1_n_classes": ...}`` back into
    per-stage static dicts (the inverse of the fuse-time prefixing)."""
    per: List[Dict[str, Any]] = [{} for _ in range(n_stages)]
    for key, value in static.items():
        idx, _, inner = key.partition("_")
        per[int(idx[1:])][inner] = value
    return per


def composite_kernel(
    kernels: Tuple[Callable, ...], selects: Tuple[Optional[Callable], ...]
) -> Callable:
    """The one callable for a stage chain: runs ``kernels[i]`` on the
    previous stage's (selected) output, applying each stage's
    ``select`` on the device, where the outputs it drops stay."""
    key = (tuple(kernels), tuple(selects))
    with _KERNEL_LOCK:
        fused = _COMPOSITE_KERNELS.get(key)
        if fused is not None:
            return fused

    def _fused_pipeline(x, *stage_weights, **static):
        per_stage = _demux_static(static, len(kernels))
        out: Any = x
        for i, kernel in enumerate(kernels):
            feed = out if i == 0 else tree_leaves(out)[0]
            out = kernel(feed, *stage_weights[i], **per_stage[i])
            if selects[i] is not None:
                out = selects[i](out)
        return out

    def _fused_cost(rows, d, dtype, stage_weights, static):
        """The stages' counts summed, each at the width its predecessor
        hands it (``out_width``)."""
        per_stage = _demux_static(static, len(kernels))
        parts, width = [], d
        for i, kernel in enumerate(kernels):
            part = _costs.kernel_cost(kernel, rows, width, dtype, stage_weights[i], per_stage[i])
            parts.append(part)
            if part is None:
                break
            width = part.get("out_width", width)
        return _costs.sum_costs(parts)

    _costs.register_cost(_fused_pipeline, _fused_cost)
    _fused_pipeline.__name__ = "fused_" + "__".join(
        getattr(k, "__name__", "kernel").lstrip("_") for k in kernels
    )
    _fused_pipeline.__qualname__ = _fused_pipeline.__name__
    with _KERNEL_LOCK:
        return _COMPOSITE_KERNELS.setdefault(key, _fused_pipeline)


def _feed_spec(sig: ServingSignature):
    """The (leaf, width) a stage hands its successor: the first leaf of
    its transform-contract output for a probe batch, or (None, None)
    when the stage cannot feed a downstream kernel (non-2-D, or a
    multi-leaf contract with no defined feed)."""
    probe = sig.output_spec(8, sig.weights_dtype())
    if sig.select is not None:
        probe = sig.select(probe)
    leaves = tree_leaves(probe)
    if len(leaves) != 1 or leaves[0].dim() != 2:
        return None, None
    return leaves[0], int(leaves[0].shape[1])


def fuse_signatures(
    sigs: Sequence[ServingSignature], *, name: Optional[str] = None
) -> CompositeSignature:
    """Compose stage signatures into one :class:`CompositeSignature`.

    Chain rules (the caller is expected to have verified them via
    :func:`fuse_pipeline_stages`; violations raise ``ValueError``):
    every non-terminal stage must yield a single 2-D output whose width
    matches the next stage's ``n_features``.
    """
    if not sigs:
        raise ValueError("cannot fuse an empty stage chain")
    for i, sig in enumerate(sigs[:-1]):
        _, width = _feed_spec(sig)
        if width is None:
            raise ValueError(
                f"stage {i} ({sig.name}) does not produce a single 2-D "
                "feature block; it cannot feed a downstream stage"
            )
        if width != sigs[i + 1].n_features:
            raise ValueError(
                f"stage {i} ({sig.name}) emits width {width} but stage "
                f"{i + 1} ({sigs[i + 1].name}) expects "
                f"{sigs[i + 1].n_features} features"
            )

    kernels = tuple(s.kernel for s in sigs)
    selects = tuple(s.select for s in sigs)
    static = {
        f"s{i}_{k}": v for i, s in enumerate(sigs) for k, v in s.static.items()
    }
    last = sigs[-1]
    if last.select is None:
        out_spec = last.output_spec
    else:
        def out_spec(n, dtype, _last=last):
            return _last.select(_last.output_spec(n, dtype))

    host = any(s.host_weights is not None for s in sigs)
    return CompositeSignature(
        kernel=composite_kernel(kernels, selects),
        weights=tuple(s.weights for s in sigs),
        static=static,
        name=name or ("fused:" + "+".join(s.name for s in sigs)),
        n_features=int(sigs[0].n_features),
        output_spec=out_spec,
        host_weights=tuple(s.host_weights if s.host_weights is not None else s.weights
                           for s in sigs) if host else None,
        stage_names=tuple(s.name for s in sigs),
    )


def fuse_pipeline_stages(
    stages: Sequence[Any], *, pipeline: str, strict: bool = False
) -> Optional[CompositeSignature]:
    """Resolve every stage's ``serving_signature()`` and fuse the chain.

    Non-strict (the transform path): any unfusable link warns ONE
    structured :class:`FusionFallbackWarning` and returns None — the
    caller keeps the stage-at-a-time loop. Strict (where a pipeline must
    BE a servable): the same condition raises ``TypeError``, the
    registry's contract for models without a serving signature.
    """

    def bail(reason: str, stage: Optional[int] = None):
        bump_counter("pipeline.fusion.fallback")
        emit(
            "pipeline_fusion", action="fallback", pipeline=pipeline,
            stage=stage, reason=reason,
        )
        if strict:
            raise TypeError(f"pipeline {pipeline} is not fusable: {reason}")
        warnings.warn(
            FusionFallbackWarning(pipeline, reason, stage), stacklevel=3
        )
        return None

    if not stages:
        return bail("pipeline has no stages")
    sigs: List[ServingSignature] = []
    for i, stage in enumerate(stages):
        sig_fn = getattr(stage, "serving_signature", None)
        if sig_fn is None:
            return bail(
                f"{type(stage).__name__} declares no serving_signature()", i
            )
        try:
            sigs.append(sig_fn())
        except Exception as exc:
            return bail(
                f"{type(stage).__name__}.serving_signature() failed: {exc}", i
            )
    for i, sig in enumerate(sigs[:-1]):
        _, width = _feed_spec(sig)
        if width is None:
            return bail(
                f"{sig.name} does not produce a single 2-D feature block", i
            )
        if width != sigs[i + 1].n_features:
            return bail(
                f"{sig.name} emits width {width} but {sigs[i + 1].name} "
                f"expects {sigs[i + 1].n_features} features", i,
            )
    fused = fuse_signatures(sigs)
    bump_counter("pipeline.fusion.fused")
    emit(
        "pipeline_fusion", action="fused", pipeline=pipeline,
        stages=list(fused.stage_names), name=fused.name,
    )
    return fused
