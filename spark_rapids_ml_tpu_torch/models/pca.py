"""PCA estimator/model — port of the reference's ``models/pca.py``.

The param surface is the reference's, name for name (``k``, ``inputCol``,
``outputCol``, ``meanCentering``, ``useGemm``, ``useCuSolverSVD``, ``gpuId``,
``solver``, ``precision``, ``covarianceBackend``, ``eigenSolver``,
``eigenIters``), so a model saved by either package loads in the other.

``covarianceBackend``: ``"xla"`` (default; alias ``"torch"``) centres and
multiplies with plain torch; ``"pallas"`` (alias ``"cuda"``) runs the
Gram on the hand-written kernel K1. Aliases are stored as the reference's
spelling.

``solver``: ``"covariance"`` forms the (d, d) covariance and solves it;
``"randomized"`` runs the sketch of ``ops/randomized.py`` (no (d, d)
anything); ``"auto"`` (default) takes the sketch at d ≥ 4096 features, as
the reference does, except where the covariance path was asked for by
``precision="dd"`` or ``covarianceBackend="pallas"``, or the input is a
one-shot generator (which cannot be read twice).

Streaming sources (a block iterator, a block reader, a zero-argument
iterator factory) fit at constant memory: one pass of the shifted
covariance, or the multi-pass streaming sketch for a re-iterable source;
``transform`` of a stream yields one numpy block per non-empty block.

``useGemm=False`` takes the packed spr route of ``linalg/row_matrix.py``
(native float64 accumulator, else the packed Gram on the card).

Every fit passes the fit memory guard (``core/membudget.py``), as in the
reference: a host input over the budget refits through a
``HostArrayBlockReader`` on the streaming route an explicit reader takes
(bit-identical to it), and a device OOM mid-fit takes the same exit;
``covarianceBackend="pallas"`` cannot stream, so it raises
``FitMemoryError`` instead.

With a mesh (``PCA(mesh=make_mesh(...))``, or ``setDeployMode("gang")``
in a gang) the covariance routes run over it (``linalg/row_matrix.py``)
and the sketch runs row-sharded (``ops/randomized.py``); a mesh fit is
admitted as it is, without a streaming reroute, as in the reference.
``covarianceBackend="pallas"`` refuses a mesh, as in the reference, with
one exception the reference lacks: in a gang, each member's resident
tensor runs K1 where it lives and the members' moments merge in one
all-reduce (``setDeployMode("gang").setCovarianceBackend("pallas")
.fit(x_local)`` in every member).
``"auto"`` keeps the covariance for a wide input whose model axis would
pad the features (the sketch does not shard the model axis); the
streaming sketch and the sketch in a gang refuse a mesh.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import (
    DataFrame,
    as_matrix,
    as_partitions,
    extract_column,
    infer_input_dtype,
    is_device_array,
    is_reiterable_stream,
    is_streaming_source,
    iter_stream_blocks,
    num_features,
    peek_stream_width,
)
from spark_rapids_ml_tpu_torch.core import membudget
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, HasInputCol, HasOutputCol, Model
from spark_rapids_ml_tpu_torch.core.ingest import place_array
from spark_rapids_ml_tpu_torch.core.lazy_state import LazyHostState
from spark_rapids_ml_tpu_torch.core.params import Param, gt, toBoolean, toInt, toString
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    get_and_set_params,
    load_data,
    load_metadata,
    save_data,
    save_metadata,
)
from spark_rapids_ml_tpu_torch.core.serving import note_device_cache, serve_blocks, serve_rows, serve_stream
from spark_rapids_ml_tpu_torch.linalg.row_matrix import RowMatrix, pallas_gang_tensor
from spark_rapids_ml_tpu_torch.ops.linalg import project_rows, validate_precision
from spark_rapids_ml_tpu_torch.ops.precision import resolve_policy
from spark_rapids_ml_tpu_torch.ops.randomized import randomized_pca, randomized_pca_streaming
from spark_rapids_ml_tpu_torch.parallel.collectives import process_count
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    device_array_rows_on_mesh,
    model_axis_size,
    shard_rows_from_partitions,
)
from spark_rapids_ml_tpu_torch.observability import costs as _costs
from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature, spec
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

#: Port spellings of ``covarianceBackend`` -> the reference's spelling.
BACKEND_ALIASES = {"xla": "xla", "torch": "xla", "pallas": "pallas", "cuda": "pallas"}


def _project_kernel(x, pc, *, precision: str = "highest"):
    """Serving kernel: rows onto the principal subspace (components
    follow the batch dtype)."""
    return project_rows(x, pc.to(x.dtype), precision=precision)


def _project_cost(rows, d, dtype, weights, static):
    """The projection's work: one (rows, d) · (d, k) GEMM."""
    k = int(weights[0].shape[1])
    return dict(_costs.gemm_cost(rows, d, k, _costs.itemsize(dtype)), out_width=k)


_costs.register_cost(_project_kernel, _project_cost)


class _PCAParams(HasInputCol, HasOutputCol):
    """RapidsPCAParams equivalent."""

    k = Param("_", "k", "number of principal components", lambda v: gt(0)(toInt(v)))
    meanCentering = Param("_", "meanCentering", "whether to center data before covariance", toBoolean)
    useGemm = Param("_", "useGemm", "use dense fused GEMM covariance (else packed spr layout)", toBoolean)
    useCuSolverSVD = Param(
        "_", "useCuSolverSVD", "use the accelerated (cuSOLVER) eigensolver instead of host SVD", toBoolean
    )
    gpuId = Param("_", "gpuId", "CUDA device ordinal; -1 = the first device", toInt)
    solver = Param(
        "_", "solver", "auto | covariance | randomized (wide-feature sketch)", toString
    )
    precision = Param(
        "_",
        "precision",
        "auto | default | high | highest | dd (float64) | f32 | bf16x3 | bf16",
        toString,
    )
    covarianceBackend = Param(
        "_",
        "covarianceBackend",
        "xla (plain torch, default; alias torch) | pallas (CUDA kernel K1; alias cuda)",
        toString,
    )
    eigenSolver = Param(
        "_",
        "eigenSolver",
        "auto (self-selecting, default) | full (exact eigh) | "
        "topk (subspace iteration, k << d)",
        toString,
    )
    eigenIters = Param(
        "_",
        "eigenIters",
        "subspace iterations for eigenSolver='topk' (raise for slowly "
        "decaying spectra: subspace error ~ (lambda_{k+1}/lambda_k)^iters)",
        toInt,
    )

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            meanCentering=True, useGemm=True, useCuSolverSVD=True, gpuId=-1,
            solver="auto", precision="auto", covarianceBackend="xla",
            eigenSolver="auto", eigenIters=8,
        )

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def getMeanCentering(self) -> bool:
        return self.getOrDefault(self.meanCentering)

    def getUseGemm(self) -> bool:
        return self.getOrDefault(self.useGemm)

    def getUseCuSolverSVD(self) -> bool:
        return self.getOrDefault(self.useCuSolverSVD)

    def getGpuId(self) -> int:
        return self.getOrDefault(self.gpuId)

    def getSolver(self) -> str:
        return self.getOrDefault(self.solver)

    def getPrecision(self) -> str:
        return self.getOrDefault(self.precision)

    def getCovarianceBackend(self) -> str:
        value = self.getOrDefault(self.covarianceBackend)
        return BACKEND_ALIASES.get(value, value)

    def getEigenSolver(self) -> str:
        return self.getOrDefault(self.eigenSolver)

    def getEigenIters(self) -> int:
        return self.getOrDefault(self.eigenIters)


class PCA(_PCAParams, Estimator, MLReadable):
    """PCA estimator. ``PCA().setK(3).setInputCol("features").fit(df)``."""

    # Consumes tensors in place, so tuning loops may feed fold slices
    # that stay on the device (tuning._device_fold_prep).
    _device_foldable = True

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.mesh = mesh

    def setK(self, value: int) -> "PCA":
        self.set(self.k, value)
        return self

    def setMeanCentering(self, value: bool) -> "PCA":
        self.set(self.meanCentering, value)
        return self

    def setUseGemm(self, value: bool) -> "PCA":
        self.set(self.useGemm, value)
        return self

    def setUseCuSolverSVD(self, value: bool) -> "PCA":
        self.set(self.useCuSolverSVD, value)
        return self

    def setGpuId(self, value: int) -> "PCA":
        self.set(self.gpuId, value)
        return self

    def setMesh(self, mesh) -> "PCA":
        self.mesh = mesh
        return self

    def setSolver(self, value: str) -> "PCA":
        if value not in ("auto", "covariance", "randomized"):
            raise ValueError(
                f"solver must be auto/covariance/randomized, got {value!r}"
            )
        self.set(self.solver, value)
        return self

    def setPrecision(self, value: str) -> "PCA":
        """Matmul precision of the covariance path; ``"dd"`` (the
        reference's fp64 emulation) is native float64 here."""
        self.set(self.precision, validate_precision(value))
        return self

    def setEigenSolver(self, value: str) -> "PCA":
        """``"auto"`` (default): subspace iteration that promotes itself to
        the full eigensolver when the spectrum defeats it; ``"topk"``:
        subspace iteration + Rayleigh–Ritz; ``"full"``: exact eigh."""
        if value not in ("auto", "full", "topk"):
            raise ValueError(f"eigenSolver must be auto|full|topk, got {value!r}")
        self.set(self.eigenSolver, value)
        return self

    def setEigenIters(self, value: int) -> "PCA":
        if value < 1:
            raise ValueError(f"eigenIters must be >= 1, got {value}")
        self.set(self.eigenIters, value)
        return self

    def setCovarianceBackend(self, value: str) -> "PCA":
        """``"xla"`` (alias ``"torch"``): plain torch centre + matmul;
        ``"pallas"`` (alias ``"cuda"``): the hand-written kernel K1."""
        if value not in BACKEND_ALIASES:
            raise ValueError(
                f"covarianceBackend must be xla|pallas (or torch|cuda), got {value!r}"
            )
        self.set(self.covarianceBackend, BACKEND_ALIASES[value])
        return self

    # Above this many features "auto" switches to the randomized sketch:
    # the (d, d) covariance and its eigensolve grow as d² and d³, the
    # sketch as n·d·l with l = k + oversample.
    _RANDOMIZED_AUTO_DIM = 4096

    def _fit(self, dataset: Any) -> "PCAModel":
        rows = extract_column(dataset, self.getInputCol())
        # Over budget, the input re-enters as a block reader: the streaming
        # route an explicit reader takes, bit for bit. (The reference
        # re-enters _fit, whose own recovery turns a streaming OOM into
        # FitMemoryError before the block rows can halve.)
        return membudget.fit_within_budget(
            "pca", rows, lambda: self._fit_in_memory(rows), self._fit_in_memory,
            can_stream=self.getCovarianceBackend() != "pallas",
            why_cannot_stream="covarianceBackend='pallas' needs the "
                              "materialized single-device path",
            mesh=self.mesh, dtype=torch.float64, ledger_families=("pca",),
            device_id=self.getGpuId(),
        )

    def _fit_in_memory(self, rows: Any) -> "PCAModel":
        """Solver routing and fit of an admitted input: host or device
        data, or any streaming source (which the guard waves through)."""
        solver = self.getSolver()
        backend = self.getCovarianceBackend()
        streaming = is_streaming_source(rows)
        if solver == "randomized" and streaming and not is_reiterable_stream(rows):
            raise ValueError(
                "the randomized solver makes multiple passes; a one-shot "
                "generator cannot be re-read — pass an iterator factory "
                "(zero-arg callable) or a block reader (iter_blocks), or "
                "use solver='covariance' (one-pass)"
            )
        if solver == "randomized" and streaming and self.mesh is not None:
            # An explicit mesh is never dropped: the streaming sketch is
            # single-device.
            raise ValueError(
                "the streaming randomized solver is single-device; unset "
                "the mesh, materialize the input (mesh-sharded sketch), or "
                "use solver='covariance' (streamed mesh covariance)"
            )
        if solver == "randomized" and process_count() > 1:
            raise ValueError(
                "the randomized solver has no multi-process path; use "
                "solver='covariance' (per-executor streaming + moment merge)"
            )
        if solver == "randomized" and self.getPrecision() == "dd":
            raise ValueError(
                "the randomized solver has no dd path; use "
                "solver='covariance' with precision='dd'"
            )
        if backend == "pallas" and (
            (self.mesh is not None and not pallas_gang_tensor(self.mesh, rows)) or streaming
            or not self.getUseGemm()
            or solver == "randomized"
        ):
            raise ValueError(
                "covarianceBackend='pallas' applies to the single-device "
                "materialized GEMM covariance path (no mesh, no streaming "
                "source, useGemm=True, solver != 'randomized')"
            )
        # Resolve "auto" against the RAW input dtype, before densification.
        requested = self.getPrecision()
        input_dtype = infer_input_dtype(rows) if requested == "auto" else None
        explicit = requested if self.isSet(self.precision) else None
        requested = resolve_policy("pca", explicit, default=requested)
        resolved = RowMatrix.resolve(requested, mesh=self.mesh, input_dtype=input_dtype, backend=backend)
        if solver == "randomized":
            return self._fit_randomized(rows)
        # "auto" peeks at the width only (the first block of a fresh
        # iterator for a re-iterable stream). dd and pallas ask for the
        # covariance path; a one-shot generator keeps it at any width.
        if solver == "auto" and process_count() == 1 and resolved != "dd" and backend != "pallas":
            if streaming:
                # A stream over a mesh keeps the streamed mesh covariance.
                wide = (
                    self.mesh is None
                    and is_reiterable_stream(rows)
                    and peek_stream_width(rows) >= self._RANDOMIZED_AUTO_DIM
                )
            else:
                wide = num_features(rows) >= self._RANDOMIZED_AUTO_DIM
                if wide and self.mesh is not None:
                    # The sketch does not shard the model axis: a mesh whose
                    # model axis would pad the features keeps the covariance.
                    wide = num_features(rows) % model_axis_size(self.mesh) == 0
            if wide:
                return self._fit_randomized(rows)
        mat = RowMatrix(
            rows,
            mean_centering=self.getMeanCentering(),
            use_gemm=self.getUseGemm(),
            use_accel_svd=self.getUseCuSolverSVD(),
            device_id=self.getGpuId(),
            mesh=self.mesh,
            precision=resolved,
            backend=backend,
            eigen_solver=self.getEigenSolver(),
            eigen_iters=self.getEigenIters(),
        )
        pc, explained = mat.compute_principal_components_and_explained_variance(self.getK())
        return self._copyValues(PCAModel(self.uid, pc, explained))

    def _sketch_precision(self) -> str:
        """GEMM mode of the sketch: an explicit mode wins; ``auto`` (and
        ``dd``, refused before routing) run at ``highest``."""
        requested = self.getPrecision() if self.isSet(self.precision) else None
        mode = resolve_policy("pca", requested, default="highest")
        return "highest" if mode in ("auto", "dd") else mode

    def _fit_randomized(self, rows) -> "PCAModel":
        """The wide-feature path, no (d, d) covariance: a tensor is
        sketched where it lives and stays lazy; a host matrix goes to the
        ``gpuId`` device in float64; a re-iterable stream runs
        :func:`randomized_pca_streaming` in float64 on that device. With a
        mesh, the rows are sharded over it (host partitions in float64)
        and the sketch runs row-sharded; its features must divide the
        model axis."""
        k = self.getK()
        prec = self._sketch_precision()
        center = self.getMeanCentering()
        if is_streaming_source(rows):
            comps, ratio, _, _ = randomized_pca_streaming(
                lambda: iter_stream_blocks(rows),
                k,
                center=center,
                precision=prec,
                device=_device.resolve_device(self.getGpuId()),
            )
            return self._copyValues(PCAModel(self.uid, comps, ratio))
        if self.mesh is not None:
            x = self._sketch_rows_on_mesh(rows, k)
        elif is_device_array(rows):
            if rows.dim() != 2:
                raise ValueError(
                    f"device-array input must be 2-D (n, d), got shape {tuple(rows.shape)}"
                )
            _device.device_of(rows)  # on a CUDA tensor: TF32 off, as "highest" needs
            x = rows
        else:
            x = place_array(as_matrix(rows), device=_device.resolve_device(self.getGpuId()))
        n, d = (x.n, x.d) if self.mesh is not None else x.shape
        if not 1 <= k <= min(n, d):
            raise ValueError(f"k must be in [1, {min(n, d)}], got {k}")
        with TraceRange("randomized fit", TraceColor.PURPLE):
            comps, ratio, _ = randomized_pca(x, k, center=center, precision=prec)
        return self._copyValues(PCAModel(self.uid, comps, ratio))


    def _sketch_rows_on_mesh(self, rows, k: int):
        """The sketch's rows over the mesh: a tensor split where it lives
        (rows dividing the data axis, features the model axis), host
        partitions placed in float64. The sketch does not pad the model
        axis, so features must divide it."""
        mp = model_axis_size(self.mesh)
        if is_device_array(rows):
            if rows.dim() != 2:
                raise ValueError(
                    f"device-array input must be 2-D (n, d), got shape {tuple(rows.shape)}"
                )
            _device.device_of(rows)
            if rows.shape[1] % mp != 0:
                raise ValueError(
                    "the randomized solver does not shard the model "
                    f"axis (features {rows.shape[1]} would pad to a multiple of "
                    f"{mp}); use a (dp, 1) mesh or solver='covariance'"
                )
            return device_array_rows_on_mesh(rows, self.mesh, shard_features=mp > 1)
        x = shard_rows_from_partitions(as_partitions(rows), self.mesh, dtype=np.float64)
        if not 1 <= k <= min(x.n, x.d):
            raise ValueError(f"k must be in [1, {min(x.n, x.d)}], got {k}")
        if x.d_pad != x.d:
            raise ValueError(
                "the randomized solver does not shard the model axis "
                f"(features {x.d} pad to {x.d_pad}); use a (dp, 1) "
                "mesh or solver='covariance'"
            )
        return x


class PCAModel(_PCAParams, Model, LazyHostState):
    """Fitted PCA model: principal components (d, k) + explained variance (k,).

    Fitted state may be host numpy or tensors from a device fit; the
    public ``pc``/``explainedVariance`` host float64 views convert lazily.
    """

    def __init__(
        self,
        uid: Optional[str] = None,
        pc=None,
        explainedVariance=None,
    ):
        super().__init__(uid)
        self._pc_raw = pc
        self._ev_raw = explainedVariance
        self._pc_np: Optional[np.ndarray] = None
        self._ev_np: Optional[np.ndarray] = None
        self._pc_dev_cache: dict = {}

    _lazy_host_fields = {
        "_pc_raw": ("_pc_np", np.float64),
        "_ev_raw": ("_ev_np", np.float64),
    }
    _pickle_clear = ("_pc_dev_cache",)
    _pickle_clear_values = {"_pc_dev_cache": {}}

    @property
    def pc(self) -> Optional[np.ndarray]:
        """Principal components (d, k) as host float64."""
        return self._lazy_host_view("_pc_raw")

    @property
    def explainedVariance(self) -> Optional[np.ndarray]:
        """Explained-variance ratios (k,) as host float64."""
        return self._lazy_host_view("_ev_raw")

    def setInputCol(self, value: str) -> "PCAModel":
        self.set(self.inputCol, value)
        return self

    def setOutputCol(self, value: str) -> "PCAModel":
        self.set(self.outputCol, value)
        return self

    def copy(self, extra=None) -> "PCAModel":
        """Model.copy preserves fitted state (Spark's Model.copy contract)."""
        that = PCAModel(self.uid, self._pc_raw, self._ev_raw)
        return self._copyValues(that, extra)

    def transform(self, dataset: Any) -> Any:
        """Project rows onto the principal subspace: out = X · pc.

        A tensor is projected where it lives, through the bucketed program
        cache (on the card, a CUDA graph per row bucket), and the result
        stays there; host input goes to the device in float64 blocks of at
        most ``stream_block_rows()`` rows of each partition
        (``serve_blocks``: a partition of one block in one copy, a larger
        one pinned and double-buffered), as the other families' host
        routes go, and comes
        back as numpy (a DataFrame gains ``outputCol``; an array-like
        returns an (n, k) ndarray). A streaming source gives a generator of
        (rows, k) numpy blocks, one per non-empty block, at constant
        memory."""
        if self._pc_raw is None:
            raise RuntimeError("model has no principal components")
        rows = extract_column(dataset, self.getInputCol())
        static = {"precision": self._serving_precision()}
        if is_device_array(rows):
            device = _device.device_of(rows)
            with TraceRange("device transform", TraceColor.GREEN):
                return serve_rows(
                    _project_kernel, rows, (self._pc_device(rows.dtype, device),),
                    static=static, name="pca.transform",
                )
        device = _device.resolve_device(self.getGpuId())
        pc_dev = self._pc_device(torch.float64, device)
        if is_streaming_source(rows):
            # serve_stream densifies each raw block and skips empty ones.
            return serve_stream(
                _project_kernel, iter_stream_blocks(rows), (pc_dev,), static=static,
                name="pca.transform", device=device, dtype=torch.float64,
            )
        with TraceRange("batch transform", TraceColor.GREEN):
            outs = [serve_blocks(_project_kernel, p, (pc_dev,), static=static, name="pca.transform",
                                 device=device) for p in as_partitions(rows)]
            outs = [out for out in outs if out is not None]
        if not outs:
            projected = np.zeros((0, self.pc.shape[1]), dtype=self.pc.dtype)
        else:
            projected = np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
        if isinstance(dataset, DataFrame):
            return dataset.withColumn(self.getOutputCol(), list(projected))
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            return projected
        if isinstance(dataset, pd.DataFrame):
            out_df = dataset.copy()
            out_df[self.getOutputCol()] = list(projected)
            return out_df
        return projected

    def _pc_device(self, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """Components at ``dtype`` on ``device``, cached: repeated
        transforms do not copy them to the card again, and their graphs
        find the same weights. The cache is registered with
        ``core/serving``, which drops it when the model retires."""
        key = (str(dtype), str(device))
        if key not in self._pc_dev_cache:
            raw = self._pc_raw
            if not isinstance(raw, torch.Tensor):
                raw = torch.tensor(np.asarray(raw))  # a copy: numpy views may be read-only
            self._pc_dev_cache[key] = raw.to(device=device, dtype=dtype)
            note_device_cache(self)
        return self._pc_dev_cache[key]

    def _serving_precision(self) -> str:
        """An explicit estimator ``setPrecision`` survives into the model
        and wins; ``auto``/``dd`` serve at ``highest``."""
        requested = self.getPrecision() if self.isSet(self.precision) else None
        if requested in ("auto", "dd"):
            requested = "highest"
        return resolve_policy("serving", requested)

    def _serving_dtype(self) -> torch.dtype:
        """The components' own dtype (float64 for host components): the
        kernel casts them to each batch's dtype, so one copy serves host
        input (float64) and tensors of any dtype bit for bit as
        ``transform`` does."""
        raw = self._pc_raw
        return raw.dtype if isinstance(raw, torch.Tensor) else torch.float64

    def serving_signature(self) -> ServingSignature:
        """The serving contract: the projection kernel, the components at
        their own dtype on the platform's device, and the (n, k)
        projection spec."""
        if self._pc_raw is None:
            raise RuntimeError("model has no principal components")
        pc = self._pc_device(self._serving_dtype(), _device.resolve_device())
        d, k = int(pc.shape[0]), int(pc.shape[1])
        return ServingSignature(
            kernel=_project_kernel,
            weights=(pc,),
            static={"precision": self._serving_precision()},
            name="pca.transform",
            n_features=d,
            output_spec=lambda n, dtype: spec((n, k), dtype),
        )

    def _save_impl(self, path: str) -> None:
        save_metadata(self, path, class_name="com.nvidia.spark.ml.feature.PCAModel")
        save_data(
            path,
            {
                "pc": ("matrix", self.pc),
                "explainedVariance": ("vector", self.explainedVariance),
            },
        )

    @classmethod
    def _load_impl(cls, path: str) -> "PCAModel":
        metadata = load_metadata(path, expected_class="PCAModel")
        data = load_data(path)
        model = cls(metadata["uid"], data["pc"], data["explainedVariance"])
        get_and_set_params(model, metadata)
        return model
