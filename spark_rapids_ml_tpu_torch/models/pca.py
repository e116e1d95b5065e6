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
``FitMemoryError`` instead. A mesh raises ``NotImplementedError`` naming
its slice.
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
from spark_rapids_ml_tpu_torch.core.serving import serve_rows, serve_stream
from spark_rapids_ml_tpu_torch.linalg.row_matrix import MESH_SLICE, RowMatrix
from spark_rapids_ml_tpu_torch.ops.linalg import project_rows, validate_precision
from spark_rapids_ml_tpu_torch.ops.precision import resolve_policy
from spark_rapids_ml_tpu_torch.ops.randomized import randomized_pca, randomized_pca_streaming
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

#: Port spellings of ``covarianceBackend`` -> the reference's spelling.
BACKEND_ALIASES = {"xla": "xla", "torch": "xla", "pallas": "pallas", "cuda": "pallas"}


def _project_kernel(x, pc, *, precision: str = "highest"):
    """Serving kernel: rows onto the principal subspace (components
    follow the batch dtype)."""
    return project_rows(x, pc.to(x.dtype), precision=precision)


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
        if self.mesh is not None:
            raise NotImplementedError(MESH_SLICE)
        # Over budget, the input re-enters as a block reader: the streaming
        # route an explicit reader takes, bit for bit. (The reference
        # re-enters _fit, whose own recovery turns a streaming OOM into
        # FitMemoryError before the block rows can halve.)
        return membudget.fit_within_budget(
            "pca", rows, lambda: self._fit_in_memory(rows), self._fit_in_memory,
            can_stream=self.getCovarianceBackend() != "pallas",
            why_cannot_stream="covarianceBackend='pallas' needs the "
                              "materialized single-device path",
            dtype=torch.float64, ledger_families=("pca",), device_id=self.getGpuId(),
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
        if solver == "randomized" and self.getPrecision() == "dd":
            raise ValueError(
                "the randomized solver has no dd path; use "
                "solver='covariance' with precision='dd'"
            )
        if backend == "pallas" and (streaming or not self.getUseGemm() or solver == "randomized"):
            raise ValueError(
                "covarianceBackend='pallas' applies to the single-device "
                "materialized GEMM covariance path (no streaming source, "
                "useGemm=True, solver != 'randomized')"
            )
        # Resolve "auto" against the RAW input dtype, before densification.
        requested = self.getPrecision()
        input_dtype = infer_input_dtype(rows) if requested == "auto" else None
        explicit = requested if self.isSet(self.precision) else None
        requested = resolve_policy("pca", explicit, default=requested)
        resolved = RowMatrix.resolve(requested, input_dtype=input_dtype, backend=backend)
        if solver == "randomized":
            return self._fit_randomized(rows)
        # "auto" peeks at the width only (the first block of a fresh
        # iterator for a re-iterable stream). dd and pallas ask for the
        # covariance path; a one-shot generator keeps it at any width.
        if solver == "auto" and resolved != "dd" and backend != "pallas":
            if streaming:
                wide = (
                    is_reiterable_stream(rows)
                    and peek_stream_width(rows) >= self._RANDOMIZED_AUTO_DIM
                )
            else:
                wide = num_features(rows) >= self._RANDOMIZED_AUTO_DIM
            if wide:
                return self._fit_randomized(rows)
        mat = RowMatrix(
            rows,
            mean_centering=self.getMeanCentering(),
            use_gemm=self.getUseGemm(),
            use_accel_svd=self.getUseCuSolverSVD(),
            device_id=self.getGpuId(),
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
        :func:`randomized_pca_streaming` in float64 on that device."""
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
        if is_device_array(rows):
            if rows.dim() != 2:
                raise ValueError(
                    f"device-array input must be 2-D (n, d), got shape {tuple(rows.shape)}"
                )
            _device.device_of(rows)  # on a CUDA tensor: TF32 off, as "highest" needs
            x = rows
        else:
            x = torch.from_numpy(as_matrix(rows)).to(_device.resolve_device(self.getGpuId()))
        n, d = x.shape
        if not 1 <= k <= min(n, d):
            raise ValueError(f"k must be in [1, {min(n, d)}], got {k}")
        with TraceRange("randomized fit", TraceColor.PURPLE):
            comps, ratio, _ = randomized_pca(x, k, center=center, precision=prec)
        return self._copyValues(PCAModel(self.uid, comps, ratio))


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

        A tensor is projected where it lives and the result stays there;
        host input goes to the device partition by partition and comes
        back as numpy (a DataFrame gains ``outputCol``; an array-like
        returns an (n, k) ndarray). A streaming source gives a generator
        of (rows, k) numpy blocks, one per non-empty block, at constant
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
        parts = as_partitions(rows)
        with TraceRange("batch transform", TraceColor.GREEN):
            outs = list(
                serve_stream(
                    _project_kernel, parts, (pc_dev,),
                    static=static, name="pca.transform", device=device, dtype=torch.float64,
                )
            )
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
        transforms do not copy them to the card again."""
        key = (str(dtype), str(device))
        if key not in self._pc_dev_cache:
            raw = self._pc_raw
            if not isinstance(raw, torch.Tensor):
                raw = torch.tensor(np.asarray(raw))  # a copy: numpy views may be read-only
            self._pc_dev_cache[key] = raw.to(device=device, dtype=dtype)
        return self._pc_dev_cache[key]

    def _serving_precision(self) -> str:
        """An explicit estimator ``setPrecision`` survives into the model
        and wins; ``auto``/``dd`` serve at ``highest``."""
        requested = self.getPrecision() if self.isSet(self.precision) else None
        if requested in ("auto", "dd"):
            requested = "highest"
        return resolve_policy("serving", requested)

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
