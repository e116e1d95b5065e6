"""Row matrix with accelerated covariance/PCA — port of the reference's
``linalg/row_matrix.py`` (the ``RapidsRowMatrix`` equivalent).

Four routes:
  - a ``torch.Tensor`` computes where it lives, in its own dtype. With the
    ``"xla"`` backend the whole fit is one plain function
    (:func:`_pca_fit_device`); with ``"pallas"`` the covariance runs on
    kernel K1 and the eigensolve follows on the same device.
  - host partitions (numpy blocks) go to the device one at a time in
    float64 — Hopper computes float64 natively, as the original
    ``cublasDgemm`` did — and their Grams are summed there (plain torch or
    K1).
  - ``use_gemm=False``, the packed spr path (host partitions or a stream):
    the native float64 Kahan accumulator (``native.SprAccumulator``) when
    the host library loads, counter ``pca.packed.native``; otherwise the
    packed-upper Gram on the fit's device (:func:`centered_gram_packed`;
    a stream takes the shifted scan below), counter ``pca.packed.device``.
    The covariance is float64 either way and goes to the fit's device for
    the eigensolve: the reference's x64 branch, where a host float64
    covariance is solved on the device in float64 (cuSOLVER here).
  - a streaming source (block iterator, block reader, iterator factory) is
    never materialized: one pass of the shifted accumulation
    (``ops/covariance.py::streaming_mean_and_covariance``) in float64,
    one block on the device at a time, plain torch only. Its shape is
    known once the pass has run. ``precision="dd"`` is the same float64
    scan.

With a mesh (``parallel/mesh.py``) the covariance is a per-shard sum
over the data axis (``parallel/distributed_cov.py``): host partitions are
placed shard by shard (``shard_rows_from_partitions``; in a gang, this
process's rows through ``shard_rows_process_local``), a tensor is split
where it lives (its rows must divide the data axis, as in the
reference; in a gang a member's tensor is its local rows and takes the
process-local path, as ``core/ingest.py`` reads it), and a stream is
split block by block
(``streaming_mean_and_covariance_mesh``; in a gang each process streams
its own blocks and the moments merge,
``streaming_covariance_process_local``). The eigensolve follows on the
mesh's first device. As in the reference, ``backend="pallas"`` has no
mesh path, and ``precision="dd"`` with a mesh needs the multi-process
streaming deployment.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch import native
from spark_rapids_ml_tpu_torch.core.data import (
    _block_to_dense,
    as_partitions,
    is_device_array,
    is_streaming_source,
    iter_stream_blocks,
)
from spark_rapids_ml_tpu_torch.core.ingest import place_array
from spark_rapids_ml_tpu_torch.ops.covariance import (
    centered_gram,
    centered_gram_packed,
    streaming_mean_and_covariance,
    welford_add_mean,
    welford_init,
)
from spark_rapids_ml_tpu_torch.ops.eigh import (
    auto_max_iters,
    eigh_auto,
    eigh_descending,
    eigh_descending_host,
    eigh_topk,
    sign_flip,
)
from spark_rapids_ml_tpu_torch.observability.costs import ledgered_call
from spark_rapids_ml_tpu_torch.ops.kernels.covariance import centered_gram_cuda
from spark_rapids_ml_tpu_torch.ops.kernels.covariance import cost as gram_cost
from spark_rapids_ml_tpu_torch.ops.linalg import resolve_precision, triu_to_full
from spark_rapids_ml_tpu_torch.parallel.collectives import process_count
from spark_rapids_ml_tpu_torch.parallel.distributed_cov import distributed_mean_and_covariance
from spark_rapids_ml_tpu_torch.parallel.mesh import device_array_rows_on_mesh, shard_rows_from_partitions
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

#: The packed layout's wire-format cap (the reference's
#: ``RapidsRowMatrix.scala:66-68``): n(n+1)/2 entries of a 32-bit index.
PACKED_MAX_COLS = 65535


def _ratio(w: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    # Zero-variance input (constant rows) yields zeros, not NaN.
    return torch.where(total > 0, w / torch.where(total > 0, total, torch.ones_like(total)), w)


def _pca_fit_device(x, k, center, precision, eigen_solver, eigen_iters, mesh=None):
    """The whole PCA fit on a tensor where it lives: column means, centered
    covariance GEMM, eigensolve, explained variance. Returns tensors on
    the input's device; nothing is read back except the eigensolver's
    scalar decisions. With a mesh the tensor is split over it and the
    covariance is the per-shard sum."""
    n, d = x.shape
    if mesh is not None:
        _, cov = distributed_mean_and_covariance(
            device_array_rows_on_mesh(x, mesh), None, mesh, precision=precision, center=center
        )
        return _pca_from_cov(cov[:d, :d], k, eigen_solver, eigen_iters)
    mean = torch.mean(x, dim=0) if center else torch.zeros((d,), dtype=x.dtype, device=x.device)
    cov = ledgered_call(centered_gram, (x, mean), static={"precision": precision}, name="covariance.gram",
                        cost=lambda: gram_cost(n, d, x.dtype)) / (n - 1)
    return _pca_from_cov(cov, k, eigen_solver, eigen_iters)


def _pca_from_cov(cov, k, eigen_solver, eigen_iters):
    """Eigensolve and explained-variance ratios of a device covariance."""
    d = cov.shape[0]
    if eigen_solver == "auto" and k < d:
        w, v, _ = eigh_auto(cov, k, max_iters=auto_max_iters(eigen_iters))
        return v, _ratio(torch.clamp(w, min=0), torch.trace(cov))
    if eigen_solver == "topk" and k < d:
        w, v = eigh_topk(cov, k, iters=eigen_iters)
        return v, _ratio(torch.clamp(w, min=0), torch.trace(cov))
    w, v = eigh_descending(cov)
    w = torch.clamp(w, min=0)
    return v[:, :k], _ratio(w, torch.sum(w))[:k]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class RowMatrix:
    """A row-partitioned matrix with accelerated covariance/PCA.

    Parameters mirror the reference: ``mean_centering``, ``use_gemm``,
    ``use_accel_svd`` (device eigensolver vs host numpy SVD), ``device_id``
    (``-1`` = the first card), ``precision``, ``backend`` (``"xla"``: plain
    torch; ``"pallas"``: kernel K1), ``eigen_solver`` and ``eigen_iters``.
    """

    def __init__(
        self,
        rows,
        mean_centering: bool = True,
        use_gemm: bool = True,
        use_accel_svd: bool = True,
        device_id: int = -1,
        mesh=None,
        precision: str = "highest",
        dtype=None,
        input_dtype=None,
        backend: str = "xla",
        eigen_solver: str = "full",
        eigen_iters: int = 8,
    ):
        self._device_x: Optional[torch.Tensor] = None
        self.partitions: Optional[List[np.ndarray]] = None
        self._stream = None
        self._num_rows: Optional[int] = None
        self._num_cols: Optional[int] = None
        if is_device_array(rows):
            if rows.dim() != 2:
                raise ValueError(
                    f"device-array input must be 2-D (n, d), got shape {tuple(rows.shape)}"
                )
            self._device_x = rows
            self._num_rows = int(rows.shape[0])
            self._num_cols = int(rows.shape[1])
        elif is_streaming_source(rows):
            self._stream = rows
        else:
            self.partitions = as_partitions(rows)
        self.mean_centering = mean_centering
        self.use_accel_svd = use_accel_svd
        self.device_id = device_id
        self.mesh = mesh
        self.precision = self.resolve(precision, mesh=mesh, input_dtype=input_dtype, backend=backend)
        if self.precision == "dd" and self._device_x is not None:
            raise ValueError(
                "precision='dd' is the host-partition fp64 route; a device "
                "tensor is already in its compute dtype — pass host "
                "partitions (or a float64 tensor) for fp64 semantics"
            )
        if not use_gemm and self._device_x is not None:
            raise ValueError(
                "useGemm=False (the packed spr-layout path) consumes host "
                "partitions; device-resident input runs the fused GEMM "
                "covariance (useGemm=True)"
            )
        if self.precision == "dd" and mesh is not None:
            # dd composes with a mesh only as the per-executor streaming
            # merge (each process scans its own blocks in float64); the
            # single-process mesh routes refuse it, as in the reference.
            if not (self.partitions is None and process_count() > 1):
                raise ValueError(
                    "precision='dd' with a mesh requires the multi-process "
                    "streaming deployment (per-executor dd scans + moment "
                    "merge); single-process mesh fits use "
                    "precision='highest'"
                )
        if backend == "pallas" and mesh is not None:
            raise ValueError("backend='pallas' has no mesh path; use 'xla'")
        if backend == "pallas" and self._stream is not None:
            raise ValueError("backend='pallas' has no streaming path; use 'xla'")
        if backend == "pallas" and not use_gemm:
            raise ValueError("backend='pallas' applies to the GEMM path (useGemm=True)")
        self.use_gemm = use_gemm
        self.backend = backend
        if eigen_solver not in ("auto", "full", "topk"):
            raise ValueError(
                f"eigen_solver must be 'auto', 'full' or 'topk', got {eigen_solver!r}"
            )
        self.eigen_solver = eigen_solver
        if eigen_iters < 1:
            raise ValueError(f"eigen_iters must be >= 1, got {eigen_iters}")
        self.eigen_iters = int(eigen_iters)
        self._dtype = dtype

    @staticmethod
    def resolve(precision: str, mesh=None, input_dtype=None, backend: str = "xla") -> str:
        """The one home of precision-request resolution (PCA calls it too).
        ``"auto"`` resolves to ``"highest"`` (with a mesh always, deferring
        to the mesh covariance); under ``backend="pallas"`` an explicit
        ``"dd"`` is an error, as in the reference."""
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be 'xla' or 'pallas', got {backend!r}")
        if precision == "auto" and mesh is not None:
            return "highest"
        resolved = resolve_precision(precision, input_dtype=input_dtype)
        if backend == "pallas" and resolved == "dd":
            raise ValueError("precision='dd' has its own kernels; use backend='xla'")
        return resolved

    # --- shape ---

    _STREAM_SHAPE = "streaming input: shape is unknown until a fit pass runs"

    @property
    def num_rows(self) -> int:
        if self._num_rows is None:
            if self.partitions is None:
                raise RuntimeError(self._STREAM_SHAPE)
            self._num_rows = sum(p.shape[0] for p in self.partitions)
        return self._num_rows

    @property
    def num_cols(self) -> int:
        # A streaming source's width is what its pass found.
        if self._num_cols is not None:
            return self._num_cols
        if self.partitions is None:
            raise RuntimeError(self._STREAM_SHAPE)
        return self.partitions[0].shape[1]

    @property
    def dtype(self) -> torch.dtype:
        if self._dtype is not None:
            return self._dtype
        if self._device_x is not None:
            return self._device_x.dtype  # a tensor computes in its own dtype
        return torch.float64

    def _device(self) -> torch.device:
        if self._device_x is not None:
            return _device.device_of(self._device_x)
        if self.mesh is not None:
            return self.mesh.first_device
        return _device.resolve_device(self.device_id)

    @property
    def _gang(self) -> bool:
        return self.mesh is not None and process_count() > 1

    # --- column stats (Statistics.colStats analogue) ---

    def column_means(self) -> torch.Tensor:
        if self._stream is not None:
            raise RuntimeError(
                "streaming input: column means are computed inside the "
                "one-pass covariance; use compute_covariance()"
            )
        with TraceRange("mean center", TraceColor.ORANGE):
            if self._device_x is not None:
                return torch.mean(self._device_x, dim=0)
            device = self._device()
            count, mean, _ = welford_init(self.num_cols, dtype=self.dtype, device=device)
            for part in self.partitions:
                blk = place_array(part, dtype=self.dtype, device=device)
                count, mean = welford_add_mean((count, mean), blk)
                del blk  # the next partition is placed with this one freed
            return mean

    # --- covariance ---

    def _mean(self) -> torch.Tensor:
        if self.mean_centering:
            return self.column_means()
        return torch.zeros(self.num_cols, dtype=self.dtype, device=self._device())

    def _gram(self, blk: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
        """One block's centered Gram: K1 on the ``pallas`` backend, else
        the plain GEMM; a cost-ledger program ``covariance.gram`` either
        way, counted as K1's work (``ops/kernels/covariance.cost``)."""
        n, d = int(blk.shape[0]), int(blk.shape[1])
        if self.backend == "pallas":
            return ledgered_call(centered_gram_cuda, (blk.contiguous(), mean.contiguous()), static={},
                                 name="covariance.gram", cost=lambda: gram_cost(n, d, blk.dtype))
        return ledgered_call(centered_gram, (blk, mean), static={"precision": self.precision},
                             name="covariance.gram", cost=lambda: gram_cost(n, d, blk.dtype))

    def compute_covariance(self) -> torch.Tensor:
        if self._stream is not None:
            return self._covariance_streaming()
        if not self._gang:
            # A gang checks the GLOBAL count after the counts handshake: a
            # local check would kill a low-row executor while its peers
            # wait for it in the collective.
            n = self.num_rows
            if n < 2:
                raise ValueError(f"need at least 2 rows, got {n}")
        if self._device_x is not None:
            return self._covariance_device()
        with TraceRange("compute cov", TraceColor.RED):
            if self.mesh is not None:
                return self._covariance_mesh()[1]
            if not self.use_gemm:
                return self._covariance_packed()
            return self._covariance_gemm(self._mean())

    def _covariance_device(self) -> torch.Tensor:
        """Covariance of a device tensor where it lives."""
        self._device()  # on a CUDA tensor: TF32 off, as "highest" needs
        with TraceRange("compute cov", TraceColor.RED):
            if self.mesh is not None:
                d = self.num_cols
                _, cov = distributed_mean_and_covariance(
                    device_array_rows_on_mesh(self._device_x, self.mesh), None, self.mesh,
                    precision=self.precision, center=self.mean_centering,
                )
                return cov[:d, :d]
            return self._gram(self._device_x, self._mean()) / (self.num_rows - 1)

    def _covariance_mesh(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host partitions over the mesh: placed shard by shard (never
        concatenated on the host) in this matrix's dtype, or in a gang this
        process's rows assembled with its peers'; then the per-shard
        covariance sum. Feature padding is sliced off."""
        np_dtype = np.dtype(torch.empty((), dtype=self.dtype).numpy().dtype)
        if self._gang:
            from spark_rapids_ml_tpu_torch.parallel.distributed import shard_rows_process_local

            xs = shard_rows_process_local(self.partitions, self.mesh, dtype=np_dtype)
            # Shape facts are global after the handshake; the <2 check runs
            # here, alike on every process.
            self._num_rows, self._num_cols = xs.n, xs.d
            if xs.n < 2:
                raise ValueError(f"need at least 2 rows, got {xs.n}")
        else:
            xs = shard_rows_from_partitions(self.partitions, self.mesh, dtype=np_dtype)
        d = xs.d
        mean, cov = distributed_mean_and_covariance(
            xs, None, self.mesh, precision=self.precision, center=self.mean_centering
        )
        return mean[:d], cov[:d, :d]

    def _covariance_streaming(self) -> torch.Tensor:
        """Covariance of a streaming source: one pass, one block on the
        device at a time (shifted accumulation, float64), or through the
        native accumulator on the packed route. Records the shape the pass
        found."""
        device = self._device()
        if self.mesh is not None:
            return self._covariance_streaming_mesh(device)
        if not self.use_gemm:
            if native.available():
                bump_counter("pca.packed.native")
                with TraceRange("compute cov (stream, native spr)", TraceColor.RED):
                    cov, n = self._native_spr_covariance(
                        (_block_to_dense(blk) for blk in iter_stream_blocks(self._stream)),
                        self.mean_centering,
                    )
                self._num_rows = n
                self._num_cols = int(cov.shape[0])
                return torch.from_numpy(cov).to(device)
            # No native library: the device's streaming scan below.
            bump_counter("pca.packed.device")
        with TraceRange("compute cov (stream)", TraceColor.RED):
            _, cov, n = streaming_mean_and_covariance(
                iter_stream_blocks(self._stream),
                center=self.mean_centering,
                dtype=self.dtype,
                precision=self.precision,
                device=device,
            )
        self._num_rows = int(n)
        self._num_cols = int(cov.shape[0])
        return torch.from_numpy(cov).to(device=device, dtype=self.dtype)

    def _covariance_streaming_mesh(self, device: torch.device) -> torch.Tensor:
        """A stream over the mesh: in a gang each process streams its own
        blocks and the moments merge (psum, or the exact float64 allgather
        for ``dd``); in one process each block is split over the data
        axis."""
        blocks = iter_stream_blocks(self._stream)
        if self._gang:
            from spark_rapids_ml_tpu_torch.parallel.distributed import streaming_covariance_process_local

            with TraceRange("compute cov (stream, multiproc)", TraceColor.RED):
                _, cov, n = streaming_covariance_process_local(
                    blocks, center=self.mean_centering, dtype=self.dtype,
                    precision=self.precision, mesh=self.mesh,
                )
        else:
            from spark_rapids_ml_tpu_torch.ops.covariance import streaming_mean_and_covariance_mesh

            with TraceRange("compute cov (stream, mesh)", TraceColor.RED):
                _, cov, n = streaming_mean_and_covariance_mesh(
                    blocks, self.mesh, center=self.mean_centering, dtype=self.dtype,
                    precision=self.precision,
                )
        self._num_rows = int(n)
        self._num_cols = int(cov.shape[0])
        return torch.from_numpy(cov).to(device=device, dtype=self.dtype)

    def _covariance_gemm(self, mean: torch.Tensor) -> torch.Tensor:
        """Per-partition centered Gram, summed on the device."""
        device = self._device()
        acc = None
        for part in self.partitions:
            with TraceRange("gemm", TraceColor.GREEN):
                blk = place_array(part, dtype=self.dtype, device=device)
                gram = self._gram(blk, mean)
            acc = gram if acc is None else acc + gram
        return acc / (self.num_rows - 1)

    @staticmethod
    def _native_spr_covariance(blocks, center: bool) -> Tuple[np.ndarray, int]:
        """Dense host blocks through the native float64 Kahan accumulator:
        ``(covariance float64, rows)``. The one home of the
        cap/accumulate/finalize sequence of the packed route and its
        streaming twin."""
        acc = None
        for b in blocks:
            if b.shape[0] == 0:
                continue
            if acc is None:
                if b.shape[1] > PACKED_MAX_COLS:
                    raise ValueError(
                        f"packed path caps features at {PACKED_MAX_COLS}, got {b.shape[1]}"
                    )
                acc = native.SprAccumulator(b.shape[1])
            acc.add_block(b)
        if acc is None:
            raise ValueError("need at least 2 rows to compute a covariance, got 0")
        cov, _ = acc.finalize(center=center)
        return cov, int(acc.n_rows)

    def _covariance_packed(self) -> torch.Tensor:
        """The packed-upper (spr/treeAggregate) covariance of host
        partitions, float64 on the fit's device. Native when the library
        loads: true float64 with Kahan compensation and its own column
        means in the same pass. Otherwise the packed Gram per partition on
        the device, or for ``dd`` the float64 GEMM route (the reference's
        ``dd`` kernels)."""
        n_cols = self.num_cols
        if n_cols > PACKED_MAX_COLS:
            raise ValueError(f"packed path caps features at {PACKED_MAX_COLS}, got {n_cols}")
        if native.available():
            bump_counter("pca.packed.native")
            cov, _ = self._native_spr_covariance(iter(self.partitions), self.mean_centering)
            return torch.from_numpy(cov).to(self._device())
        bump_counter("pca.packed.device")
        mean = self._mean()
        if self.precision == "dd":
            return self._covariance_gemm(mean)
        device = self._device()
        acc = None
        for part in self.partitions:
            blk = place_array(part, dtype=self.dtype, device=device)
            packed = centered_gram_packed(blk, mean)
            acc = packed if acc is None else acc + packed
        return triu_to_full(acc) / (self.num_rows - 1)

    # --- PCA (computePrincipalComponentsAndExplainedVariance) ---

    def compute_principal_components_and_explained_variance(
        self, k: int
    ) -> Tuple[object, object]:
        if self._device_x is not None and self.use_accel_svd and self.backend != "pallas":
            n, n_cols = self.num_rows, self.num_cols
            if n < 2:
                raise ValueError(f"need at least 2 rows, got {n}")
            if not 1 <= k <= n_cols:
                raise ValueError(f"k must be in [1, {n_cols}], got {k}")
            with TraceRange("fused device fit", TraceColor.RED):
                self._device()  # on a CUDA tensor: TF32 off, as "highest" needs
                return _pca_fit_device(
                    self._device_x,
                    k,
                    center=self.mean_centering,
                    precision=self.precision,
                    eigen_solver=self.eigen_solver,
                    eigen_iters=self.eigen_iters,
                    mesh=self.mesh,
                )  # device tensors: the model reads them back lazily
        # A stream learns its width during the pass, and a gang member its
        # global width from the handshake: validate k after those.
        shape_known = self._stream is None and not self._gang
        if shape_known and not 1 <= k <= self.num_cols:
            raise ValueError(f"k must be in [1, {self.num_cols}], got {k}")
        cov = self.compute_covariance()
        n_cols = self.num_cols
        if not 1 <= k <= n_cols:
            raise ValueError(f"k must be in [1, {n_cols}], got {k}")
        if self.precision == "dd":
            # The reference's float64 route solves on the host in full (the
            # route exists for accuracy, not speed): LAPACK in float64 for
            # every eigenSolver, topk keeping its trace-normalized ratios.
            with TraceRange("host fp64 SVD", TraceColor.BLUE):
                w, u = eigh_descending_host(cov)
            if self.eigen_solver == "topk" and k < n_cols:
                return u[:, :k], self._trace_ratio(w[:k], cov)
        elif self.eigen_solver == "topk" and k < n_cols:
            with TraceRange("topk eigh", TraceColor.BLUE):
                w_k, u_k = eigh_topk(cov, k, iters=self.eigen_iters)
                return u_k, self._trace_ratio(w_k, cov)
        elif self.eigen_solver == "auto" and k < n_cols and self.use_accel_svd:
            with TraceRange("auto eigh", TraceColor.BLUE):
                w_k, u_k, _ = eigh_auto(cov, k, max_iters=auto_max_iters(self.eigen_iters))
                return u_k, self._trace_ratio(w_k, cov)
        elif self.use_accel_svd:
            with TraceRange("accel SVD", TraceColor.BLUE):
                w, u = eigh_descending(cov)
                u, w = _host(u), _host(w)
        else:
            with TraceRange("cpu SVD", TraceColor.BLUE):
                # Host LAPACK SVD — the breeze brzSvd analogue. For the
                # symmetric PSD covariance the singular values ARE eigenvalues.
                u, w, _ = np.linalg.svd(_host(cov).astype(np.float64))
                u = _host(sign_flip(torch.from_numpy(u)))
        # Explained variance ratio is eigenvalue-proportional: λ_i / Σλ.
        w = np.clip(w, 0, None)
        total = w.sum()
        explained = w / total if total > 0 else w
        if k < n_cols:
            return u[:, :k], explained[:k]
        return u, explained

    @staticmethod
    def _trace_ratio(w_k: torch.Tensor, cov: torch.Tensor) -> np.ndarray:
        """Exact explained-variance ratios of the top-k: w / trace(cov)."""
        w_k = np.clip(_host(w_k), 0, None)
        total = float(torch.trace(cov))
        return w_k / total if total > 0 else w_k
