"""Randomized PCA for wide features — port of the reference's
``ops/randomized.py``.

The covariance route costs O(n·d²) operations and a (d, d) matrix; at
d ~ 10^5 the Gram alone is 40 GB. Randomized subspace iteration
(Halko–Martinsson–Tropp) needs neither: two tall-skinny GEMM passes over
x per power iteration with an (n, l) sketch, l = k + oversample << d,
then a small SVD.

  - Orthonormalization is Cholesky-QR2 (:func:`_chol_qr2`): two (l, l)
    Grams and two triangular solves, with a tiny ridge that keeps the
    Cholesky defined when the sketch is near rank-deficient.
  - Mean centering is folded into the GEMMs (``x @ v − mean·v`` and
    ``xᵀu − mean ⊗ Σu``); the centered matrix is never materialized.
  - The total variance (the denominator of the explained-variance ratios)
    is the exact two-pass centered trace, so the ratios are those of the
    covariance path, not of the top-l approximation. With
    ``center=False`` it is the raw trace.
  - The random draw Ω (d, l) is an argument, not a JAX key: JAX's
    threefry bits cannot be reproduced in torch. By default
    :func:`draw_omega` draws it in float64 from a CPU ``torch.Generator``
    seeded 0 and rounds it to the compute dtype, so a CPU fit and a card
    fit, and a float32 fit and a float64 one, see the same Ω: the model
    never depends on placement (the reference fixes ``key(0)`` for the same
    reason). Tests pass JAX's own draw.

:func:`randomized_pca_streaming` is the same algorithm over a re-iterable
block source at O(d·l + block) memory: pass 0 accumulates the moments in
host float64 around a shift (the first block's mean), then
``power_iters`` passes of the implicit Gram ``Xcᵀ(Xc·Z)`` and one
Rayleigh–Ritz pass. The reference pads each block to a power-of-two row
bucket with mean rows so that XLA reuses a handful of compiled programs;
eager PyTorch compiles nothing per shape, so the port feeds the blocks
as they come. A mean row centers to exactly zero, so the sums are the
same up to their order.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import dense_block
from spark_rapids_ml_tpu_torch.core.serving import prefetch_blocks, upload_block
from spark_rapids_ml_tpu_torch.ops.eigh import _eigh, sign_flip
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.collectives import psum_data
from spark_rapids_ml_tpu_torch.parallel.mesh import ShardedRows
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

#: Rows per chunk of the exact centered trace: the (chunk, d) centered
#: temporary stays near 64 Mi elements.
_TRACE_CHUNK_ELEMENTS = 1 << 26


def draw_omega(d: int, l: int, dtype: torch.dtype) -> torch.Tensor:
    """The default sketch draw: (d, l) float64 standard normals from a CPU
    ``torch.Generator`` seeded 0, rounded to ``dtype``, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn((d, l), generator=gen, dtype=torch.float64).to(dtype)


def _omega(omega: Any, d: int, l: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if omega is None:
        omega = draw_omega(d, l, dtype)
    if not isinstance(omega, torch.Tensor):
        omega = torch.from_numpy(np.array(omega))
    if tuple(omega.shape) != (d, l):
        raise ValueError(f"the sketch draw must be (d, l) = ({d}, {l}), got {tuple(omega.shape)}")
    return omega.to(device=device, dtype=dtype)


def _chol_qr2(y: Any, dot: Callable) -> Any:
    """Orthonormalize the columns of (n, l) ``y`` by two Cholesky-QR passes
    (``dot`` is the precision-resolved matmul). A Gram that is not positive
    definite even with the ridge (a zero or NaN sketch) gives NaN, as
    ``jnp.linalg.cholesky`` does. ``y`` may be a list of row shards: each
    pass's (l, l) Gram is then their sum over the data axis
    (``psum_data``), and each shard is solved where it lives."""
    shards = y if isinstance(y, list) else [y]
    eps = torch.finfo(shards[0].dtype).eps
    eye = torch.eye(shards[0].shape[1], dtype=shards[0].dtype, device=shards[0].device)

    def once(ys):
        g = psum_data([dot(t.T, t) for t in ys], eye.device)
        # Tiny ridge: keeps the factor defined when the sketch is
        # near rank-deficient (data with fewer than l directions).
        g = g + (eps * torch.trace(g)) * eye
        lo, info = torch.linalg.cholesky_ex(g)
        lo = torch.where(info == 0, lo, float("nan"))
        # y · R⁻¹ with R = Lᵀ upper: solve X·R = y.
        return [torch.linalg.solve_triangular(lo.T.to(t.device), t, upper=True, left=False) for t in ys]

    out = once(once(shards))
    return out if isinstance(y, list) else out[0]


def _centered_trace(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Σ‖x − mean‖² in row chunks (two-pass, no (n, d) temporary)."""
    step = max(1, _TRACE_CHUNK_ELEMENTS // max(x.shape[1], 1))
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(0, x.shape[0], step):
        total = total + torch.sum((x[i : i + step] - mean) ** 2)
    return total


def randomized_pca(
    x: Any,
    k: int,
    omega: Any = None,
    oversample: int = 10,
    power_iters: int = 2,
    precision: str = "highest",
    center: bool = True,
):
    """Top-k principal components of ``x`` (n, d) without forming the
    covariance, where ``x`` lives and in its dtype. ``omega`` is the (d, l)
    draw, l = min(k + oversample, d, n) (default :func:`draw_omega`).
    ``center=False`` is second-moment PCA. Returns tensors
    ``(components (d, k), explained-variance ratio (k,), mean (d,))``.

    ``x`` may be a :class:`~spark_rapids_ml_tpu_torch.parallel.mesh.
    ShardedRows` (the mesh-sharded sketch): the sketch ``Y = X·Ω`` stays
    row-sharded, its Cholesky-QR2 Grams and ``B = QᵀX`` are sums over the
    data axis, the pad rows are left out, and ``n`` in ``l`` is the padded
    row count, as in the reference. The results land on the mesh's first
    device."""
    if isinstance(x, ShardedRows):
        shards = [x.local_rows(i) for i in range(len(x.blocks))]
        n, n_rows, d = x.n, x.n_pad, x.d
        first = x.mesh.first_device
    else:
        shards = [x]
        n = n_rows = x.shape[0]
        d = x.shape[1]
        first = x.device
    if k > min(n_rows, d):
        raise ValueError(
            f"randomized PCA needs k <= min(n_rows, n_features) = {min(n_rows, d)}, got k={k}"
        )
    bump_counter("pca.sketch")
    l = min(k + oversample, d, n_rows)
    dot = make_dot(precision)
    dtype = shards[0].dtype
    if center:
        mean = psum_data([torch.sum(t, dim=0) for t in shards], first) / n
    else:
        mean = torch.zeros((d,), dtype=dtype, device=first)

    def center_matmul(v):  # Xc @ v, one block per shard
        return [dot(t, v.to(t.device)) - (mean @ v).to(t.device)[None, :] for t in shards]

    def center_rmatmul(u):  # Xcᵀ @ u for u sharded like the rows
        return (psum_data([dot(t.T, ut) for t, ut in zip(shards, u)], first)
                - torch.outer(mean, psum_data([torch.sum(ut, dim=0) for ut in u], first)))

    with TraceRange("randomized sketch", TraceColor.PURPLE):
        q = _chol_qr2(center_matmul(_omega(omega, d, l, dtype, first)), dot)
        for _ in range(power_iters):
            z = _chol_qr2(center_rmatmul(q), dot)
            q = _chol_qr2(center_matmul(z), dot)
        b = center_rmatmul(q).T  # (l, d) = Qᵀ Xc
        # The right singular vectors of the small projection approximate
        # the top principal directions.
        _, s, vt = torch.linalg.svd(b, full_matrices=False)
        comps = sign_flip(vt[:k].T)
    denom = max(n - 1, 1)
    total_var = psum_data([_centered_trace(t, mean.to(t.device)) for t in shards], first) / denom
    explained = s[:k] ** 2 / denom
    ratio = explained / torch.clamp(total_var, min=torch.finfo(dtype).tiny)
    return comps, ratio, mean


def _gram_power_block(z, acc, rsum, xb, mean, precision: str = "highest"):
    """One block's share of Xcᵀ(Xc·Z): two tall-skinny GEMMs. Returns the
    updated ``(acc (d, l), rsum (l,))``; ``rsum`` sums the rows of Xc·Z
    (the rmatmul's mean correction)."""
    dot = make_dot(precision)
    t = dot(xb, z) - (mean @ z)[None, :]
    return acc + dot(xb.T, t), rsum + torch.sum(t, dim=0)


def _sketch_gram_block(z, g, xb, mean, precision: str = "highest"):
    """One block's share of (Xc·Z)ᵀ(Xc·Z), the (l, l) Rayleigh–Ritz Gram."""
    dot = make_dot(precision)
    t = dot(xb, z) - (mean @ z)[None, :]
    return g + dot(t.T, t)


def randomized_pca_streaming(
    make_blocks: Callable[[], Any],
    k: int,
    omega: Any = None,
    oversample: int = 10,
    power_iters: int = 2,
    precision: str = "highest",
    center: bool = True,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
):
    """Top-k PCA over a re-iterable block stream at O(d·l + block) memory:
    no (d, d) covariance and no (n, l) sketch anywhere.

    ``make_blocks`` returns a fresh iterator of host blocks. Passes: one
    for the moments (host float64 around the first block's mean), then
    ``max(power_iters, 1)`` passes of the implicit Gram, each followed by
    Cholesky-QR2, then one Rayleigh–Ritz pass whose (l, l) eigensolve
    gives the Ritz values (ratios against the streamed total variance) and
    the components ``Z·U``. Blocks go to ``device`` one ahead of their use
    and compute there in ``dtype``. ``omega`` is the (d, l) draw (default
    :func:`draw_omega`). Returns host float64 ``(components (d, k),
    explained-variance ratio (k,), mean (d,), n_rows)``."""
    if device is None:
        device = _device.resolve_device()
    bump_counter("pca.sketch.stream")

    # Pass 0 — moments: the mean and the centered total variance in host
    # float64 around a shift (which removes the cancellation a raw
    # E[x²] − mean² would suffer).
    shift = s_sum = None
    sq_sum = 0.0
    n = 0
    d = None
    with TraceRange("randomized stream moments", TraceColor.ORANGE):
        bump_counter("pca.sketch.stream.passes")
        for blk in make_blocks():
            b = dense_block(blk)
            if b.shape[0] == 0:
                continue
            if shift is None:
                d = b.shape[1]
                shift = b.mean(axis=0, dtype=np.float64) if center else np.zeros(d)
                s_sum = np.zeros(d)
            bs = b - shift  # float64
            s_sum += bs.sum(axis=0)
            sq_sum += float(np.einsum("ij,ij->", bs, bs))
            n += b.shape[0]
    if n < 2:
        raise ValueError(f"need at least 2 rows, got {n}")
    if k > min(n, d):
        raise ValueError(
            f"randomized PCA needs k <= min(n_rows, n_features) = {min(n, d)}, got k={k}"
        )
    delta = s_sum / n
    mean_h = shift + delta if center else np.zeros(d)
    # Σ‖x − mean‖² = Σ‖x − shift‖² − n‖δ‖²; with center=False the Ritz
    # values are raw second moments and the denominator is the raw trace.
    raw = sq_sum - (n * float(delta @ delta) if center else 0.0)
    total_var = max(raw, 0.0) / (n - 1)

    l = min(k + oversample, d, n)
    dot = make_dot(precision)
    mean_dev = torch.from_numpy(mean_h).to(device=device, dtype=dtype)
    z = _omega(omega, d, l, dtype, device)

    def blocks_dev():
        for host, xb in prefetch_blocks(make_blocks(), lambda blk: upload_block(blk, device)):
            if host.shape[0]:
                yield xb.to(dtype)

    # Power passes: Z ← orth(Xcᵀ(Xc·Z)), one streamed pass each.
    for _ in range(max(power_iters, 1)):
        with TraceRange("randomized stream power pass", TraceColor.PURPLE):
            bump_counter("pca.sketch.stream.passes")
            acc = torch.zeros((d, l), dtype=dtype, device=device)
            rsum = torch.zeros((l,), dtype=dtype, device=device)
            for xb in blocks_dev():
                acc, rsum = _gram_power_block(z, acc, rsum, xb, mean_dev, precision=precision)
            # Xcᵀ = Xᵀ − mean·1ᵀ, so Xcᵀ(XcZ) = Σ Xbᵀtb − mean·Σ rows(t).
            z = _chol_qr2(acc - torch.outer(mean_dev, rsum), dot)

    # Rayleigh–Ritz pass: G = Zᵀ Xcᵀ Xc Z streamed as (l, l).
    with TraceRange("randomized stream Rayleigh-Ritz pass", TraceColor.BLUE):
        bump_counter("pca.sketch.stream.passes")
        g = torch.zeros((l, l), dtype=dtype, device=device)
        for xb in blocks_dev():
            g = _sketch_gram_block(z, g, xb, mean_dev, precision=precision)
        w, u = _eigh(g / (n - 1))  # ascending
        w = torch.clamp(torch.flip(w, (0,))[:k], min=0)
        comps = sign_flip(dot(z, torch.flip(u, (1,))[:, :k]))
    ratio = w.double().cpu().numpy() / max(total_var, 1e-300)
    return comps.double().cpu().numpy(), ratio, mean_h, n
