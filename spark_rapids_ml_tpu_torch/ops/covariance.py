"""Covariance ops — port of the reference's ``ops/covariance.py``.

Centering, scaling and the rank-n update as plain tensor code: on the
card ``torch.matmul`` runs the Gram on cuBLAS (the reference leaves the
same product to XLA). The hand-written Gram kernel that stands in for the
reference's Pallas kernel lives in
:mod:`spark_rapids_ml_tpu_torch.ops.kernels.covariance`.

Both paths normalize by (n_rows − 1), as the reference does.

The streaming covariance (:func:`streaming_mean_and_covariance`) is one
pass over host blocks at constant memory: each block is centred on the
first block's host float64 column mean (the shift), its Gram is summed on
the device, and :func:`finalize_shifted_gram` corrects the sum to the
true centred Gram on the host in float64.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.serving import prefetch_blocks, upload_block
from spark_rapids_ml_tpu_torch.ops.linalg import _triu_indices_packed
from spark_rapids_ml_tpu_torch.ops.precision import make_dot


def centered_gram(x: torch.Tensor, mean: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """(x − mean)ᵀ(x − mean) — the per-partition covariance partial."""
    b = x - mean
    return make_dot(precision)(b.T, b)


def centered_gram_packed(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """The centered Gram in the packed-upper layout of the spr path
    (cuBLAS ``Dspr`` FILL_MODE_UPPER, n(n+1)/2 entries): computed as one
    GEMM and packed, since a GEMM beats n sequential rank-1 updates; the
    layout is kept as the aggregation format."""
    full = centered_gram(x, mean)
    rows, cols = _triu_indices_packed(x.shape[1])
    return full[torch.from_numpy(rows).to(full.device), torch.from_numpy(cols).to(full.device)]


def mean_and_covariance(x: torch.Tensor, precision: str = "highest"):
    """Single-device fused path: returns (column means, covariance / (n − 1))."""
    n = x.shape[0]
    mean = torch.mean(x, dim=0)
    cov = centered_gram(x, mean, precision=precision) / (n - 1)
    return mean, cov


def welford_init(d: int, dtype=torch.float64, device=None) -> tuple:
    """(count, mean, M2) accumulator for streaming column stats — the
    contract of mllib ``Statistics.colStats``."""
    return (
        torch.zeros((), dtype=dtype, device=device),
        torch.zeros((d,), dtype=dtype, device=device),
        torch.zeros((d,), dtype=dtype, device=device),
    )


#: Elements per row chunk of :func:`_block_m2`: the (rows, d) temporaries
#: of the squared deviations stay this size (32 MiB of float64) whatever
#: the block's height.
M2_CHUNK_ELEMENTS = 1 << 22


def _block_m2(x: torch.Tensor, mean_b: torch.Tensor) -> torch.Tensor:
    """Σ (x − mean_b)² by column, over row chunks of at most
    :data:`M2_CHUNK_ELEMENTS` elements: no (n, d) temporary. A block of
    one chunk sums exactly as the unchunked expression does."""
    rows = max(1, M2_CHUNK_ELEMENTS // max(int(x.shape[1]), 1))
    m2 = None
    for start in range(0, x.shape[0], rows):
        part = torch.sum((x[start:start + rows] - mean_b) ** 2, dim=0)
        m2 = part if m2 is None else m2 + part
    return m2


def welford_add_mean(state: tuple, x: torch.Tensor) -> tuple:
    """Merge one block's column means into ``(count, mean)``: the mean
    half of :func:`welford_add_block`, with the same arithmetic, for a
    caller that reads only the mean."""
    count, mean = state
    n_b = x.shape[0]
    if n_b == 0:  # an empty partition contributes nothing
        return state
    mean_b = torch.mean(x, dim=0)
    new_count = count + n_b
    delta = mean_b - mean
    return (new_count, mean + delta * (n_b / new_count))


def welford_add_block(state: tuple, x: torch.Tensor) -> tuple:
    """Merge one block's column stats into ``state`` (Chan et al.). The
    block's M2 is summed over row chunks (:func:`_block_m2`), so the fold
    allocates nothing the size of the block (the reference's jitted step
    fuses the same reduction)."""
    count, mean, m2 = state
    n_b = x.shape[0]
    if n_b == 0:  # an empty partition contributes nothing
        return state
    mean_b = torch.mean(x, dim=0)
    m2_b = _block_m2(x, mean_b)
    new_count = count + n_b
    delta = mean_b - mean
    new_mean = mean + delta * (n_b / new_count)
    new_m2 = m2 + m2_b + delta**2 * (count * n_b / new_count)
    return (new_count, new_mean, new_m2)


def welford_merge(a: tuple, b: tuple) -> tuple:
    """Merge two (count, mean, M2) accumulators (Chan et al.)."""
    count_a, mean_a, m2_a = a
    count_b, mean_b, m2_b = b
    count = count_a + count_b
    safe = torch.clamp(count, min=1)
    delta = mean_b - mean_a
    mean = mean_a + delta * (count_b / safe)
    m2 = m2_a + m2_b + delta**2 * (count_a * count_b / safe)
    return (count, mean, m2)


def shifted_block_scan(
    blocks: Iterable[Any],
    center: bool,
    gram_fn: Callable[[torch.Tensor], torch.Tensor],
    device: torch.device,
    min_rows: int = 2,
):
    """The one-pass shifted accumulation behind the streaming covariance.

    The exact mean is unknown until the stream ends, so every block is
    centred on the first block's host float64 column mean (zero with
    ``center=False``). Each block goes to ``device`` one ahead of its use
    (:func:`~spark_rapids_ml_tpu_torch.core.serving.prefetch_blocks`), is
    shifted there in float64 (the same IEEE subtraction as on the host),
    and ``gram_fn`` maps the shifted block to its Gram. Returns ``(shift
    (d,) host float64, Σ gram, Σ shifted rows (d,) float64, n)`` on the
    device; finish with :func:`finalize_shifted_gram`."""
    shift = shift_dev = gram = s = None
    n = 0
    for host, x in prefetch_blocks(blocks, lambda blk: upload_block(blk, device)):
        if host.shape[0] == 0:
            continue
        if shift is None:
            shift = host.mean(axis=0, dtype=np.float64) if center else np.zeros(host.shape[1])
            shift_dev = torch.from_numpy(shift).to(device)
        bs = x.to(torch.float64) - shift_dev
        g = gram_fn(bs)
        gram = g if gram is None else gram + g
        sb = torch.sum(bs, dim=0)
        s = sb if s is None else s + sb
        n += host.shape[0]
    if n < min_rows:
        raise ValueError(f"need at least 2 rows to compute a covariance, got {n}")
    return shift, gram, s, n


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def finalize_shifted_gram(shift, gram, s, n: int, center: bool):
    """``(mean, cov, n)`` on the host in float64 from a shifted scan: the
    correction ``Σx̃ᵀx̃ − n·δδᵀ`` (δ the mean of the shifted rows) gives the
    true centred Gram; with ``center=False`` the shift is zero and the sum
    already is the raw second moment. Normalized by (n − 1)."""
    delta = _host64(s) / n
    mean = _host64(shift) + delta
    gram = _host64(gram)
    if center:
        gram = gram - n * np.outer(delta, delta)
    return mean, gram / (n - 1), n


def streaming_mean_and_covariance(
    blocks: Iterable[Any],
    center: bool = True,
    dtype: torch.dtype = torch.float64,
    precision: str = "highest",
    device: Optional[torch.device] = None,
):
    """One pass over an iterable of host blocks: each is visited once, and
    the device holds one block (two, with the one ahead) and the (d, d)
    sum. The per-block Gram is :func:`centered_gram` with a zero mean in
    ``dtype``. Returns host float64 ``(mean, cov, n)``."""
    if device is None:
        device = _device.resolve_device()

    def gram_fn(bs: torch.Tensor) -> torch.Tensor:
        bs = bs.to(dtype)
        return centered_gram(bs, torch.zeros(bs.shape[1], dtype=dtype, device=bs.device), precision=precision)

    return finalize_shifted_gram(*shifted_block_scan(blocks, center, gram_fn, device), center)


def _sharded_block_gram(bs: torch.Tensor, mesh, dtype: torch.dtype, precision: str) -> torch.Tensor:
    """The Gram of one shifted block split over the mesh's data axis: each
    shard's Gram where that shard lives, summed over the data axis on the
    first device (features are not split, as in the reference's
    ``P(data, None)`` block layout)."""
    from spark_rapids_ml_tpu_torch.parallel.collectives import psum_data

    grid = mesh.grid
    dp = grid.shape[0]
    per = -(-bs.shape[0] // dp)
    dot = make_dot(precision)
    grams = []
    for i in range(dp):
        shard = bs[i * per:(i + 1) * per].to(device=grid[i, 0], dtype=dtype)
        grams.append(dot(shard.T, shard))
    return psum_data(grams, mesh.first_device)


def streaming_mean_and_covariance_mesh(
    blocks: Iterable[Any],
    mesh,
    center: bool = True,
    dtype: torch.dtype = torch.float64,
    precision: str = "highest",
):
    """One pass over streamed host blocks, each split over the mesh's data
    axis: :func:`streaming_mean_and_covariance` with the per-block Gram
    taken per shard and summed over the data axis. A block goes to the
    mesh's first device, is shifted there in float64 and split; host and
    per-device memory stay bounded by one block. Returns host float64
    ``(mean, cov, n)``. A gang has its own route,
    ``parallel.distributed.streaming_covariance_process_local``."""
    from spark_rapids_ml_tpu_torch.parallel.collectives import process_count

    if process_count() > 1:
        raise ValueError(
            "this single-process sharded-block path has a multi-process "
            "sibling: parallel.distributed.streaming_covariance_process_local "
            "(each process streams its LOCAL blocks; RowMatrix routes there "
            "automatically)"
        )

    def gram_fn(bs: torch.Tensor) -> torch.Tensor:
        return _sharded_block_gram(bs, mesh, dtype, precision)

    return finalize_shifted_gram(*shifted_block_scan(blocks, center, gram_fn, mesh.first_device), center)
