"""Brute-force k-nearest neighbours — port of the reference's ``ops/knn.py``.

The distance GEMM ``‖q‖² − 2·q·x + ‖x‖²`` is one plain product per item
block (``torch.matmul``, IEEE fp32 on the card: :func:`device.device_of`
turns TF32 off), and a Python loop over item blocks keeps the running
(nq, k) top-k, so memory is O(nq · (k + block)) as in the reference's
``lax.scan``.

Ties go to the lower item index, as ``lax.top_k`` gives them: the merge
ranks each candidate row by the key ``(distance bits, position)``, which
is unique, so ``torch.topk`` (which promises no order among equal values)
has no tie left to break. Distances are ≥ 0 (clamped, ``-0`` made
``+0``), whose IEEE bit patterns order as integers.

``approx=True`` (``buildAlgo="brute_approx"``) is exact here: the card has
no counterpart of ``lax.approx_min_k``, and the reference is exact on the
CPU as well (ROADMAP C).

:func:`knn_host_streamed` searches an item set streamed from the host
block by block (beyond device memory): each block is copied to the
queries' device one ahead of its use (``core/serving.prefetch_blocks``),
merged into the running (nq, k) state by :func:`_merge_block_topk` (the
same merge as the resident loop, so the result does not depend on the
block sizes) and then freed.

:func:`shard_items` places the items row-sharded over a mesh's data axis
(padded with masked rows to a multiple of it; features whole), and
:func:`knn_sharded` takes each shard's local top-k where it lives and
merges the shards' candidates, joined in shard order, with the same
int64-key top-k: ties go to the lower global index, so the result is the
single-device search's. A mesh route takes the whole matrix in one
process (``parallel.mesh.require_one_process``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.serving import prefetch_blocks, upload_block
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.mesh import require_one_process

METRICS = ("euclidean", "sqeuclidean", "cosine")


def _nonneg(d2: torch.Tensor) -> torch.Tensor:
    """Clamp squared distances at 0, in place, and turn -0 into +0
    (``clamp_min`` keeps a -0; adding +0 does not), so their bit patterns
    order as integers (:func:`_smallest_k`)."""
    return torch.clamp_min_(d2, 0.0).add_(0.0)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm, norms floored at 1e-30 (cosine)."""
    return x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True), 1e-30)


def _block_sq_distances(q: torch.Tensor, xb: torch.Tensor, q_sq: torch.Tensor, dot) -> torch.Tensor:
    """(nq, B) squared euclidean distances of queries to one item block,
    summed in the reference's order and clamped at +0."""
    xb_sq = torch.sum(xb * xb, dim=1)
    cross = dot(q, xb.T)
    return _nonneg((q_sq[:, None] - 2.0 * cross) + xb_sq[None, :])


def _auto_block_items(nq: int, n_items: int) -> int:
    """Item-block size, the reference's rule: at most 65,536 items, fewer
    for large query batches (about 2 GiB of float32 (nq, block) buffer),
    at least 1,024."""
    return min(n_items, 65536, max(1024, (1 << 29) // max(nq, 1)))


def _smallest_k(cand_d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest entries of each candidate row, in
    ascending (distance, position) order. float32 rows rank by the unique
    int64 key ``(bits of d) · 2³² + position`` through ``torch.topk``;
    other types (float64 in the tests) by a stable sort."""
    if cand_d.dtype != torch.float32:
        return torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
    pos = torch.arange(cand_d.shape[1], dtype=torch.int64, device=cand_d.device)
    key = cand_d.view(torch.int32).to(torch.int64).bitwise_left_shift_(32).bitwise_or_(pos[None, :])
    return torch.topk(key, k, dim=1, largest=False, sorted=True).indices


def _merge(best_d, best_i, d2, idx_block, k: int):
    """Keep the k smallest of ``[best | block]`` per query row, lower
    position first among equal distances (the reference's ``top_k``).
    ``idx_block`` is the block's indices, shared by every row (B,) or
    one row each (nq, B)."""
    m = best_d.shape[1]
    cand_d = torch.cat([best_d, d2], dim=1)
    pos = _smallest_k(cand_d, k)
    new_d = torch.gather(cand_d, 1, pos)
    old_i = torch.gather(best_i, 1, pos.clamp(max=m - 1))
    blk_pos = (pos - m).clamp(min=0)
    if idx_block.dim() == 2:
        blk_i = torch.gather(idx_block, 1, blk_pos)
    else:
        blk_i = idx_block[blk_pos]
    return new_d, torch.where(pos < m, old_i, blk_i)


def knn_sq_euclidean(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    item_mask: Optional[torch.Tensor] = None,
    block_items: Optional[int] = None,
    precision: str = "highest",
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by squared euclidean distance, exact (``approx`` included).

    Returns (distances (nq, k) ascending, indices (nq, k) int32 into
    ``items``). ``item_mask``: 1 for a real row, 0 for a padded one;
    masked rows get distance +inf and index -1, so when k exceeds the
    real rows the unfilled slots read (inf, -1). Items go through in
    ``block_items``-row blocks (:func:`_auto_block_items` when None).
    """
    del approx  # exact on every device (module docstring)
    n_items = int(items.shape[0])
    if not 1 <= k <= n_items:
        raise ValueError(f"k must be in [1, {n_items}], got {k}")
    _device.device_of(queries)
    if block_items is None:
        block_items = _auto_block_items(int(queries.shape[0]), n_items)
    block = min(int(block_items), n_items)
    dot = make_dot(precision)
    dev, dtype = queries.device, queries.dtype
    nq = int(queries.shape[0])
    q_sq = torch.sum(queries * queries, dim=1)
    mask = None if item_mask is None else item_mask.to(device=dev, dtype=dtype)
    best_d = torch.full((nq, k), float("inf"), dtype=dtype, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n_items, block):
        xb = items[start:start + block]
        d2 = _block_sq_distances(queries, xb, q_sq, dot)
        idx = torch.arange(start, start + xb.shape[0], dtype=torch.int32, device=dev)
        if mask is not None:
            mb = mask[start:start + block] > 0
            d2 = torch.where(mb[None, :], d2, torch.full_like(d2, float("inf")))
            idx = torch.where(mb, idx, torch.full_like(idx, -1))
        best_d, best_i = _merge(best_d, best_i, d2, idx, k)
        del d2
    return best_d, best_i


def knn(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    item_mask: Optional[torch.Tensor] = None,
    block_items: Optional[int] = None,
    metric: str = "euclidean",
    precision: str = "highest",
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k under ``euclidean`` | ``sqeuclidean`` | ``cosine``. Cosine
    distance is ``1 − cos``: both sides L2-normalised, half the squared
    euclidean distance."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "cosine":
        d2, idx = knn_sq_euclidean(unit_rows(queries), unit_rows(items), k, item_mask, block_items,
                                   precision, approx)
        return d2 / 2.0, idx
    d2, idx = knn_sq_euclidean(queries, items, k, item_mask, block_items, precision, approx)
    if metric == "euclidean":
        return torch.sqrt(d2), idx
    return d2, idx


def _merge_block_topk(best_d, best_i, queries, q_sq, xb, start: int, k: int,
                      approx: bool = False, precision: str = "highest"):
    """One streamed block merged into the running (nq, k) top-k state:
    the resident loop's step, for a host loop to drive block by block.
    ``approx`` is exact here (module docstring)."""
    del approx
    d2 = _block_sq_distances(queries, xb, q_sq, make_dot(precision))
    idx = torch.arange(start, start + xb.shape[0], dtype=torch.int32, device=xb.device)
    return _merge(best_d, best_i, d2, idx, k)


def knn_host_streamed(
    queries: torch.Tensor,
    item_blocks,
    k: int,
    metric: str = "euclidean",
    precision: str = "highest",
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k against an item set streamed from the host: ``item_blocks``
    is an iterable of host (rows_i, d) blocks (a list, a generator,
    ``reader.iter_blocks()``; one pass). Each non-empty block goes to the
    queries' device in their dtype and merges into the running state, so
    device memory is O(nq · k + block) and the item count is bounded by
    the source. Indices count rows across the blocks. Raises
    ``ValueError`` when the pass ends with fewer than k items."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dev = _device.device_of(queries)
    q = unit_rows(queries) if metric == "cosine" else queries
    q_sq = torch.sum(q * q, dim=1)
    nq, dtype = int(q.shape[0]), q.dtype
    best_d = torch.full((nq, k), float("inf"), dtype=dtype, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)

    def upload(blk):
        host, xb = upload_block(blk, dev, dtype)
        if host.shape[0] == 0:
            return None
        return unit_rows(xb) if metric == "cosine" else xb

    offset = 0
    for xb in prefetch_blocks(item_blocks, upload):
        if xb is None:
            continue
        best_d, best_i = _merge_block_topk(best_d, best_i, q, q_sq, xb, offset, k,
                                           approx=approx, precision=precision)
        offset += int(xb.shape[0])
    if offset < k:
        raise ValueError(f"k={k} exceeds streamed item count {offset}")
    if metric == "euclidean":
        return torch.sqrt(best_d), best_i
    if metric == "cosine":
        return best_d / 2.0, best_i
    return best_d, best_i


def shard_items(items: Any, mesh, metric: str = "euclidean",
                dtype: Optional[torch.dtype] = None) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Place an (n, d) item matrix (host or tensor) over the mesh for
    :func:`knn_sharded`: rows padded with zeros to a multiple of the data
    axis and split over it, one (n / shards, d) block per data shard on
    its first device (features whole: the model axis adds nothing to the
    merge), in ``dtype`` (default the items'). ``metric="cosine"``
    normalizes the rows before placement, so the index is ready for cosine
    search. Returns (item blocks, mask blocks: 1 real, 0 padding)."""
    require_one_process(mesh, "the sharded kNN index")
    x = items if isinstance(items, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(items))
    if dtype is not None:
        x = x.to(dtype)
    grid = mesh.grid
    dp = int(grid.shape[0])
    n = int(x.shape[0])
    n_shard = -(-n // dp)
    blocks, masks = [], []
    for i in range(dp):
        dev = grid[i, 0]
        blk = x[i * n_shard:(i + 1) * n_shard].to(dev)
        if metric == "cosine":
            blk = unit_rows(blk)
        real = int(blk.shape[0])
        if real < n_shard:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, n_shard - real))
        mask = torch.zeros(n_shard, dtype=blk.dtype, device=dev)
        mask[:real] = 1.0
        blocks.append(blk.contiguous())
        masks.append(mask)
    return blocks, masks


def knn_sharded(
    queries: torch.Tensor,
    items: List[torch.Tensor],
    item_mask: List[torch.Tensor],
    mesh,
    k: int,
    precision: str = "highest",
    metric: str = "sqeuclidean",
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over items placed by :func:`shard_items`, queries whole.

    Each shard searches its block where it lives (the resident blocked
    search, masked rows at +inf) for its local top ``min(k, shard rows)``
    and offsets the indices by its first global row; the candidates of all
    shards, joined in shard order on the queries' device, go through one
    final int64-key top-k. Indices are global item rows (int32).
    ``metric``: "sqeuclidean" (default) | "euclidean" | "cosine" (the
    items sharded with ``metric="cosine"``; the queries are normalized
    here). ``approx`` is exact (module docstring)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    require_one_process(mesh, "the sharded kNN search")
    dev = _device.device_of(queries)
    if metric == "cosine":
        queries = unit_rows(queries)
    n_shard = int(items[0].shape[0])
    k_loc = min(k, n_shard)
    cand_d, cand_i = [], []
    for i, (xb, mb) in enumerate(zip(items, item_mask)):
        d, idx = knn_sq_euclidean(queries.to(xb.device), xb, k_loc, item_mask=mb,
                                  precision=precision, approx=approx)
        idx = torch.where(idx >= 0, idx + i * n_shard, idx)
        cand_d.append(d.to(dev))
        cand_i.append(idx.to(dev))
    cand_d = torch.cat(cand_d, dim=1)
    cand_i = torch.cat(cand_i, dim=1)
    pos = _smallest_k(cand_d, k)
    d2 = torch.gather(cand_d, 1, pos)
    idx = torch.gather(cand_i, 1, pos)
    if metric == "euclidean":
        return torch.sqrt(d2), idx
    if metric == "cosine":
        return d2 / 2.0, idx
    return d2, idx


__all__ = ["knn", "knn_host_streamed", "knn_sharded", "knn_sq_euclidean", "shard_items"]
