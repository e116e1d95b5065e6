"""Approximate nearest neighbours, IVF-Flat and IVF-PQ — port of the
reference's ``ops/ann.py``.

  - **Coarse quantizer**: greedy k-means++ (:func:`ops.kmeans.kmeans_plusplus_init`,
    a ``torch.Generator`` seeded from ``seed``) and Lloyd (:func:`ops.kmeans.lloyd`)
    over the items on their device; the final assignment is row-blocked
    (:func:`ops.kmeans.assign_clusters_blocked`) under the reference's
    rule, ``4·n·n_lists > 2e9``.
  - **Inverted lists as one dense tensor**: the items grouped by list
    into (n_lists, L_max, d), padded to the longest list, with a mask and
    the original indices (-1 at padding). The grouping is a host argsort
    (:func:`_pack_lists`), done once at build time, as in the reference.
  - **Search**: one (Bq, d)×(d, n_lists) product ranks the centroids, then
    a loop over the ``n_probe`` chosen lists gathers each query's list
    (Bq, L_max, d), contracts it with ``torch.bmm`` and merges it into the
    running top-k (:func:`ops.knn._merge`, ties to the lower position).
    Live memory is O(Bq · L_max · d) per step.

Every distance that enters a ranking is clamped at 0 and made +0
(``clamp_min`` then ``+ 0.0``): the merge ranks float32 rows by the bit
pattern of the distance, which orders non-negative floats only. The
reference clamps the list and table distances the same way; its centroid
ranking takes the raw expansion, which differs from the clamped one only
where two centroids both round below 0 for one query.

**IVF-PQ** quantizes each list's residuals: the feature axis splits into
M subspaces, each trained by k-means++ and Lloyd over the padded residual
rows (padding has weight 0), generator seeded from ``(seed + 1, m)`` as
the reference folds its key. Codes are uint8; the search widens them to
``long`` before gathering (a uint8 index would read as a boolean mask)
and sums the M table gathers in the reference's order, m = 0..M−1.

Setting ``n_probe = n_lists`` makes either search exact. The quantizer's
draws cannot reproduce JAX's threefry, so a port-built index differs from
the reference's for the same seed (ROADMAP C); an index carried across
(``interop``) searches the same lists in both.

Over a mesh the build shards its rows over the data axis: the quantizer's
k-means++ and Lloyd run on the ``ShardedRows`` (the mesh KMeans of
``ops/kmeans.py``) and each shard assigns its own rows; the PQ codebooks
train on the residual matrix sharded once, each subspace a column slice
of it, padding weighted 0. The draws are those of the single-device build,
and the quantizer and codebook Lloyds sum their statistics in float64
(``stats_dtype``), so a mesh-built index equals the single-device build:
float32 sums taken in another order would move the centres by an ulp and
flip the near-tie assignments of a few rows, and from there the lists.
:func:`ann_search_sharded` splits the queries over the data axis against
the index whole on every position; results are per query, so nothing is
merged across shards.

Neither mesh route runs in a gang of more than one process: both raise
``NotImplementedError`` (``parallel.mesh.refuse_gang``), because the
reference's own fail there. Its quantizer places every data shard of the
global mesh from one process (``jax.make_array_from_single_device_arrays``
refuses shards for devices the process cannot address), and its mesh
search reads back a result that spans other processes' devices. The
``brute`` algorithms' mesh search is :func:`ops.knn.knn_sharded`, which
runs in a gang.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.ops.kmeans import (
    RowShards,
    as_row_shards,
    assign_clusters,
    assign_clusters_blocked,
    kmeans_plusplus_init,
    lloyd,
)
from spark_rapids_ml_tpu_torch.ops.knn import _merge, _nonneg, _smallest_k
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    refuse_gang,
    shard_tensor_rows,
    weights_as_mask,
)
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

#: Above this 4·n·n_lists the quantizer's final assignment is row-blocked
#: (the reference's rule: the full (n, n_lists) float32 matrix would
#: exceed ~2 GB).
BLOCKED_ASSIGN_BYTES = 2_000_000_000

#: Why each IVF mesh route is refused in a gang: how the reference's fails.
_GANG_BUILD = ("its quantizer's shard_rows places every data shard from each process, and "
               "jax.make_array_from_single_device_arrays refuses shards for devices a process cannot address")
_GANG_SEARCH = ("its search reads back a jax.Array that spans non-addressable devices, which JAX refuses")


class IVFIndex(NamedTuple):
    """Dense IVF-Flat index, tensors on one device.

    centroids: (n_lists, d)
    lists:     (n_lists, L_max, d)  — items grouped by nearest centroid
    list_mask: (n_lists, L_max)     — 1 real row / 0 padding
    list_ids:  (n_lists, L_max)     — int32 original item indices, -1 at padding
    """

    centroids: torch.Tensor
    lists: torch.Tensor
    list_mask: torch.Tensor
    list_ids: torch.Tensor

    @property
    def n_lists(self) -> int:
        return int(self.lists.shape[0])


class IVFPQIndex(NamedTuple):
    """Dense IVF-PQ index: coarse lists and per-subspace residual codebooks.

    centroids: (n_lists, d)
    codebooks: (M, K, ds)          — K = min(2^n_bits, n) entries a subspace
    codes:     (n_lists, L_max, M) uint8 — each item's residual code
    list_mask: (n_lists, L_max)
    list_ids:  (n_lists, L_max)    — int32 original item indices, -1 at padding
    """

    centroids: torch.Tensor
    codebooks: torch.Tensor
    codes: torch.Tensor
    list_mask: torch.Tensor
    list_ids: torch.Tensor

    @property
    def n_lists(self) -> int:
        return int(self.codes.shape[0])


def index_to(index, device: torch.device, dtype: torch.dtype):
    """The same index with its floating tensors in ``dtype`` on ``device``
    (codes and ids keep their types)."""
    return type(index)(*(
        t.to(device=device, dtype=dtype) if t.is_floating_point() else t.to(device=device)
        for t in index
    ))


def _items_on_device(items) -> Tuple[torch.Tensor, np.ndarray]:
    """(the items on their compute device, the items on the host): a
    tensor stays where it lives and is copied to the host once for the
    packing; a host matrix goes to :func:`device.resolve_device`."""
    if isinstance(items, torch.Tensor):
        x = items if items.is_floating_point() else items.to(torch.float32)
        _device.device_of(x)
        return x, x.detach().cpu().numpy()
    host = np.asarray(items)
    if not np.issubdtype(host.dtype, np.floating):
        host = host.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(host)).to(_device.resolve_device()), host


def _coarse_quantizer(x: torch.Tensor, n_lists: int, seed: int, kmeans_iters: int,
                      mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means++ and Lloyd over the rows of ``x`` where they live, or over
    them sharded on ``mesh``'s data axis: (centroids (n_lists, d), labels
    (n,)), the row padding stripped."""
    n = int(x.shape[0])
    if mesh is None:
        shards = RowShards([x], [torch.ones(n, dtype=x.dtype, device=x.device)], [0], n, x.device)
    else:
        shards = as_row_shards(shard_tensor_rows(x, mesh))
    init = kmeans_plusplus_init(shards, None, _device.seeded_generator(shards.device, seed), n_lists)
    centroids, _, _ = lloyd(shards, None, init, max_iter=kmeans_iters, tol=1e-4,
                            stats_dtype=torch.float64)
    blocked = 4 * n * n_lists > BLOCKED_ASSIGN_BYTES
    if blocked:
        bump_counter("ann.quantizer.blocked_assign")
    assign = assign_clusters_blocked if blocked else assign_clusters
    labels = [assign(xi, centroids.to(xi.device))[0].to(shards.device) for xi in shards.x]
    return centroids, labels[0] if len(labels) == 1 else torch.cat(labels)


def _pack_lists(items: np.ndarray, labels: np.ndarray, n_lists: int):
    """Group host ``items`` by list (a stable argsort of ``labels``):
    ``(lists (n_lists, L_max, d), list_mask (n_lists, L_max), list_ids
    (n_lists, L_max) int32)``, each list in item order, padded with zero
    rows, mask 0 and id -1 to the longest list."""
    n, d = items.shape
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=n_lists)
    l_max = max(int(counts.max()), 1)
    lists = np.zeros((n_lists, l_max, d), dtype=items.dtype)
    list_mask = np.zeros((n_lists, l_max), dtype=items.dtype)
    list_ids = np.full((n_lists, l_max), -1, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for lid in range(n_lists):
        sel = order[starts[lid]:starts[lid + 1]]
        lists[lid, :sel.size] = items[sel]
        list_mask[lid, :sel.size] = 1.0
        list_ids[lid, :sel.size] = sel
    return lists, list_mask, list_ids


def build_ivf_index(
    items,
    n_lists: int,
    seed: int = 0,
    kmeans_iters: int = 10,
    mesh=None,
) -> IVFIndex:
    """Train the coarse quantizer and pack the inverted lists. ``items``
    is a host matrix or a tensor; the quantizer runs where the tensor
    lives (a host matrix goes to :func:`device.resolve_device`), or over
    ``mesh``, the packing on the host, and the index lands on the items'
    device."""
    n = int(items.shape[0])
    if not 1 <= n_lists <= n:
        raise ValueError(f"n_lists must be in [1, {n}], got {n_lists}")
    if mesh is not None:
        refuse_gang(mesh, "the mesh IVF build", _GANG_BUILD)
    x, host = _items_on_device(items)
    with TraceRange("ann quantizer", TraceColor.YELLOW):
        centroids, labels = _coarse_quantizer(x, n_lists, seed, kmeans_iters, mesh)
    with TraceRange("ann pack lists", TraceColor.YELLOW):
        lists, list_mask, list_ids = _pack_lists(host, labels.cpu().numpy(), n_lists)
    dev = x.device
    return IVFIndex(
        centroids=centroids.to(dev),
        lists=torch.from_numpy(lists).to(dev),
        list_mask=torch.from_numpy(list_mask).to(dev),
        list_ids=torch.from_numpy(list_ids).to(dev),
    )


def _probe_scaffold(index, queries, k: int, n_probe: int, block_q: int, dot, list_d2_fn):
    """The search loop both indexes share: query blocks, the centroid
    ranking, then each probed list's (Bq, L_max) distances from
    ``list_d2_fn(qb, q_sq, lid)`` merged into the running top-k. Unfilled
    slots read (inf, -1)."""
    n_lists = int(index.list_mask.shape[0])
    if not 1 <= n_probe <= n_lists:
        raise ValueError(f"n_probe must be in [1, {n_lists}], got {n_probe}")
    dev = _device.device_of(queries)
    dtype = queries.dtype
    centroids = index.centroids
    c_sq = torch.sum(centroids * centroids, dim=1)
    out_d, out_i = [], []
    for s in range(0, int(queries.shape[0]), block_q):
        qb = queries[s:s + block_q]
        bq = int(qb.shape[0])
        q_sq = torch.sum(qb * qb, dim=1)
        cd2 = _nonneg((q_sq[:, None] - 2.0 * dot(qb, centroids.T)) + c_sq[None, :])
        probe_ids = _smallest_k(cd2, n_probe)
        del cd2
        best_d = torch.full((bq, k), float("inf"), dtype=dtype, device=dev)
        best_i = torch.full((bq, k), -1, dtype=torch.int32, device=dev)
        for p in range(n_probe):
            lid = probe_ids[:, p]
            d2 = list_d2_fn(qb, q_sq, lid)
            d2 = torch.where(index.list_mask[lid] > 0, d2, torch.full_like(d2, float("inf")))
            best_d, best_i = _merge(best_d, best_i, d2, index.list_ids[lid], k)
            del d2
        out_d.append(best_d)
        out_i.append(best_i)
    if not out_d:
        return (torch.zeros((0, k), dtype=dtype, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    return torch.cat(out_d), torch.cat(out_i)


def ivf_search(
    index: IVFIndex,
    queries: torch.Tensor,
    k: int,
    n_probe: int,
    block_q: int = 1024,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k approximate neighbours: (squared distances (nq, k), indices
    (nq, k) int32). Indices are original item indices; unfilled slots
    (fewer than k candidates in the probed lists) are (inf, -1)."""
    dot = make_dot(precision)
    item_sq = torch.sum(index.lists * index.lists, dim=2)  # (n_lists, L_max)

    def list_d2(qb, q_sq, lid):
        xb = index.lists[lid]  # (Bq, L_max, d) gather
        cross = torch.bmm(xb, qb[:, :, None])[:, :, 0]
        return _nonneg((q_sq[:, None] - 2.0 * cross) + item_sq[lid])

    return _probe_scaffold(index, queries, k, n_probe, block_q, dot, list_d2)


def build_ivfpq_index(
    items,
    n_lists: int,
    m_subspaces: int,
    n_bits: int = 8,
    seed: int = 0,
    kmeans_iters: int = 10,
    pq_iters: int = 10,
    mesh=None,
) -> IVFPQIndex:
    """Train the coarse quantizer, then one residual codebook per
    subspace: k-means++ and Lloyd over every list's padded residual rows,
    padding at weight 0."""
    n, d = int(items.shape[0]), int(items.shape[1])
    if d % m_subspaces != 0:
        raise ValueError(f"d={d} not divisible by M={m_subspaces} subspaces")
    if not 1 <= n_bits <= 8:
        raise ValueError(f"n_bits must be in [1, 8], got {n_bits}")
    ds = d // m_subspaces
    n_codes = min(1 << n_bits, n)

    flat = build_ivf_index(items, n_lists, seed=seed, kmeans_iters=kmeans_iters, mesh=mesh)
    residuals = flat.lists - flat.centroids[:, None, :]  # (n_lists, L_max, d)
    r_sub = residuals.reshape(-1, m_subspaces, ds)
    w = flat.list_mask.reshape(-1)
    dev = residuals.device
    sharded = None if mesh is None else _shard_residuals(residuals.reshape(-1, d), w, mesh)
    codebooks, codes = [], []
    with TraceRange("ann pq codebooks", TraceColor.YELLOW):
        for m in range(m_subspaces):
            rm = r_sub[:, m, :].contiguous()
            gen = _device.seeded_generator(dev if sharded is None else sharded.device, seed + 1, m)
            if sharded is None:
                init = kmeans_plusplus_init(rm, w, gen, n_codes)
                cb, _, _ = lloyd(rm, w, init, max_iter=pq_iters, tol=1e-4, stats_dtype=torch.float64)
            else:
                rm_s = _column_slice(sharded, m * ds, (m + 1) * ds)
                init = kmeans_plusplus_init(rm_s, None, gen, n_codes)
                cb, _, _ = lloyd(rm_s, None, init, max_iter=pq_iters, tol=1e-4, stats_dtype=torch.float64)
                cb = cb.to(dev)
            code_m, _ = assign_clusters(rm, cb)
            codebooks.append(cb)
            codes.append(code_m.to(torch.uint8))
            del rm
    l_max = int(flat.lists.shape[1])
    return IVFPQIndex(
        centroids=flat.centroids,
        codebooks=torch.stack(codebooks),
        codes=torch.stack(codes, dim=-1).reshape(n_lists, l_max, m_subspaces),
        list_mask=flat.list_mask,
        list_ids=flat.list_ids,
    )


def ivfpq_search(
    index: IVFPQIndex,
    queries: torch.Tensor,
    k: int,
    n_probe: int,
    block_q: int = 1024,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by asymmetric distance (ADC): (squared distance estimates
    (nq, k), indices (nq, k) int32). Per probed list, the residual
    q − centroid gives a (Bq, M, K) table of subspace distances (one
    batched product), and an item's distance is the sum of its M table
    entries."""
    _, l_max, m_sub = index.codes.shape
    _, n_codes, ds = index.codebooks.shape
    dot = make_dot(precision)
    cb_sq = torch.sum(index.codebooks * index.codebooks, dim=2)  # (M, K)
    cb_t = index.codebooks.transpose(1, 2)  # (M, ds, K)

    def list_d2(qb, q_sq, lid):
        bq = qb.shape[0]
        r = (qb - index.centroids[lid]).reshape(bq, m_sub, ds)
        r_sq = torch.sum(r * r, dim=2)  # (Bq, M)
        cross = torch.bmm(r.transpose(0, 1), cb_t).transpose(0, 1)  # (Bq, M, K)
        lut = _nonneg((r_sq[:, :, None] - 2.0 * cross) + cb_sq[None, :, :])
        codes_b = index.codes[lid]  # (Bq, L_max, M) uint8
        d2 = torch.zeros((bq, l_max), dtype=qb.dtype, device=qb.device)
        for m in range(m_sub):
            d2 = d2 + torch.gather(lut[:, m, :], 1, codes_b[:, :, m].long())
        return d2

    return _probe_scaffold(index, queries, k, n_probe, block_q, dot, list_d2)


def _shard_residuals(r: torch.Tensor, w: torch.Tensor, mesh) -> RowShards:
    """The (rows, d) residual matrix sharded over the mesh once, its list
    mask as the row weights (padding weighs 0)."""
    sr = shard_tensor_rows(r, mesh)
    weights = weights_as_mask(w.cpu().numpy(), sr.n_pad, r.dtype, mesh)
    return as_row_shards(sr.fold_weights(weights))


def _column_slice(shards: RowShards, lo: int, hi: int) -> RowShards:
    """Columns [lo, hi) of every shard's rows, where each shard lives."""
    return shards._replace(x=[xi[:, lo:hi].contiguous() for xi in shards.x])


def dispatch_search(index):
    """The one home of the index-type → search dispatch."""
    return ivfpq_search if isinstance(index, IVFPQIndex) else ivf_search


def ann_search_sharded(
    mesh,
    index,
    queries: torch.Tensor,
    k: int,
    n_probe: int,
    block_q: int = 1024,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IVF-Flat or IVF-PQ search over a mesh: the queries, zero-padded
    to a multiple of the data axis, split over it; each shard probes the
    whole index (copied once to each distinct device) for its queries.
    Results are per query, so the shards' results are joined in order on
    the queries' device and the padding is cut."""
    refuse_gang(mesh, "the mesh IVF search", _GANG_SEARCH)
    grid = mesh.grid
    dp = int(mesh.shape[DATA_AXIS])
    nq = int(queries.shape[0])
    pad = (-nq) % dp
    qp = torch.nn.functional.pad(queries, (0, 0, 0, pad)) if pad else queries
    per = (nq + pad) // dp
    search = dispatch_search(index)
    dev = queries.device
    copies = {index.centroids.device: index}
    out_d: List[torch.Tensor] = []
    out_i: List[torch.Tensor] = []
    for i in range(grid.shape[0]):
        pos = grid[i, 0]
        if pos not in copies:
            copies[pos] = index_to(index, pos, index.centroids.dtype)
        d2, ids = search(copies[pos], qp[i * per:(i + 1) * per].to(pos), k, n_probe, block_q, precision)
        out_d.append(d2.to(dev))
        out_i.append(ids.to(dev))
    return torch.cat(out_d)[:nq], torch.cat(out_i)[:nq]


__all__ = [
    "IVFIndex", "IVFPQIndex", "ann_search_sharded", "build_ivf_index", "build_ivfpq_index",
    "dispatch_search", "index_to", "ivf_search", "ivfpq_search",
]
