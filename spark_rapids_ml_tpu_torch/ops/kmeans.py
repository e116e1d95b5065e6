"""KMeans ops in plain PyTorch — port of the reference's ``ops/kmeans.py``
(the ``xla`` route).

  - assignment: squared distances by the expansion ‖x‖² − 2·x·Cᵀ + ‖c‖²,
    one (n, d)×(d, k) product, no (n, k, d) intermediate;
  - update: cluster sums as one_hot(labels)ᵀ·x, counts and cost beside;
  - :func:`lloyd` is a Python loop with the reference's stopping rule
    (``moved > tol²`` and ``it < max_iter``) and a final cost pass; it
    reads ``moved`` once per iteration, one host sync each;
  - empty clusters keep their previous center; a row of weight 0 joins
    no cluster and no cost.

``argmin`` keeps the first minimum, as ``jnp.argmin`` does. Seeding draws
from an explicit ``torch.Generator`` (JAX's threefry bits cannot be
reproduced, so seeded results match the reference in distribution, not
bit for bit); the reference's ``approx_max_k`` is an exact ``topk`` here.

The streaming fit: :func:`reservoir_sample_rows` draws the seeding
sample in one pass (numpy's ``default_rng(seed)``, so the sample is the
reference's bit for bit) and :func:`lloyd_streaming` runs one pass over a
re-iterable block source per Lloyd iteration, summing each block's
:func:`block_suff_stats` on the device. Kernels K2 and K3 are not used on
this route, as in the reference.

:func:`assign_clusters_blocked` walks the rows in blocks, so only a
(block, k) distance matrix exists at a time: the IVF coarse quantizer's
final assignment at shapes whose full (n, k) matrix would not fit.

Over a mesh (:class:`RowShards`, built from a ``ShardedRows`` by
:func:`as_row_shards`) each data shard computes its assignment and
statistics where it lives, the sums meet in ``psum_data`` and the centre
update runs on the first device. The seeding draws its uniforms for the
global row order from the one generator and splits them by shard, and
its top-t choices and candidate rows are taken over all shards, and each
step's candidate potentials are summed in float64 (so the greedy choice
does not turn on the order of the sums), so a mesh fit draws what the
single-device fit draws and differs from it only in the order of its
sums.

:func:`lloyd_resumable` is the checkpointed Lloyd (``robustness/
checkpoint.py``): :func:`lloyd` and it run the same :func:`_lloyd_segment`,
so a segmented fit issues the monolithic fit's launches in the same order
and equals it bitwise; each streaming pass is a ``solver.segment`` fault
site.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.core.data import _block_to_dense
from spark_rapids_ml_tpu_torch.core.serving import prefetch_blocks, upload_block
from spark_rapids_ml_tpu_torch.observability.costs import ledgered_call
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.collectives import all_reduce_sum, allreduce_slots, in_gang, psum_data
from spark_rapids_ml_tpu_torch.parallel.mesh import ShardedRows
from spark_rapids_ml_tpu_torch.robustness.checkpoint import replicate_state_onto_mesh, segment_boundary
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.utils.tracing import HostSync, TraceColor, TraceRange, bump_counter

Dot = Union[str, Callable]


def _as_dot(dot: Dot) -> Callable:
    return make_dot(dot) if isinstance(dot, str) else dot


class RowShards(NamedTuple):
    """The rows of a fit as data shards: each shard's real rows and row
    weights where they live, the global index of each shard's first row,
    the gang's row count, and the device the centres live on. One tensor
    is one shard at offset 0."""

    x: List[torch.Tensor]
    mask: List[torch.Tensor]
    offsets: List[int]
    n: int
    device: torch.device


def as_row_shards(x: Any, mask: Optional[torch.Tensor] = None, cosine: bool = False) -> RowShards:
    """A tensor (with its mask) or a ``ShardedRows`` as :class:`RowShards`
    (features past the true width dropped); ``cosine`` unit-normalizes a
    ShardedRows' rows, zeroing those of weight 0."""
    if isinstance(x, RowShards):
        return x
    if not isinstance(x, ShardedRows):
        return RowShards([x], [mask], [0], int(x.shape[0]), x.device)
    xs, ms = [], []
    for i in range(len(x.blocks)):
        xi = x.local_rows(i)
        wi = x.local_weights(i)
        mi = torch.ones(xi.shape[0], dtype=xi.dtype, device=xi.device) if wi is None else wi.to(xi.dtype)
        if cosine:
            xi = normalize_rows(xi) * (mi > 0).to(xi.dtype)[:, None]
        xs.append(xi)
        ms.append(mi)
    return RowShards(xs, ms, list(x.offsets), x.n, x.mesh.first_device)


def _split_global(v: torch.Tensor, shards: RowShards) -> List[torch.Tensor]:
    """A vector over the gang's rows in global order, cut into the local
    shards' pieces (on their devices)."""
    return [v[off:off + xi.shape[0]].to(xi.device) for xi, off in zip(shards.x, shards.offsets)]


def _global_index(shards: RowShards, device: torch.device) -> torch.Tensor:
    """The global row index of every local row, in shard order."""
    return torch.cat([torch.arange(off, off + xi.shape[0], device=device)
                      for xi, off in zip(shards.x, shards.offsets)])


def _global_topk(scores: List[torch.Tensor], shards: RowShards, t: int):
    """``(values, global row indices)`` of the ``t`` largest scores over
    every shard of the gang. In one process: ``topk`` of the shards'
    scores joined in global order. In a gang each process offers its own
    top ``t`` and the merged candidates are ranked again."""
    dev = shards.device
    local = scores[0].to(dev) if len(scores) == 1 else torch.cat([sc.to(dev) for sc in scores])
    if not in_gang():
        vals, pos = torch.topk(local, t)
        return vals, pos + shards.offsets[0] if len(scores) == 1 else _global_index(shards, dev)[pos]
    take = min(t, int(local.shape[0]))
    vals = torch.full((t,), -math.inf, dtype=local.dtype, device=dev)
    idx = torch.full((t,), -1, dtype=torch.int64, device=dev)
    if take:
        v, pos = torch.topk(local, take)
        vals[:take] = v
        idx[:take] = _global_index(shards, dev)[pos]
    all_vals = allreduce_slots(vals).reshape(-1)
    all_idx = allreduce_slots(idx).reshape(-1)
    top, pos = torch.topk(all_vals, t)
    return top, all_idx[pos]


def _rows_at(parts: List[torch.Tensor], shards: RowShards, gidx: torch.Tensor) -> torch.Tensor:
    """``parts`` (one tensor per shard, rows first) at global row indices
    ``gidx``, on the centres' device; each row comes from the shard (and
    process) that holds it."""
    dev = shards.device
    if len(parts) == 1 and not in_gang():
        return parts[0][gidx.to(parts[0].device)].to(dev)
    out = torch.zeros((gidx.shape[0],) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype, device=dev)
    for p, off in zip(parts, shards.offsets):
        sel = (gidx >= off) & (gidx < off + p.shape[0])
        if bool(sel.any()):
            out[sel] = p[(gidx[sel] - off).to(p.device)].to(dev)
    return all_reduce_sum(out)


def _sq_dists(x: torch.Tensor, centers: torch.Tensor, x2: torch.Tensor, dot: Callable) -> torch.Tensor:
    """(n, k) squared euclidean distances by the Gram expansion, in place
    on the one (n, k) product (``x2 − 2·xc + c2``, the reference's order)."""
    c2 = torch.sum(centers * centers, dim=1)
    d2 = dot(x, centers.T)
    return d2.mul_(-2.0).add_(x2[:, None]).add_(c2[None, :]).clamp_(min=0.0)


def assign_clusters(x: torch.Tensor, centers: torch.Tensor, precision: str = "highest"):
    """Labels and each row's squared distance to its nearest center."""
    x2 = torch.sum(x * x, dim=1)
    d2 = _sq_dists(x, centers, x2, make_dot(precision))
    labels = torch.argmin(d2, dim=1)
    return labels, torch.gather(d2, 1, labels[:, None])[:, 0]


def assign_clusters_blocked(
    x: torch.Tensor,
    centers: torch.Tensor,
    block_rows: int = 65536,
    precision: str = "highest",
):
    """Row-blocked :func:`assign_clusters`: labels (the first minimum, as
    ``jnp.argmin``) and each row's squared distance to its nearest center,
    with one (block, k) distance matrix at a time."""
    dot = make_dot(precision)
    labels, d2s = [], []
    for i in range(0, max(int(x.shape[0]), 1), block_rows):
        xb = x[i:i + block_rows]
        d2 = _sq_dists(xb, centers, torch.sum(xb * xb, dim=1), dot)
        labels.append(torch.argmin(d2, dim=1))
        d2s.append(torch.amin(d2, dim=1))
        del d2
    return torch.cat(labels), torch.cat(d2s)


def _assign_and_accumulate(xb, mb, x2b, centers, k: int, dot: Callable,
                           stats_dtype: Optional[torch.dtype] = None):
    """One block's assignment and sufficient statistics: (sums (k, d),
    counts (k,), cost). The one-hot carries the row weights.
    ``stats_dtype=torch.float64`` sums each row into its cluster in
    float64 (``index_add_``) instead of the float32 one-hot product."""
    d2 = _sq_dists(xb, centers, x2b, dot)
    labels = torch.argmin(d2, dim=1)
    min_d2 = torch.gather(d2, 1, labels[:, None])[:, 0]
    del d2
    if stats_dtype is not None:
        w = mb.to(stats_dtype)
        sums = torch.zeros((k, xb.shape[1]), dtype=stats_dtype, device=xb.device)
        sums.index_add_(0, labels, xb.to(stats_dtype) * w[:, None])
        counts = torch.zeros((k,), dtype=stats_dtype, device=xb.device).index_add_(0, labels, w)
        return sums, counts, torch.sum(min_d2.to(stats_dtype) * w)
    one_hot = torch.zeros((xb.shape[0], k), dtype=xb.dtype, device=xb.device)
    one_hot.scatter_(1, labels[:, None], mb[:, None].to(xb.dtype))
    sums = dot(one_hot.T, xb)
    counts = torch.sum(one_hot, dim=0)
    cost = torch.sum(min_d2 * mb)
    return sums, counts, cost


def _shard_stats(x, mask, x2, centers, dot: Callable, block_rows: Optional[int],
                 stats_dtype: Optional[torch.dtype] = None):
    """One shard's (sums (k, d), counts (k,), cost); ``block_rows`` walks
    its rows in blocks so only a (block, k) distance matrix exists at a
    time (the last block may be short)."""
    k = centers.shape[0]
    n = x.shape[0]
    if block_rows is None or n <= block_rows:
        return _assign_and_accumulate(x, mask, x2, centers, k, dot, stats_dtype)
    acc = stats_dtype or x.dtype
    sums = torch.zeros((k, x.shape[1]), dtype=acc, device=x.device)
    counts = torch.zeros((k,), dtype=acc, device=x.device)
    cost = torch.zeros((), dtype=acc, device=x.device)
    for i in range(0, n, block_rows):
        j = slice(i, i + block_rows)
        sb, cb, jb = _assign_and_accumulate(x[j], mask[j], x2[j], centers, k, dot, stats_dtype)
        sums, counts, cost = sums + sb, counts + cb, cost + jb
    return sums, counts, cost


def lloyd_iteration_cost(n: int, d: int, k: int) -> dict:
    """The counted work of one Lloyd iteration over ``n`` rows: one
    assignment + statistics pass (``ops/kernels/kmeans.cost``, K2's and
    K3's count, which the plain route shares)."""
    from spark_rapids_ml_tpu_torch.ops.kernels.kmeans import cost

    return cost(n, d, k)


def lloyd_step(x, mask, centers, x2, dot: Dot, cosine: bool = False,
               block_rows: Optional[int] = None, stats_dtype: Optional[torch.dtype] = None):
    """One Lloyd iteration: (new_centers, cost). ``dot`` is a mode name or
    a matmul callable. ``x`` is a tensor (with ``mask`` and ``x2``) or
    :class:`RowShards` (``x2`` then one tensor per shard): each shard's
    statistics are summed over the data axis before the update.
    ``stats_dtype=torch.float64`` sums the statistics and divides in
    float64, so the centres hardly depend on the order of the sums (the
    IVF quantizer's choice: a mesh build then equals a single-device
    build)."""
    dot = _as_dot(dot)
    shards = as_row_shards(x, mask)
    x2s = [x2] if isinstance(x2, torch.Tensor) else x2
    stats = [_shard_stats(xi, mi, x2i, centers.to(xi.device), dot, block_rows, stats_dtype)
             for xi, mi, x2i in zip(shards.x, shards.mask, x2s)]
    sums, counts, cost = (psum_data(list(parts), shards.device) for parts in zip(*stats))
    new_centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers.to(sums.dtype)
    ).to(centers.dtype)
    if cosine:
        new_centers = normalize_rows(new_centers)
    return new_centers, cost


def _auto_block_rows(n: int, k: int, block_rows: Optional[int], data_shards: int = 1) -> int:
    """``block_rows=None``: with ``TPUML_AUTOTUNE=on`` and device memory
    to size from, the tuner's block (unblocked while the (n, k) float32
    temporary fits the measured headroom, else the largest row block
    whose slab does); otherwise the reference's static rule — unblocked
    (``n + 1``) while a device's (n, k) float32 temporary (``n /
    data_shards`` rows) stays under ~9 GB, else blocks of ~1 GB of
    temporaries."""
    if block_rows is not None:
        return block_rows
    from spark_rapids_ml_tpu_torch.observability import autotune as _autotune

    tuner = _autotune.active()
    if tuner is not None:
        tuned = tuner.recommend_kmeans_block_rows(n, k, data_shards)
        if tuned is not None:
            return tuned
    if 4 * n * k // max(data_shards, 1) > 9_000_000_000:
        return max(8, (250_000_000 // max(k, 1) // 8) * 8)
    return n + 1


def moved_above_tol(moved, it: int, tol: float) -> bool:
    """``moved > tol²`` in the state's dtype: one host sync
    (``sync.kmeans.lloyd.moved``) after the first iteration; before it,
    ``moved`` is the host-side ``inf`` the loop starts from."""
    if it == 0:
        return bool(moved > tol * tol)
    with HostSync("kmeans.lloyd.moved"):
        return bool(moved > tol * tol)


def _lloyd_continues(moved, it: int, tol: float, max_iter: int) -> bool:
    """The reference's stopping rule: go on while some center moved more
    than ``tol`` and ``it < max_iter``."""
    return it < max_iter and moved_above_tol(moved, it, tol)


def _lloyd_prep(x: Any, mask: Optional[torch.Tensor], k: int, block_rows: Optional[int]):
    """``(shards, x2, block_rows)``: the rows as :class:`RowShards`, each
    shard's squared row norms, and the resolved block size; computed once
    and shared by every segment."""
    shards = as_row_shards(x, mask)
    block_rows = _auto_block_rows(shards.n, k, block_rows, len(shards.x))
    return shards, [torch.sum(xi * xi, dim=1) for xi in shards.x], block_rows


def _lloyd_segment(shards: RowShards, x2, centers, moved, it: int, cost, tol: float, max_iter: int,
                   every: int, dot: Callable, cosine: bool, block_rows: int,
                   stats_dtype: Optional[torch.dtype] = None):
    """Up to ``every`` Lloyd iterations from an explicit state ``(centers,
    moved, it, cost)``: :func:`lloyd`'s loop body and stopping rule with a
    segment budget, so a run of segments issues the monolithic loop's
    launches in the same order."""
    seg = 0
    while seg < every and _lloyd_continues(moved, it, tol, max_iter):
        new_centers, cost = lloyd_step(shards, None, centers, x2, dot, cosine=cosine, block_rows=block_rows,
                                       stats_dtype=stats_dtype)
        moved = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        centers = new_centers
        it += 1
        seg += 1
    return centers, moved, it, cost


def _lloyd_final_cost(shards: RowShards, x2, centers, dot: Callable, cosine: bool, block_rows: int,
                      stats_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The cost at the converged centers that :func:`lloyd` ends with."""
    return lloyd_step(shards, None, centers, x2, dot, cosine=cosine, block_rows=block_rows,
                      stats_dtype=stats_dtype)[1]


def _lloyd_init_state(centers: torch.Tensor, device: torch.device) -> tuple:
    """The state before the first iteration: (centers, moved = inf, 0, cost 0)."""
    return (centers.to(device), torch.tensor(math.inf, dtype=centers.dtype), 0,
            torch.zeros((), dtype=centers.dtype, device=device))


def lloyd(
    x: Any,
    mask: Optional[torch.Tensor],
    init_centers: torch.Tensor,
    max_iter: int = 20,
    tol: float = 1e-4,
    precision: str = "highest",
    cosine: bool = False,
    block_rows: Optional[int] = None,
    stats_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full Lloyd fit: (centers, cost, n_iter). Stops when no center moves
    more than ``tol`` (euclidean) or at ``max_iter``, then evaluates the
    cost once more at the converged centers. With ``cosine`` the centers
    stay unit-normalized (rows must already be). ``x`` is a tensor with
    its ``mask``, or :class:`RowShards` / a ``ShardedRows`` over a mesh.
    ``stats_dtype``: :func:`lloyd_step`'s."""
    dot = make_dot(precision)
    shards, x2, block_rows = _lloyd_prep(x, mask, init_centers.shape[0], block_rows)
    centers, moved, it, cost = _lloyd_init_state(init_centers, shards.device)
    centers, _, it, _ = _lloyd_segment(shards, x2, centers, moved, it, cost, tol, max_iter, max_iter,
                                       dot, cosine, block_rows, stats_dtype)
    return centers, _lloyd_final_cost(shards, x2, centers, dot, cosine, block_rows, stats_dtype), it


def lloyd_resumable(
    x: Any,
    mask: Optional[torch.Tensor],
    init_centers: torch.Tensor,
    checkpointer,
    max_iter: int = 20,
    tol: float = 1e-4,
    precision: str = "highest",
    cosine: bool = False,
    block_rows: Optional[int] = None,
    stats_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Preemption-tolerant :func:`lloyd`: a host loop of segments of
    ``checkpointer.every`` iterations, the state ``(centers, moved, it,
    cost)`` snapshotted after each, and the fit resumed mid-solve from the
    newest valid snapshot. The same returns, bitwise, on one device or
    over a mesh (``x`` as there; ``mesh`` places a restored state)."""
    dot = make_dot(precision)
    shards, x2, block_rows = _lloyd_prep(x, mask, init_centers.shape[0], block_rows)
    centers, moved, it, cost = _lloyd_init_state(init_centers, shards.device)
    state = (centers, moved, np.int64(it), cost)
    restored = checkpointer.restore_latest(template=state)
    if restored is not None:
        _, state = restored
        if mesh is not None:
            state = replicate_state_onto_mesh(state, mesh)
    centers, moved, it, cost = state[0], state[1], int(state[2]), state[3]
    k, d = int(centers.shape[0]), int(centers.shape[1])
    while _lloyd_continues(moved, it, tol, max_iter):
        with TraceRange("segment kmeans.lloyd", TraceColor.PURPLE):
            fault_point("solver.segment")
            start = it
            centers, moved, it, cost = ledgered_call(
                _lloyd_segment, (shards, x2, centers, moved, it, cost, tol),
                static=dict(max_iter=max_iter, every=checkpointer.every, dot=dot, cosine=cosine,
                            block_rows=block_rows, stats_dtype=stats_dtype),
                name="kmeans.lloyd.segment", cost=lambda: lloyd_iteration_cost(shards.n, d, k),
            )
            bump_counter("checkpoint.segments")
            bump_counter("checkpoint.solver_iters", it - start)
        checkpointer.save_async(it, (centers, moved, np.int64(it), cost))
        segment_boundary(checkpointer)
    final_cost = _lloyd_final_cost(shards, x2, centers, dot, cosine, block_rows, stats_dtype)
    checkpointer.finalize_success()
    return centers, final_cost, it


def block_suff_stats(xb: torch.Tensor, centers: torch.Tensor, precision: str = "highest"):
    """Lloyd sufficient statistics of one full (unweighted) row block
    against fixed centers: (sums (k, d), counts (k,), cost)."""
    x2 = torch.sum(xb * xb, dim=1)
    mb = torch.ones(xb.shape[0], dtype=xb.dtype, device=xb.device)
    return _assign_and_accumulate(xb, mb, x2, centers, centers.shape[0], make_dot(precision))


def reservoir_sample_rows(blocks: Iterable[Any], cap: int, seed: int, dtype=None):
    """One-pass uniform row reservoir (Algorithm R, vectorized per block):
    ``(sample (min(cap, n), d), n_seen)``. The unbiased seeding set of the
    streaming fit, without materializing the data."""
    rng = np.random.default_rng(seed)
    buf = None
    seen = 0
    for blk in blocks:
        b = _block_to_dense(blk, dtype=dtype)
        if b.shape[0] == 0:
            continue
        if buf is None:
            buf = np.empty((cap, b.shape[1]), dtype=b.dtype)
        i = 0
        # Fill: the first `cap` rows enter directly.
        if seen < cap:
            take = min(cap - seen, b.shape[0])
            buf[seen : seen + take] = b[:take]
            seen += take
            i = take
        # Replace: global row t takes slot j ~ U[0, t] when j < cap.
        nb = b.shape[0] - i
        if nb > 0:
            t = seen + np.arange(nb)
            js = rng.integers(0, t + 1)
            hit = js < cap
            # Later rows drawn into one slot win, in stream order.
            buf[js[hit]] = b[i:][hit]
            seen += nb
    if buf is None:
        raise ValueError("streaming source yielded no rows")
    return buf[: min(cap, seen)], seen


def lloyd_streaming(
    blocks_factory: Callable[[], Iterable[Any]],
    init_centers: torch.Tensor,
    max_iter: int = 20,
    tol: float = 1e-4,
    precision: str = "highest",
    cosine: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Lloyd over a re-iterable block source at constant memory: one pass
    per iteration, each host block going to the centers' device one ahead
    of its use (``prefetch_blocks``) in ``dtype`` (default the centers'),
    its :func:`block_suff_stats` summed there ((k, d) state). The update,
    the movement stop and the final cost at the converged centers are
    :func:`lloyd`'s: empty clusters keep their center."""
    centers = init_centers
    k, d = centers.shape
    dtype = dtype or centers.dtype
    device = centers.device

    def upload(blk):
        host, xb = upload_block(blk, device, dtype)
        if host.shape[0] == 0:
            return None
        return normalize_rows(xb) if cosine else xb

    def one_pass(cs):
        fault_point("solver.segment")
        sums = torch.zeros((k, d), dtype=cs.dtype, device=device)
        counts = torch.zeros((k,), dtype=cs.dtype, device=device)
        cost = torch.zeros((), dtype=cs.dtype, device=device)
        for xb in prefetch_blocks(blocks_factory(), upload):
            if xb is not None:
                sb, cb, jb = block_suff_stats(xb, cs, precision=precision)
                sums, counts, cost = sums + sb, counts + cb, cost + jb
        return sums, counts, cost

    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        sums, counts, _ = one_pass(centers)
        new_centers = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers
        )
        if cosine:
            new_centers = normalize_rows(new_centers)
        moved = float(torch.max(torch.sum((new_centers - centers) ** 2, dim=1)))
        centers = new_centers
        if moved <= tol * tol:
            break
    _, _, cost = one_pass(centers)
    return centers, cost, n_iter


def _gumbel(n: int, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise, ``−log(−log U)`` with U uniform on (0, 1)."""
    u = torch.rand(n, generator=generator, dtype=like.dtype, device=like.device)
    u.clamp_(min=torch.finfo(like.dtype).tiny)
    return -torch.log(-torch.log(u))


def _shard_gumbel(shards: RowShards, generator: torch.Generator) -> List[torch.Tensor]:
    """Gumbel noise for the gang's rows in global order, drawn from the one
    generator on the centres' device and cut into the local shards."""
    like = torch.empty((), dtype=shards.x[0].dtype, device=shards.device)
    g = _gumbel(shards.n, like, generator)
    return _split_global(g, shards) if len(shards.x) > 1 or in_gang() else [g]


def seed_candidates(k: int, n: int) -> int:
    """Candidates a greedy k-means++ step draws: ``2 + ceil(log2 k)``, at
    most the ``n`` rows."""
    return min(2 + max(int(math.ceil(math.log2(k))), 0), n)


def seeding_on_k5(shards: RowShards, k: int, precision: str) -> bool:
    """True when :func:`kmeans_plusplus_init` seeds on kernel K5 (``ops/
    kernels/kmeans.py`` :func:`seed_plusplus`): the rows are one float32
    CUDA shard outside a gang, the products IEEE (``highest``), and K5
    takes the width and the step's candidates (``seed_feasible``). Every
    other input (the CPU, float64, a mesh's row shards, a gang) seeds on
    the torch loop, :func:`kmeans_plusplus_loop`: the same draws, run as
    plain torch.

    The two choose the same rows while each step finds its t candidates
    among rows of nonzero weight off the chosen centres. Past that (k
    above the distinct rows of nonzero weight) they may part: K5's D² of
    a copy of a chosen centre is 0, so it fills the short slots with the
    first centre's row, where the loop's expansion x² − 2x·c + c² can
    leave such a copy a rounding residue and draw it, or keep a row of
    weight 0 in a slot no finite score filled. So a mesh fit of such rows
    may seed other repeated centres than the single-device fit."""
    from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kernels  # imports this module

    x = shards.x[0]
    return (len(shards.x) == 1 and not in_gang() and x.is_cuda and x.dtype == torch.float32
            and precision == "highest"
            and kernels.seed_feasible(int(x.shape[1]), seed_candidates(k, shards.n)))


def kmeans_plusplus_init(
    x: Any,
    mask: Optional[torch.Tensor],
    generator: torch.Generator,
    k: int,
    precision: str = "highest",
) -> torch.Tensor:
    """Greedy k-means++ seeding on the device.

    D² sampling with the greedy refinement: each step draws ``2 +
    ceil(log2 k)`` candidate rows with probability ∝ weight·D² (Gumbel-
    top-t) and keeps the one that minimizes the resulting potential. Rows
    of weight 0 are never chosen and add nothing to the potential. ``x``
    is a tensor with its ``mask``, or row shards (the draws are those of
    the single-device seeding of the same rows).

    Two routes, one algorithm with the same draws (:func:`seeding_on_k5`
    picks by the input, and says where their choices may part): on kernel
    K5 each step is two launches with the chosen row kept on the device,
    and the seeding makes no host sync; on the torch loop
    (:func:`kmeans_plusplus_loop`) it makes 1 + 2·(k − 1)."""
    shards = as_row_shards(x, mask)
    if seeding_on_k5(shards, k, precision):
        from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kernels  # imports this module

        return kernels.seed_plusplus(shards.x[0], shards.mask[0], generator, k)
    return kmeans_plusplus_loop(shards, None, generator, k, precision)


def kmeans_plusplus_loop(
    x: Any,
    mask: Optional[torch.Tensor],
    generator: torch.Generator,
    k: int,
    precision: str = "highest",
) -> torch.Tensor:
    """:func:`kmeans_plusplus_init` as plain torch, a dozen passes a step
    (K5's plain version, and the route of the CPU, float64, meshes and
    gangs).

    On one device it makes one host sync (``sync.kmeans.seeding.neg_inf``,
    a scalar copied to the device) and then two a step, both implicit:
    ``xc[best]`` and ``d2c[best]`` index by the 0-dim device tensor
    ``best``, which torch reads back to the host (``.item()``) to select
    the row (``sync.kmeans.seeding.pick``, ``sync.kmeans.seeding.min_d2``)."""
    dot = make_dot(precision)
    shards = as_row_shards(x, mask)
    dev = shards.device
    d = shards.x[0].shape[1]
    dtype = shards.x[0].dtype
    t = seed_candidates(k, shards.n)
    x2 = [torch.sum(xi * xi, dim=1) for xi in shards.x]
    with HostSync("kmeans.seeding.neg_inf"):
        neg_inf = [torch.tensor(-math.inf, dtype=dtype, device=xi.device) for xi in shards.x]
    g0 = _shard_gumbel(shards, generator)
    scores = [torch.where(mi > 0, gi, ni) for mi, gi, ni in zip(shards.mask, g0, neg_inf)]
    first = _global_topk(scores, shards, 1)[1][0]
    centers = torch.zeros((k, d), dtype=dtype, device=dev)
    x_first = _rows_at(shards.x, shards, first.reshape(1))[0]
    x2_first = _rows_at(x2, shards, first.reshape(1))[0]
    centers[0] = x_first
    min_d2 = [torch.clamp(x2i - 2.0 * dot(xi, x_first.to(xi.device)) + x2_first.to(xi.device), min=0.0)
              for xi, x2i in zip(shards.x, x2)]
    for i in range(1, k):
        logw = [torch.where((mi > 0) & (md > 0), torch.log(mi * md), ni)
                for mi, md, ni in zip(shards.mask, min_d2, neg_inf)]
        g = _shard_gumbel(shards, generator)
        top, cand = _global_topk([lw + gi for lw, gi in zip(logw, g)], shards, t)
        # All-zero residual (duplicate data): take the first row.
        degenerate = ~torch.isfinite(top[0])
        cand = torch.where(degenerate, first, cand)
        xc = _rows_at(shards.x, shards, cand)
        c2 = torch.sum(xc * xc, dim=1)
        pots, d2cs = [], []
        for xi, x2i, mi, md in zip(shards.x, x2, shards.mask, min_d2):
            d2c = torch.clamp(
                x2i[None, :] - 2.0 * dot(xc.to(xi.device), xi.T) + c2.to(xi.device)[:, None], min=0.0
            )
            pots.append(torch.sum(torch.minimum(md[None, :], d2c) * mi[None, :], dim=1, dtype=torch.float64))
            d2cs.append(d2c)
        best = torch.argmin(psum_data(pots, dev))
        with HostSync("kmeans.seeding.pick"):
            centers[i] = xc[best]
        with HostSync("kmeans.seeding.min_d2"):
            min_d2 = [torch.minimum(md, d2c[best.to(d2c.device)]) for md, d2c in zip(min_d2, d2cs)]
    return centers


def random_init(x: Any, mask: Optional[torch.Tensor], generator: torch.Generator, k: int) -> torch.Tensor:
    """Random seeding: k distinct rows of nonzero weight, by Gumbel scores
    and an exact top-k over every shard."""
    shards = as_row_shards(x, mask)
    g = _shard_gumbel(shards, generator)
    with HostSync("kmeans.seeding.neg_inf"):
        scores = [torch.where(mi > 0, gi, torch.tensor(-math.inf, dtype=gi.dtype, device=gi.device))
                  for mi, gi in zip(shards.mask, g)]
    return _rows_at(shards.x, shards, _global_topk(scores, shards, k)[1])


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize rows: cosine distance is euclidean on normalized data."""
    norms = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.clamp(norms, min=eps)
