"""UMAP ops in PyTorch — port of the reference's ``ops/umap.py``.

The fuzzy simplicial set and the synchronous-epoch layout SGD, each the
reference's math: the smooth-kNN bandwidths by a vectorised bracket
expansion (48 doublings) and 64 bisection steps over all points at once;
the symmetrised memberships through the (n, k, k) reverse lookup; every
epoch applies all E = n·k attractive edge gradients and one draw of
negatives with a linearly annealed step.

Random numbers: :func:`optimize_layout` draws each epoch's uniform
negative indices — the shared pool (``neg_pool > 0``, (neg_pool,)) or
the per-edge draws (``neg_pool = 0``, (n·k, neg_rate)) — from a
``torch.Generator`` and hands them to the epoch function
(:func:`_make_epoch_fn`) as an argument. JAX's threefry bits cannot be
reproduced here, so a test feeds the epoch the indices JAX drew instead.

The tail side of the attraction (a scatter over random tails) goes
through kernel K4 (:mod:`ops.kernels.umap`) when a tail plan is given,
else through ``index_add_``.

Over a mesh (:func:`optimize_layout_sharded`, fit mode) the edges shard
by head row over the data axis, padded head rows at weight 0. Each shard
accumulates its tail scatter (``index_add_``; K4 stays off a mesh, as the
reference keeps its tail kernel off one) and its head block into a local
(n, dim) delta where it lives; the deltas are summed once an epoch by
``psum_data`` and every position applies the same update. The pooled
negatives are drawn as :func:`optimize_layout` draws them, so the mesh
layout equals the single-device one up to the order of its sums; the
per-edge mode draws per shard, from one generator per shard seeded from
the fit's seed and the shard's global index (the reference folds its key
with the shard index). In a gang every process passes the whole graph and
layout and draws the same pool (the reference's contract, not checked);
each builds the head shards of its own global positions
(``parallel.mesh.data_positions``), the epoch's one ``psum_data`` crosses
the gang, and every rank holds the same layout.

:func:`optimize_layout_resumable` is the checkpointed layout: it and
:func:`optimize_layout` run the same :func:`_layout_segment`, and its
snapshot carries the generator's state, so a resumed layout equals the
uninterrupted one bitwise.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.device import seeded_generator
from spark_rapids_ml_tpu_torch.observability.costs import ledgered_call
from spark_rapids_ml_tpu_torch.ops.kernels.umap import TailPlan, tail_accumulate
from spark_rapids_ml_tpu_torch.ops.kernels.umap import cost as tail_cost
from spark_rapids_ml_tpu_torch.parallel.collectives import psum_data
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, data_positions
from spark_rapids_ml_tpu_torch.robustness.checkpoint import segment_boundary
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter


class FuzzyGraph(NamedTuple):
    """Directed kNN edge list with symmetrised membership weights:
    ``weight[i, j]`` is the t-conorm w_ij + w_ji − w_ij·w_ji, halved for
    mutual edges (which appear in both endpoints' lists)."""

    indices: torch.Tensor  # (n, k) int32 neighbour ids
    weight: torch.Tensor   # (n, k) float32 symmetrised membership
    sigmas: torch.Tensor   # (n,) smooth-kNN bandwidths
    rhos: torch.Tensor     # (n,) distance to the nearest neighbour


def smooth_knn_dist(knn_dists: torch.Tensor, k: float, n_iter: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point bandwidth sigma and offset rho: solves
    Σ_j exp(−max(d_ij − ρ_i, 0)/σ_i) = log2(k) for every point by bracket
    expansion and bisection, with umap-learn's floor σ ≥ 1e-3 · mean d."""
    target = math.log2(k)
    pos = torch.where(knn_dists > 0, knn_dists, torch.full_like(knn_dists, math.inf))
    rho = torch.min(pos, dim=1).values
    rho = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))
    shifted = torch.clamp_min(knn_dists - rho[:, None], 0.0)

    def psum(sigma):
        return torch.sum(torch.exp(-shifted / sigma[:, None]), dim=1)

    n = knn_dists.shape[0]
    lo = torch.full((n,), 1e-12, dtype=knn_dists.dtype, device=knn_dists.device)
    hi = torch.full((n,), 1.0, dtype=knn_dists.dtype, device=knn_dists.device)
    for _ in range(48):  # 2^48 spans any float32 scale
        hi = torch.where(psum(hi) < target, hi * 2.0, hi)
    for _ in range(n_iter):
        mid = (lo + hi) / 2.0
        too_high = psum(mid) > target  # the sum falls as sigma shrinks
        lo, hi = torch.where(too_high, lo, mid), torch.where(too_high, mid, hi)
    sigma = (lo + hi) / 2.0
    mean_d = torch.mean(knn_dists)
    return torch.maximum(sigma, 1e-3 * mean_d), rho


def fuzzy_simplicial_set(knn_idx: torch.Tensor, knn_dists: torch.Tensor) -> FuzzyGraph:
    """Memberships and their symmetrisation over the directed kNN edges;
    the reverse weight w_ji is found by scanning j's list for i (an
    (n, k, k) compare), absent reverse edges contribute 0."""
    n, k = knn_idx.shape
    sigmas, rhos = smooth_knn_dist(knn_dists, float(k))
    w = torch.exp(-torch.clamp_min(knn_dists - rhos[:, None], 0.0) / sigmas[:, None])
    rows_j = knn_idx.long()
    src = torch.arange(n, dtype=rows_j.dtype, device=rows_j.device)[:, None, None]
    match = rows_j[rows_j] == src  # (n, k, k)
    w_ji = torch.sum(torch.where(match, w[rows_j], torch.zeros((), dtype=w.dtype, device=w.device)), dim=2)
    mutual = torch.any(match, dim=2)
    w_sym = w + w_ji - w * w_ji
    w_sym = torch.where(mutual, 0.5 * w_sym, w_sym)
    return FuzzyGraph(knn_idx.to(torch.int32), w_sym.to(torch.float32), sigmas, rhos)


def find_ab_params(spread: float, min_dist: float) -> Tuple[float, float]:
    """Fit 1/(1 + a·d^2b) to the (min_dist, spread) offset exponential by
    least squares, as umap-learn does (scipy ``curve_fit``, on the host)."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=[1.0, 1.0], maxfev=10000)
    return float(a), float(b)


def negative_shape(n: int, k: int, neg_rate: int, neg_pool: int) -> Tuple[int, ...]:
    """Shape of one epoch's negative indices: the pool, or one row of
    ``neg_rate`` draws per edge."""
    return (neg_pool,) if neg_pool > 0 else (n * k, neg_rate)


def _tail_index_add(tail_g: torch.Tensor, dst_flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The tail accumulation's plain route: ``index_add_`` into zeros."""
    return torch.zeros_like(like).index_add_(0, dst_flat, tail_g)


def layout_epoch_cost(n: int, e: int, dim: int, neg_rate: int, neg_pool: int) -> dict:
    """The counted work of one layout epoch over ``e`` edges: the
    attraction (4·dim operations and one power per edge), the repulsion
    (per edge and negative sample, or the pool's two (n, s, dim) products),
    and the tail accumulation (``ops/kernels/umap.cost``, K4's count); the
    layout read and written, the edges' targets and weights read once."""
    if neg_pool > 0:
        rep_flops, rep_pows = 4.0 * n * neg_pool * dim, n * neg_pool
    else:
        rep_flops, rep_pows = 4.0 * e * neg_rate * dim, e * neg_rate
    tail = tail_cost(n, e, dim)
    return {"flops": 4.0 * e * dim + rep_flops + tail["flops"], "transcendentals": float(e + rep_pows),
            "bytes_accessed": float(2 * 4 * n * dim + 12 * e) + tail["bytes_accessed"]}


def _make_epoch_fn(
    shape, graph: FuzzyGraph, target: Optional[torch.Tensor],
    *, n_epochs: int, neg_rate: int, neg_pool: int, learning_rate: float,
    repulsion: float, a: float, b: float, move_other: bool,
    tail_plan: Optional[TailPlan] = None,
) -> Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor]:
    """One epoch of the synchronous layout SGD: ``epoch(ep, y, neg_idx)``
    returns the next layout. ``neg_idx`` holds the epoch's negative draws
    (:func:`negative_shape`). ``target`` (transform mode) is a fixed point
    set the edges attract to, with ``move_other=False``. The tail update
    runs on K4 when ``tail_plan`` is given, else through ``index_add_``."""
    n, dim = shape
    k = graph.indices.shape[1]
    dst = graph.indices.long()  # (n, k)
    dst_flat = dst.reshape(-1)
    w = graph.weight
    w_sum = torch.sum(w, dim=1)  # (n,)
    cap = 4.0 * k * neg_rate / neg_pool if neg_pool > 0 else None
    move_tail = move_other and target is None

    def epoch(ep: int, y: torch.Tensor, neg_idx: torch.Tensor) -> torch.Tensor:
        alpha = learning_rate * (1.0 - float(ep) / n_epochs)
        ref_y = y if target is None else target
        diff = y[:, None, :] - ref_y[dst]  # (n, k, dim)
        d2 = torch.sum(diff * diff, dim=2)
        att = (-2.0 * a * b * torch.pow(torch.clamp_min(d2, 1e-12), b - 1.0)) / (1.0 + a * torch.pow(d2, b))
        g_att = torch.clamp((att * w)[:, :, None] * diff, -4.0, 4.0)  # (n, k, dim)

        if neg_pool > 0:
            # One shared pool: repulsion is dense (n, s) algebra, the
            # gradient factorised as rowsum(c)·y − c @ pool.
            pool = ref_y[neg_idx]  # (s, dim)
            y2 = torch.sum(y * y, dim=1)
            p2 = torch.sum(pool * pool, dim=1)
            cross = y @ pool.T
            d2n = torch.clamp_min(y2[:, None] + p2[None, :] - 2.0 * cross, 0.0)
            rep = (2.0 * repulsion * b) / ((0.001 + d2n) * (1.0 + a * torch.pow(d2n, b)))
            c = rep * (w_sum[:, None] * (neg_rate / neg_pool))
            c = torch.minimum(c, cap / torch.sqrt(d2n + 1e-12))
            g_rep_head = torch.sum(c, dim=1, keepdim=True) * y - c @ pool
            grad_head = torch.sum(g_att, dim=1) + g_rep_head
        else:
            yn = ref_y[neg_idx.reshape(n, k, neg_rate)]  # (n, k, m, dim)
            diff_n = y[:, None, None, :] - yn
            d2n = torch.sum(diff_n * diff_n, dim=3)
            rep = (2.0 * repulsion * b) / ((0.001 + d2n) * (1.0 + a * torch.pow(d2n, b)))
            g_rep = torch.clamp((rep * w[:, :, None])[:, :, :, None] * diff_n, -4.0, 4.0)
            grad_head = torch.sum(g_att + torch.sum(g_rep, dim=2), dim=1)

        delta = alpha * grad_head
        if move_tail:
            tail_g = (-alpha * g_att).reshape(-1, dim)
            count = lambda: tail_cost(n, int(tail_g.shape[0]), dim)  # noqa: E731
            if tail_plan is not None:
                delta = delta + ledgered_call(tail_accumulate, (tail_g, tail_plan), static={},
                                              name="umap.tail", cost=count)
            else:
                delta = delta + ledgered_call(_tail_index_add, (tail_g, dst_flat, y), static={},
                                              name="umap.tail", cost=count)
        return y + delta

    return epoch


def _layout_segment(epoch: Callable, y: torch.Tensor, gen: torch.Generator, ep_start: int, ep_stop: int,
                    shape: Tuple[int, ...], n_ref: int,
                    negatives: Optional[Callable[[int], torch.Tensor]] = None) -> torch.Tensor:
    """Epochs [ep_start, ep_stop) of :func:`optimize_layout` from an
    explicit layout, each with its negatives drawn from ``gen`` (or given
    by ``negatives(ep)``): the one loop the monolithic and the segmented
    layouts share, so both issue the same launches and draws."""
    for ep in range(ep_start, ep_stop):
        neg = (negatives(ep) if negatives is not None
               else torch.randint(0, n_ref, shape, generator=gen, device=y.device))
        y = epoch(ep, y, neg)
    return y


def optimize_layout(
    embedding: torch.Tensor,
    graph: FuzzyGraph,
    gen: torch.Generator,
    *,
    n_epochs: int,
    neg_rate: int = 5,
    neg_pool: int = 256,
    learning_rate: float = 1.0,
    repulsion: float = 1.0,
    a: float = 1.577,
    b: float = 0.895,
    move_other: bool = True,
    target: Optional[torch.Tensor] = None,
    tail_plan: Optional[TailPlan] = None,
) -> torch.Tensor:
    """Synchronous-epoch UMAP layout optimisation from ``embedding``
    (n, dim): ``n_epochs`` epochs of :func:`_make_epoch_fn`, each with
    negatives drawn from ``gen``. No host sync inside the loop."""
    n, dim = embedding.shape
    epoch = _make_epoch_fn(
        (n, dim), graph, target,
        n_epochs=n_epochs, neg_rate=neg_rate, neg_pool=neg_pool,
        learning_rate=learning_rate, repulsion=repulsion, a=a, b=b,
        move_other=move_other, tail_plan=tail_plan,
    )
    n_ref = n if target is None else int(target.shape[0])
    shape = negative_shape(n, int(graph.indices.shape[1]), neg_rate, neg_pool)
    return _layout_segment(epoch, embedding, gen, 0, n_epochs, shape, n_ref)


def optimize_layout_resumable(
    embedding: torch.Tensor,
    graph: FuzzyGraph,
    gen: torch.Generator,
    checkpointer,
    *,
    n_epochs: int,
    neg_rate: int = 5,
    neg_pool: int = 256,
    learning_rate: float = 1.0,
    repulsion: float = 1.0,
    a: float = 1.577,
    b: float = 0.895,
    move_other: bool = True,
    target: Optional[torch.Tensor] = None,
    tail_plan: Optional[TailPlan] = None,
    negatives: Optional[Callable[[int], torch.Tensor]] = None,
) -> torch.Tensor:
    """Preemption-tolerant :func:`optimize_layout`: ``checkpointer.every``
    epochs a segment, the state ``(layout, generator state, epoch)``
    snapshotted after each, resumed mid-schedule from the newest valid
    snapshot. The generator's state (a CUDA generator's Philox seed and
    offset) rides the snapshot, so the resumed epochs draw what the
    uninterrupted fit drew, and the layout equals it bitwise. The same
    ``tail_plan`` as the monolithic fit routes every epoch's tail through
    K4. ``negatives(ep)``, when given, supplies each epoch's draws instead
    (tests pass JAX's)."""
    n, dim = embedding.shape
    epoch = _make_epoch_fn(
        (n, dim), graph, target,
        n_epochs=n_epochs, neg_rate=neg_rate, neg_pool=neg_pool,
        learning_rate=learning_rate, repulsion=repulsion, a=a, b=b,
        move_other=move_other, tail_plan=tail_plan,
    )
    n_ref = n if target is None else int(target.shape[0])
    shape = negative_shape(n, int(graph.indices.shape[1]), neg_rate, neg_pool)
    y, ep = embedding, 0
    restored = checkpointer.restore_latest(template=(y, gen.get_state(), np.int64(0)))
    if restored is not None:
        _, (y, gen_state, ep) = restored
        gen.set_state(gen_state)
        ep = int(ep)
    while ep < n_epochs:
        stop = min(ep + checkpointer.every, n_epochs)
        with TraceRange("segment umap.layout", TraceColor.PURPLE):
            fault_point("solver.segment")
            y = ledgered_call(
                _layout_segment, (epoch, y, gen, ep, stop, shape, n_ref, negatives), static={},
                name="umap.layout.segment",
                cost=lambda: layout_epoch_cost(n, n * int(graph.indices.shape[1]), dim, neg_rate, neg_pool),
            )
            bump_counter("checkpoint.segments")
            bump_counter("checkpoint.solver_iters", stop - ep)
        ep = stop
        checkpointer.save_async(stop, (y, gen.get_state(), np.int64(stop)))
        segment_boundary(checkpointer)
    checkpointer.finalize_success()
    return y


class _HeadShard(NamedTuple):
    """One data shard's edges: its head rows [row0, row0 + rows) of the
    padded layout, their tails and weights (padded rows weigh 0)."""

    device: torch.device
    row0: int
    dst: torch.Tensor     # (rows, k) int64
    w: torch.Tensor       # (rows, k)
    w_sum: torch.Tensor   # (rows,)


def _head_shards(mesh, graph: FuzzyGraph) -> Tuple[List[_HeadShard], int]:
    """The graph's edges split by head row over the global data axis, the
    shards of this process's positions each on its first device:
    (shards, padded row count)."""
    grid = mesh.grid
    dp = int(mesh.shape[DATA_AXIS])
    n, k = graph.indices.shape
    rows = -(-int(n) // dp)
    shards = []
    for i, g in enumerate(data_positions(mesh)):
        dev = grid[i, 0]
        row0 = g * rows
        dst = graph.indices[row0:row0 + rows].long().to(dev)
        w = graph.weight[row0:row0 + rows].to(dev)
        pad = rows - int(dst.shape[0])
        if pad:
            dst = torch.cat([dst, torch.zeros((pad, k), dtype=dst.dtype, device=dev)])
            w = torch.cat([w, torch.zeros((pad, k), dtype=w.dtype, device=dev)])
        shards.append(_HeadShard(dev, row0, dst, w, torch.sum(w, dim=1)))
    return shards, rows * dp


def _make_sharded_epoch_fn(
    mesh, graph: FuzzyGraph,
    *, n_epochs: int, neg_rate: int, neg_pool: int, learning_rate: float,
    repulsion: float, a: float, b: float,
) -> Tuple[Callable, int]:
    """One epoch of the mesh layout SGD (fit mode): ``epoch(ep, y_pad,
    neg)`` returns the next padded layout. ``y_pad`` is the (n_pad, dim)
    layout on the mesh's first device (rows past n are 0 and stay 0);
    ``neg`` is the epoch's pool (neg_pool,) in pooled mode, else one
    (rows · k, neg_rate) draw per local shard. Returns (epoch, n_pad)."""
    shards, n_pad = _head_shards(mesh, graph)
    k = int(graph.indices.shape[1])
    first = mesh.first_device
    cap = 4.0 * k * neg_rate / neg_pool if neg_pool > 0 else None

    def shard_delta(i: int, sh: _HeadShard, alpha: float, y: torch.Tensor, neg) -> torch.Tensor:
        rows = int(sh.dst.shape[0])
        dim = int(y.shape[1])
        yh = y[sh.row0:sh.row0 + rows]  # (rows, dim): the head block is a slice
        diff = yh[:, None, :] - y[sh.dst]  # (rows, k, dim)
        d2 = torch.sum(diff * diff, dim=2)
        att = (-2.0 * a * b * torch.pow(torch.clamp_min(d2, 1e-12), b - 1.0)) / (1.0 + a * torch.pow(d2, b))
        g_att = torch.clamp((att * sh.w)[:, :, None] * diff, -4.0, 4.0)
        if neg_pool > 0:
            pool = y[neg.to(sh.device)]  # (s, dim)
            yh2 = torch.sum(yh * yh, dim=1)
            p2 = torch.sum(pool * pool, dim=1)
            d2n = torch.clamp_min(yh2[:, None] + p2[None, :] - 2.0 * (yh @ pool.T), 0.0)
            rep = (2.0 * repulsion * b) / ((0.001 + d2n) * (1.0 + a * torch.pow(d2n, b)))
            c = rep * (sh.w_sum[:, None] * (neg_rate / neg_pool))
            c = torch.minimum(c, cap / torch.sqrt(d2n + 1e-12))
            grad_head = torch.sum(g_att, dim=1) + (torch.sum(c, dim=1, keepdim=True) * yh - c @ pool)
        else:
            yn = y[neg[i].to(sh.device).reshape(rows, k, neg_rate)]  # (rows, k, m, dim)
            diff_n = yh[:, None, None, :] - yn
            d2n = torch.sum(diff_n * diff_n, dim=3)
            rep = (2.0 * repulsion * b) / ((0.001 + d2n) * (1.0 + a * torch.pow(d2n, b)))
            g_rep = torch.clamp((rep * sh.w[:, :, None])[:, :, :, None] * diff_n, -4.0, 4.0)
            grad_head = torch.sum(g_att + torch.sum(g_rep, dim=2), dim=1)
        delta = torch.zeros((n_pad, dim), dtype=y.dtype, device=sh.device)
        delta.index_add_(0, sh.dst.reshape(-1), (-alpha * g_att).reshape(-1, dim))
        delta[sh.row0:sh.row0 + rows] += alpha * grad_head
        return delta

    def epoch(ep: int, y_pad: torch.Tensor, neg) -> torch.Tensor:
        alpha = learning_rate * (1.0 - float(ep) / n_epochs)
        copies = {first: y_pad}
        deltas = []
        for i, sh in enumerate(shards):
            if sh.device not in copies:
                copies[sh.device] = y_pad.to(sh.device)
            deltas.append(shard_delta(i, sh, alpha, copies[sh.device], neg))
        # One collective an epoch: every position applies the same update.
        return y_pad + psum_data(deltas, first)

    return epoch, n_pad


def optimize_layout_sharded(
    mesh,
    embedding: torch.Tensor,
    graph: FuzzyGraph,
    gen: torch.Generator,
    *,
    n_epochs: int,
    neg_rate: int = 5,
    neg_pool: int = 256,
    learning_rate: float = 1.0,
    repulsion: float = 1.0,
    a: float = 1.577,
    b: float = 0.895,
    seed: int = 0,
) -> torch.Tensor:
    """The synchronous-epoch layout SGD over a mesh (fit mode), from
    ``embedding`` (n, dim): ``n_epochs`` epochs of
    :func:`_make_sharded_epoch_fn` on the mesh's first device. Pooled mode
    draws each epoch's pool from ``gen`` as :func:`optimize_layout` does;
    the per-edge mode (``neg_pool = 0``) draws each shard's negatives from
    its own generator, seeded from ``seed`` and the shard's global index.
    In a gang every process passes the same ``embedding``, ``graph`` and
    seeds, and returns the same layout."""
    n, dim = int(embedding.shape[0]), int(embedding.shape[1])
    epoch, n_pad = _make_sharded_epoch_fn(
        mesh, graph, n_epochs=n_epochs, neg_rate=neg_rate, neg_pool=neg_pool,
        learning_rate=learning_rate, repulsion=repulsion, a=a, b=b,
    )
    first = mesh.first_device
    y = torch.nn.functional.pad(embedding.to(device=first, dtype=torch.float32), (0, 0, 0, n_pad - n))
    k = int(graph.indices.shape[1])
    grid = mesh.grid
    rows = n_pad // int(mesh.shape[DATA_AXIS])
    shard_gens = [seeded_generator(grid[i, 0], seed, g) for i, g in enumerate(data_positions(mesh))]
    for ep in range(n_epochs):
        if neg_pool > 0:
            neg: Union[torch.Tensor, List[torch.Tensor]] = torch.randint(
                0, n, (neg_pool,), generator=gen, device=gen.device).to(first)
        else:
            neg = [torch.randint(0, n, (rows * k, neg_rate), generator=g, device=grid[i, 0])
                   for i, g in enumerate(shard_gens)]
        y = epoch(ep, y, neg)
    return y[:n]


def spectral_init(graph: FuzzyGraph, n: int, dim: int, gen: torch.Generator) -> torch.Tensor:
    """Normalised-Laplacian spectral embedding of the fuzzy graph (one
    dense symmetric ``eigh``, cuSOLVER on the card; the estimator uses it
    up to 8,192 rows), scaled to the ±10 box with N(0, 1e-4²) noise."""
    dev = graph.weight.device
    w = torch.zeros((n, n), dtype=torch.float32, device=dev)
    src = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(graph.indices.shape)
    w.index_put_((src.reshape(-1), graph.indices.reshape(-1).long()), graph.weight.reshape(-1), accumulate=True)
    w = w + w.T  # undirected (mutual weights were already halved)
    deg = torch.clamp_min(torch.sum(w, dim=1), 1e-8)
    d_inv_sqrt = 1.0 / torch.sqrt(deg)
    lap = torch.eye(n, dtype=torch.float32, device=dev) - d_inv_sqrt[:, None] * w * d_inv_sqrt[None, :]
    _, vecs = torch.linalg.eigh(lap)
    emb = vecs[:, 1:dim + 1]  # skip the trivial eigenvector
    expansion = 10.0 / torch.clamp_min(torch.max(torch.abs(emb)), 1e-8)
    noise = torch.randn(emb.shape, generator=gen, dtype=emb.dtype, device=dev) * 1e-4
    return emb * expansion + noise


__all__ = [
    "FuzzyGraph",
    "find_ab_params",
    "fuzzy_simplicial_set",
    "negative_shape",
    "optimize_layout",
    "optimize_layout_resumable",
    "optimize_layout_sharded",
    "smooth_knn_dist",
    "spectral_init",
]
