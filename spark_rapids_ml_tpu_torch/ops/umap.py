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
else through ``index_add_``. Left for later slices (ROADMAP): the
checkpointed ``_layout_segment`` / ``optimize_layout_resumable`` (A.12a,
the robustness slice) and the mesh's ``_sharded_layout_fn`` /
``optimize_layout_sharded`` (A.12b, with item 18).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops.kernels.umap import TailPlan, tail_accumulate


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
            if tail_plan is not None:
                delta = delta + tail_accumulate(tail_g, tail_plan)
            else:
                delta = delta + torch.zeros_like(y).index_add_(0, dst_flat, tail_g)
        return y + delta

    return epoch


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
    y = embedding
    for ep in range(n_epochs):
        y = epoch(ep, y, torch.randint(0, n_ref, shape, generator=gen, device=y.device))
    return y


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
    "smooth_knn_dist",
    "spectral_init",
]
