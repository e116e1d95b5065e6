"""Random-forest growth and prediction — port of the reference's
``ops/trees.py``: level-order histogram growth with one-hot GEMMs.

All trees and all nodes of one depth level grow together. A level's
histogram

  hist[t, node, feature, bin, stat] =
      sum_r onehot_node[t, node, r] * onehot_bin[r, feature*B + bin]
            * weight[t, r] * row_stat[r, stat]

is one (T*M, rows) x (rows, d*B) product per stat channel per row block
(:func:`_level_histogram`, ``block_rows`` rows at a time); the split
search (:func:`split_level`: prefix sums over bins, impurity, argmax over
the flat (d*B) candidates, first maximum on ties) and the routing of rows
to children follow. Trees are heap-indexed: node g has children 2g+1 and
2g+2, and a depth-D forest holds 2^(D+1) - 1 slots per tree. A row goes
left when ``x[feature] <= threshold``.

Rounding as the reference's. Features are binned against quantile edges
(:func:`quantize_features`), so the trees depend on those edges bit for
bit; the reference's XLA:CPU program contracts some of its float32
products and sums into fused multiply-adds (the quantile's linear
interpolation, the gini sum of squares, the variance, the split gain),
and :func:`_fma` computes each of those with the same single rounding.
Histogram precision follows the reference: unweighted classification
counts are integers, exact in a bf16 product with fp32 accumulation
(``ops/precision`` mode ``default``); real-valued stats take IEEE fp32
(``highest``). ``hist_precision="float64"`` sums the histograms in
float64 and rounds them to float32 before the split search (a reference
fit for checks on the card).

Random numbers: the per-level feature-subset uniforms and the bootstrap
weights are arguments (``uniforms``, ``weights``), drawn by default from
the fit's ``torch.Generator``; JAX's threefry draws cannot be reproduced,
so the tests pass JAX's in.

``_select_feature`` (the reference's unrolled select that avoids TPU
gathers) is one ``torch.gather`` here.

Over a mesh (:func:`grow_forest_sharded`) the rows, their stats and the
weights' row axis split over the data axis, padded with zero weight; each
shard builds its partial histograms where it lives and one ``psum_data``
a level (and one for the bottom totals) merges them, so every split
decision is taken once on the merged histogram and every shard routes its
rows by it. Integer classification counts sum exactly, so such a forest
is bitwise the single-device forest from the same draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.collectives import psum_data
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, require_one_process

CLASSIFICATION = ("gini", "entropy")


class Forest(NamedTuple):
    """Heap-indexed forest tensors; N = 2^(max_depth+1) - 1 nodes per tree.

    ``feature`` is -1 at leaves; traversal follows ``is_leaf``.
    ``leaf_value`` holds the class distribution (classification, S = C) or
    [mean] (regression). ``node_weight`` / ``node_gain`` feed the feature
    importances; ``node_impurity`` is the node's own impurity, kept so the
    Spark NodeData format round-trips."""

    feature: torch.Tensor  # (T, N) int32
    threshold: torch.Tensor  # (T, N) float32
    is_leaf: torch.Tensor  # (T, N) bool
    leaf_value: torch.Tensor  # (T, N, S_out) float32
    node_weight: torch.Tensor  # (T, N) float32
    node_gain: torch.Tensor  # (T, N) float32
    node_impurity: torch.Tensor  # (T, N) float32


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as a fused multiply-add. float32: the
    product is exact in float64 and the float64 sum's error is recovered
    (two-sum), which settles the one case where rounding twice differs
    from once, a float64 sum exactly halfway between two float32 values.
    Other dtypes: a plain multiply and add."""
    if a.dtype != torch.float32:
        return a * b + c
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    z = s - p
    err = (p - (s - z)) + (c64 - z)
    r = s.float()
    r64 = r.double()
    inf = torch.tensor(float("inf"), device=r.device)
    beyond = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    halfway = (s != r64) & ((s - r64) * 2 == beyond.double() - r64) & (err != 0)
    r = torch.where(halfway & (err > 0) & (r64 < s), torch.nextafter(r, inf), r)
    return torch.where(halfway & (err < 0) & (r64 > s), torch.nextafter(r, -inf), r)


def _sum_last(stats: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right, as the reference's reduce."""
    total = stats[..., 0]
    for s in range(1, stats.shape[-1]):
        total = total + stats[..., s]
    return total


def quantize_features(x: torch.Tensor, max_bins: int, max_sample_rows: int = 262_144) -> torch.Tensor:
    """Per-feature quantile bin edges, (d, max_bins - 1), ascending: the
    (i+1)/B quantiles of (every ``stride``-th row of) each feature, by the
    reference's linear method — sort, ``pos = q·(n−1)``, ``lo = floor``,
    ``hi = ceil``, ``w = pos − lo``, then ``a[lo]·(1−w) + a[hi]·w`` with the
    first product fused (:func:`_fma`). ``torch.quantile`` rounds
    differently. A feature with a NaN gets NaN edges."""
    n = int(x.shape[0])
    if n > max_sample_rows:
        x = x[::-(-n // max_sample_rows)]
        n = int(x.shape[0])
    x = torch.where(torch.isnan(x).any(dim=0, keepdim=True), torch.nan, x)
    a = torch.sort(x, dim=0).values
    q = torch.arange(1, max_bins, dtype=x.dtype, device=x.device) / max_bins
    pos = q * torch.tensor(float(n - 1), dtype=x.dtype, device=x.device)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    w = pos - lo
    lo_i = torch.clamp(lo, 0, n - 1).long()
    hi_i = torch.clamp(hi, 0, n - 1).long()
    edges = _fma(a[lo_i], (1.0 - w)[:, None], a[hi_i] * w[:, None])
    return edges.T.contiguous()


def bin_features(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin ids, (n, d) int32: bin = #{edges e : x > e}, in [0, B-1], so
    "bin <= b" is exactly "x <= edges[b]". Blocked over rows to bound the
    (rows, d, B-1) comparison."""
    n, d = x.shape
    block = max(1, min(n, 1 << 22) // max(1, d * int(edges.shape[1])) + 1)
    out = torch.empty((n, d), dtype=torch.int32, device=x.device)
    for s in range(0, n, block):
        out[s:s + block] = torch.sum(x[s:s + block, :, None] > edges[None, :, :], dim=2)
    return out


def _impurity(stats: torch.Tensor, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(impurity, total weight) from stats along the last axis.
    Classification stats are per-class weighted counts (gini, or entropy
    in log2 as Spark's); regression stats are [w, w·y, w·y²] (variance)."""
    if kind in CLASSIFICATION:
        w = _sum_last(stats)
        p = stats / torch.clamp_min(w, 1e-12)[..., None]
        if kind == "gini":
            sq = p[..., 0] * p[..., 0]
            for s in range(1, p.shape[-1]):
                sq = _fma(p[..., s], p[..., s], sq)
            imp = 1.0 - sq
        else:
            terms = torch.where(p > 0, p * torch.log2(p), 0.0)
            imp = -_sum_last(terms)
        return torch.where(w > 0, imp, 0.0), w
    if kind == "variance":
        w = stats[..., 0]
        wc = torch.clamp_min(w, 1e-12)
        mean = stats[..., 1] / wc
        var = _fma(-mean, mean, stats[..., 2] / wc)
        return torch.where(w > 0, torch.clamp_min(var, 0.0), 0.0), w
    raise ValueError(f"unknown impurity {kind!r}")


def _hist_dot(precision: str) -> Tuple[Callable, torch.dtype]:
    """(product, accumulation dtype) of a histogram precision: a
    ``ops/precision`` mode in float32, or ``"float64"``."""
    if precision == "float64":
        return (lambda a, b: torch.matmul(a.double(), b.double())), torch.float64
    return make_dot(precision), torch.float32


def _level_histogram(
    node_idx: torch.Tensor,  # (T, n) global heap ids, -1 = inactive
    weights: torch.Tensor,  # (T, n)
    x_binned: torch.Tensor,  # (n, d)
    row_stats: torch.Tensor,  # (n, S)
    offset: int,
    n_nodes: int,
    n_bins: int,
    block_rows: int,
    precision: str = "highest",
) -> torch.Tensor:
    """(T, n_nodes, d, n_bins, S) float32 histogram of one level: per
    row block, one (T·M, rows) x (rows, d·B) one-hot product per stat."""
    hist = _level_histogram_sum(node_idx, weights, x_binned, row_stats, offset, n_nodes, n_bins,
                                block_rows, precision)
    return _level_hist_f32(hist, int(x_binned.shape[1]), n_bins)


def _level_hist_f32(hist: torch.Tensor, d: int, n_bins: int) -> torch.Tensor:
    T, n_nodes, _, S = hist.shape
    return hist.to(torch.float32).reshape(T, n_nodes, d, n_bins, S)


def _level_histogram_sum(node_idx, weights, x_binned, row_stats, offset: int, n_nodes: int,
                         n_bins: int, block_rows: int, precision: str = "highest") -> torch.Tensor:
    """The (T, n_nodes, d·B, S) level histogram in the precision's
    accumulation dtype (before the float32 rounding)."""
    T, n = node_idx.shape
    d = int(x_binned.shape[1])
    S = int(row_stats.shape[1])
    dot, acc = _hist_dot(precision)
    dev = node_idx.device
    nodes = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    bins = torch.arange(n_bins, dtype=torch.int32, device=dev)
    hist = torch.zeros((T, n_nodes, d * n_bins, S), dtype=acc, device=dev)
    for s0 in range(0, n, block_rows):
        local = node_idx[:, s0:s0 + block_rows] - offset
        w_b = weights[:, s0:s0 + block_rows]
        rs_b = row_stats[s0:s0 + block_rows]
        bs = int(local.shape[1])
        node_oh = (local[:, None, :] == nodes[None, :, None]).to(torch.float32)  # (T, M, bs)
        bin_oh = (x_binned[s0:s0 + block_rows, :, None] == bins).to(torch.float32).reshape(bs, d * n_bins)
        for s in range(S):
            a = node_oh * (w_b * rs_b[None, :, s])[:, None, :]
            hist[..., s] += dot(a.reshape(T * n_nodes, bs), bin_oh).reshape(T, n_nodes, d * n_bins)
    return hist


def _node_totals(
    node_idx: torch.Tensor,
    weights: torch.Tensor,
    row_stats: torch.Tensor,
    offset: int,
    n_nodes: int,
    block_rows: int,
    precision: str = "highest",
) -> torch.Tensor:
    """(T, n_nodes, S) float32 per-node stat totals, one product per row
    block."""
    return _node_totals_sum(node_idx, weights, row_stats, offset, n_nodes, block_rows,
                            precision).to(torch.float32)


def _node_totals_sum(node_idx, weights, row_stats, offset: int, n_nodes: int, block_rows: int,
                     precision: str = "highest") -> torch.Tensor:
    """The per-node totals in the precision's accumulation dtype."""
    T, n = node_idx.shape
    S = int(row_stats.shape[1])
    dot, acc = _hist_dot(precision)
    nodes = torch.arange(n_nodes, dtype=torch.int32, device=node_idx.device)
    tot = torch.zeros((T, n_nodes, S), dtype=acc, device=node_idx.device)
    for s0 in range(0, n, block_rows):
        local = node_idx[:, s0:s0 + block_rows] - offset
        bs = int(local.shape[1])
        node_oh = (local[:, None, :] == nodes[None, :, None]).to(torch.float32)
        a = node_oh * weights[:, None, s0:s0 + block_rows]
        tot += dot(a.reshape(T * n_nodes, bs), row_stats[s0:s0 + block_rows]).reshape(T, n_nodes, S)
    return tot


def split_level(
    hist: torch.Tensor,  # (T, M, d, B, S) level histogram
    uniforms: Optional[torch.Tensor],  # (T, M, d) feature-subset draws
    *,
    impurity: str,
    feat_subset: int,
    min_instances: int = 1,
    min_info_gain: float = 0.0,
):
    """Split decision of one level from its histogram. Each node considers
    exactly ``feat_subset`` features: those whose uniform is at least the
    ``feat_subset``-th largest of the node's (``uniforms`` is unused when
    every feature is considered).

    Returns ``(best_f, best_b, best_gain, split_ok, total, w_parent)``,
    (T, M) each and (T, M, S) for ``total``."""
    T, m_nodes, d, n_bins, _ = hist.shape
    left = torch.cumsum(hist, dim=3)
    total = left[:, :, 0, -1, :]
    right = total[:, :, None, None, :] - left
    imp_parent, w_parent = _impurity(total, impurity)
    imp_l, w_l = _impurity(left, impurity)
    imp_r, w_r = _impurity(right, impurity)
    gain = imp_parent[:, :, None, None] - (
        _fma(w_l, imp_l, w_r * imp_r) / torch.clamp_min(w_parent, 1e-12)[:, :, None, None]
    )
    valid = (w_l >= float(min_instances)) & (w_r >= float(min_instances))
    valid &= (torch.arange(n_bins, device=hist.device) < n_bins - 1)[None, None, None, :]
    if feat_subset < d:
        kth = torch.topk(uniforms, feat_subset, dim=2).values[..., -1:]
        valid &= (uniforms >= kth)[..., None]
    gain = torch.where(valid, gain, -torch.inf)
    flat = gain.reshape(T, m_nodes, d * n_bins)
    best = torch.argmax(flat, dim=2)
    best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
    best_f = torch.div(best, n_bins, rounding_mode="floor").to(torch.int32)
    best_b = (best % n_bins).to(torch.int32)
    split_ok = (best_gain > 0) & (best_gain >= min_info_gain) & (w_parent > 0)
    return best_f, best_b, best_gain, split_ok, total, w_parent


def _select_feature(x: torch.Tensor, f_r: torch.Tensor) -> torch.Tensor:
    """out[t, r] = x[r, f_r[t, r]], one gather."""
    return torch.gather(x.T, 0, f_r.long())


def _leaf_prediction(stats: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-node prediction: the class distribution, or [mean]."""
    if kind in CLASSIFICATION:
        w = _sum_last(stats)[..., None]
        return torch.where(w > 0, stats / torch.clamp_min(w, 1e-12), 1.0 / stats.shape[-1])
    w = stats[..., 0]
    mean = stats[..., 1] / torch.clamp_min(w, 1e-12)
    return torch.where(w > 0, mean, 0.0)[..., None]


def _level_uniforms(uniforms, generator, level: int, shape, device) -> torch.Tensor:
    if uniforms is not None:
        return uniforms[level].to(device)
    if generator is None:
        raise ValueError("a feature subset needs per-level uniforms or a generator to draw them")
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


class _Rows(NamedTuple):
    """One shard of a forest fit's rows, on its device."""

    x_binned: torch.Tensor  # (rows, d) int32
    row_stats: torch.Tensor  # (rows, S)
    weights: torch.Tensor  # (T, rows)


def grow_forest(
    x_binned: torch.Tensor,  # (n, d) int32
    row_stats: torch.Tensor,  # (n, S) float32
    weights: torch.Tensor,  # (T, n) float32 per-tree sample weights
    edges: torch.Tensor,  # (d, n_bins - 1) float32
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    *,
    max_depth: int,
    n_bins: int,
    impurity: str,
    feat_subset: int,
    min_instances: int = 1,
    min_info_gain: float = 0.0,
    block_rows: int = 4096,
    exact_counts: bool = True,
    hist_precision: Optional[str] = None,
) -> Forest:
    """Grow T trees level by level: each level one blocked histogram pass,
    the split search and the rows' routing to children.

    ``uniforms[level]`` (T, 2^level, d) are the feature-subset draws of
    each level; without them each level draws from ``generator``.
    ``hist_precision`` None takes the reference's rule: ``default`` (a
    bf16 product, exact) for classification counts that are integers
    (``exact_counts``), ``highest`` otherwise."""
    _device.device_of(x_binned)
    return _grow([_Rows(x_binned, row_stats, weights)], edges, uniforms, generator, x_binned.device,
                 max_depth=max_depth, n_bins=n_bins, impurity=impurity, feat_subset=feat_subset,
                 min_instances=min_instances, min_info_gain=min_info_gain, block_rows=block_rows,
                 exact_counts=exact_counts, hist_precision=hist_precision)


def grow_forest_sharded(
    mesh,
    x_binned: torch.Tensor,
    row_stats: torch.Tensor,
    weights: torch.Tensor,
    edges: torch.Tensor,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> Forest:
    """:func:`grow_forest` (its keywords) over a mesh: the rows, their stats and the
    weights' row axis zero-padded (padding weighs 0) to a multiple of the
    data axis and split over it, each shard on its first device. The
    partial histograms meet in one ``psum_data`` a level on the mesh's
    first device, where the split search runs (and the uniforms are drawn)
    and the forest lands."""
    require_one_process(mesh, "the mesh forest growth")
    grid = mesh.grid
    dp = int(mesh.shape[DATA_AXIS])
    n = int(x_binned.shape[0])
    pad = (-n) % dp
    if pad:
        x_binned = torch.nn.functional.pad(x_binned, (0, 0, 0, pad))
        row_stats = torch.nn.functional.pad(row_stats, (0, 0, 0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    rows = (n + pad) // dp
    shards = []
    for i in range(dp):
        dev = grid[i, 0]
        sl = slice(i * rows, (i + 1) * rows)
        shards.append(_Rows(x_binned[sl].to(dev), row_stats[sl].to(dev), weights[:, sl].to(dev)))
    _device.device_of(shards[0].x_binned)
    return _grow(shards, edges, uniforms, generator, mesh.first_device, **kwargs)


def _grow(
    shards: Sequence[_Rows],
    edges: torch.Tensor,
    uniforms: Optional[Sequence[torch.Tensor]],
    generator: Optional[torch.Generator],
    dev: torch.device,
    *,
    max_depth: int,
    n_bins: int,
    impurity: str,
    feat_subset: int,
    min_instances: int = 1,
    min_info_gain: float = 0.0,
    block_rows: int = 4096,
    exact_counts: bool = True,
    hist_precision: Optional[str] = None,
) -> Forest:
    """The level-order growth over row shards: each shard's histogram
    where it lives, their sum on ``dev``, the split search there, and each
    shard's rows routed by it. One shard is the single-device fit."""
    T = int(shards[0].weights.shape[0])
    d = int(shards[0].x_binned.shape[1])
    n_total = 2 ** (max_depth + 1) - 1
    s_out = int(shards[0].row_stats.shape[1]) if impurity in CLASSIFICATION else 1
    if hist_precision is None:
        hist_precision = "default" if impurity in CLASSIFICATION and exact_counts else "highest"
    edges = edges.to(dev)

    feature = torch.full((T, n_total), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((T, n_total), dtype=torch.float32, device=dev)
    is_leaf = torch.zeros((T, n_total), dtype=torch.bool, device=dev)
    leaf_value = torch.zeros((T, n_total, s_out), dtype=torch.float32, device=dev)
    node_weight = torch.zeros((T, n_total), dtype=torch.float32, device=dev)
    node_gain = torch.zeros((T, n_total), dtype=torch.float32, device=dev)
    node_imp = torch.zeros((T, n_total), dtype=torch.float32, device=dev)

    # Every row at the root.
    node_idx = [torch.zeros((T, int(sh.x_binned.shape[0])), dtype=torch.int32, device=sh.x_binned.device)
                for sh in shards]
    for level in range(max_depth):
        offset, m_nodes = 2 ** level - 1, 2 ** level
        hist = _level_hist_f32(psum_data([
            _level_histogram_sum(ni, sh.weights, sh.x_binned, sh.row_stats, offset, m_nodes, n_bins,
                                 block_rows, hist_precision)
            for ni, sh in zip(node_idx, shards)], dev), d, n_bins)
        u = None
        if feat_subset < d:
            u = _level_uniforms(uniforms, generator, level, (T, m_nodes, d), dev)
        best_f, best_b, best_gain, split_ok, total, w_parent = split_level(
            hist, u, impurity=impurity, feat_subset=feat_subset,
            min_instances=min_instances, min_info_gain=min_info_gain,
        )
        sl = slice(offset, offset + m_nodes)
        feature[:, sl] = torch.where(split_ok, best_f, -1)
        threshold[:, sl] = torch.where(split_ok, edges[best_f.long(), best_b.long()], 0.0)
        is_leaf[:, sl] = ~split_ok
        leaf_value[:, sl, :] = _leaf_prediction(total, impurity)
        node_weight[:, sl] = w_parent
        node_gain[:, sl] = torch.where(split_ok, best_gain, 0.0)
        node_imp[:, sl] = _impurity(total, impurity)[0]
        node_idx = [_route(ni, sh.x_binned, best_f, best_b, split_ok, offset, m_nodes)
                    for ni, sh in zip(node_idx, shards)]

    # Bottom level: every surviving node is a leaf.
    offset, m_nodes = 2 ** max_depth - 1, 2 ** max_depth
    total = psum_data([_node_totals_sum(ni, sh.weights, sh.row_stats, offset, m_nodes, block_rows,
                                        hist_precision)
                       for ni, sh in zip(node_idx, shards)], dev).to(torch.float32)
    sl = slice(offset, offset + m_nodes)
    is_leaf[:, sl] = True
    leaf_value[:, sl, :] = _leaf_prediction(total, impurity)
    imp_bottom, w_bottom = _impurity(total, impurity)
    node_weight[:, sl] = w_bottom
    node_imp[:, sl] = imp_bottom
    return Forest(feature, threshold, is_leaf, leaf_value, node_weight, node_gain, node_imp)


def _route(node_idx, x_binned, best_f, best_b, split_ok, offset: int, m_nodes: int) -> torch.Tensor:
    """Rows of a leaf retire (-1), rows of a split descend to its child."""
    dev = node_idx.device
    best_f, best_b, split_ok = best_f.to(dev), best_b.to(dev), split_ok.to(dev)
    local = node_idx - offset
    active = (local >= 0) & (local < m_nodes)
    lc = torch.clamp(local, 0, m_nodes - 1).long()
    f_r = torch.gather(best_f, 1, lc)
    b_r = torch.gather(best_b, 1, lc)
    ok_r = torch.gather(split_ok, 1, lc)
    child = 2 * node_idx + 1 + (_select_feature(x_binned, f_r) > b_r).to(torch.int32)
    return torch.where(active & ok_r, child, torch.where(active, -1, node_idx))


def fit_forest_fused(
    x: torch.Tensor,  # (n, d) float32 raw features
    row_stats: torch.Tensor,  # (n, S) float32
    weights: torch.Tensor,  # (T, n) float32
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    *,
    max_sample_rows: int = 262_144,
    **grow_kwargs,
) -> Forest:
    """The whole fit: quantile edges, binning and level-order growth, in
    that order (the reference compiles the three as one program)."""
    edges = quantize_features(x, grow_kwargs["n_bins"], max_sample_rows)
    return grow_forest(bin_features(x, edges), row_stats, weights, edges.to(torch.float32),
                       uniforms, generator, **grow_kwargs)


def forest_apply(x: torch.Tensor, forest: Forest, max_depth: int) -> torch.Tensor:
    """Leaf slot per (tree, row), (T, n) int32: every tree walks every
    row from the root, ``max_depth`` steps of gathers."""
    T = int(forest.feature.shape[0])
    idx = torch.zeros((T, int(x.shape[0])), dtype=torch.int64, device=x.device)
    feature = torch.clamp_min(forest.feature, 0)
    for _ in range(max_depth):
        f = torch.gather(feature, 1, idx)
        leaf = torch.gather(forest.is_leaf, 1, idx)
        thr = torch.gather(forest.threshold, 1, idx)
        child = 2 * idx + 1 + (_select_feature(x, f) > thr).to(torch.int64)
        idx = torch.where(leaf, idx, child)
    return idx.to(torch.int32)


def _mean_over_trees(values: torch.Tensor) -> torch.Tensor:
    """Mean over the tree axis as the reference's reduce rounds it: the
    sum tree by tree, times 1/T."""
    total = values[0]
    for t in range(1, values.shape[0]):
        total = total + values[t]
    return total * (1.0 / values.shape[0])


def forest_predict_proba(x: torch.Tensor, forest: Forest, max_depth: int) -> torch.Tensor:
    """(n, C) mean of the trees' leaf class distributions."""
    idx = forest_apply(x, forest, max_depth).long()
    n_classes = int(forest.leaf_value.shape[2])
    per_class = [_mean_over_trees(torch.gather(forest.leaf_value[:, :, c], 1, idx)) for c in range(n_classes)]
    return torch.stack(per_class, dim=1)


def forest_predict_reg(x: torch.Tensor, forest: Forest, max_depth: int) -> torch.Tensor:
    """(n,) mean of the trees' leaf means."""
    idx = forest_apply(x, forest, max_depth).long()
    return _mean_over_trees(torch.gather(forest.leaf_value[:, :, 0], 1, idx))


def sample_weights(
    generator: torch.Generator, n_trees: int, n_rows: int, subsampling_rate: float, bootstrap: bool
) -> torch.Tensor:
    """(n_trees, n_rows) float32 row weights on the generator's device:
    Poisson(rate) with replacement (the distributed approximation of the
    bootstrap), clamped at 256, or Bernoulli(rate) without. The clamp
    never binds in practice (P[Poisson(1) > 256] ~ 1e-600); it keeps
    integer weights times one-hot stats within bf16's exact integers."""
    rate = torch.full((n_trees, n_rows), float(subsampling_rate), device=generator.device)
    if bootstrap:
        return torch.clamp_max(torch.poisson(rate, generator=generator), 256.0).to(torch.float32)
    return torch.bernoulli(rate, generator=generator).to(torch.float32)


def feature_importances(forest: Forest, n_features: int) -> np.ndarray:
    """Impurity importances, Spark's way, on the host: per tree, each
    split adds gain · node_weight to its feature; per-tree vectors are
    normalised, averaged over trees and normalised again."""
    feat = to_host(forest.feature)
    gain = to_host(forest.node_gain)
    w = to_host(forest.node_weight)
    T = feat.shape[0]
    per_tree = np.zeros((T, n_features))
    contrib = gain * w
    for t in range(T):
        split = feat[t] >= 0
        np.add.at(per_tree[t], feat[t][split], contrib[t][split])
    sums = per_tree.sum(axis=1, keepdims=True)
    per_tree = np.divide(per_tree, sums, out=np.zeros_like(per_tree), where=sums > 0)
    avg = per_tree.mean(axis=0)
    s = avg.sum()
    return avg / s if s > 0 else avg
