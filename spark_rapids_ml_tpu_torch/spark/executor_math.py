"""Pure-numpy model forwards and units of work for Spark EXECUTOR
processes — port of the reference's ``spark/executor_math.py`` (the port
keeps its own copy).

The adapter's contract is that executors need numpy only: no torch, no
card. Transform pandas_udfs therefore close over plain numpy parameter
arrays plus the functions in THIS module (which imports nothing but
numpy), never over core model objects, whose modules import torch.

The math mirrors the core ops: ``logistic_forward`` twins
``ops/logistic.predict_logistic`` (raw = [-z, z] margins for binomial,
logits for multinomial); ``forest_forward`` twins
``ops/trees.forest_apply`` + ``forest_predict_proba`` (heap-indexed
routing, LEFT when x[feature] <= threshold, probs = mean leaf
distribution, raw = vote mass).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def logistic_forward(
    weights: np.ndarray,  # (d, 1) binomial or (d, C) multinomial
    intercepts: np.ndarray,  # (1,) or (C,)
    threshold: float,
    block: np.ndarray,  # (n, d)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (raw, probabilities, predictions) for one row block."""
    logits = block @ weights + intercepts
    if weights.shape[1] == 1:
        z = logits[:, 0]
        # Overflow-safe sigmoid: exp of a non-positive argument only.
        t = np.exp(-np.abs(z))
        p1 = np.where(z >= 0, 1.0 / (1.0 + t), t / (1.0 + t))
        probs = np.stack([1.0 - p1, p1], axis=1)
        raw = np.stack([-z, z], axis=1)
        pred = (p1 > threshold).astype(np.float64)
    else:
        m = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(m)
        probs = e / e.sum(axis=1, keepdims=True)
        raw = logits
        pred = np.argmax(logits, axis=1).astype(np.float64)
    return raw, probs, pred


def forest_forward(
    feature: np.ndarray,  # (T, N) int, -1 at leaves
    threshold: np.ndarray,  # (T, N)
    is_leaf: np.ndarray,  # (T, N) bool
    leaf_value: np.ndarray,  # (T, N, C) per-leaf class distribution
    max_depth: int,
    block: np.ndarray,  # (n, d)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (raw vote mass, probabilities, predictions) for one block."""
    T = feature.shape[0]
    idx = forest_apply_leaves(feature, threshold, is_leaf, max_depth, block)
    n_classes = leaf_value.shape[2]
    probs = np.stack(
        [
            np.take_along_axis(leaf_value[:, :, c], idx, axis=1).mean(axis=0)
            for c in range(n_classes)
        ],
        axis=1,
    )
    raw = probs * T
    pred = np.argmax(probs, axis=1).astype(np.float64)
    return raw, probs, pred


def logistic_loss_grad(
    w: np.ndarray,  # (d, c) standardized-space weights
    b: np.ndarray,  # (c,)
    xs: np.ndarray,  # (rows, d) ALREADY standardized block
    y: np.ndarray,  # (rows,) integer labels
    binomial: bool,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Partition-local (Σ loss, Σ grad_w, Σ grad_b) for the logistic
    objective — the executor unit of work of the distributed fit (Spark's
    per-iteration treeAggregate); sums, not means, so partitions add.
    Mirrors ops/logistic.loss_fn exactly (softplus / log-softmax forms).
    """
    logits = xs @ w + b
    if binomial:
        z = logits[:, 0]
        yt = (y == 1).astype(np.float64)
        # softplus(z) - y z, stable
        loss = float(np.sum(np.logaddexp(0.0, z) - yt * z))
        t = np.exp(-np.abs(z))
        sig = np.where(z >= 0, 1.0 / (1.0 + t), t / (1.0 + t))
        r = (sig - yt)[:, None]  # (rows, 1)
    else:
        m = logits - logits.max(axis=1, keepdims=True)
        lse = m - np.log(np.exp(m).sum(axis=1, keepdims=True))
        rows = np.arange(xs.shape[0])
        loss = float(-np.sum(lse[rows, y.astype(np.int64)]))
        probs = np.exp(lse)
        probs[rows, y.astype(np.int64)] -= 1.0
        r = probs
    return loss, xs.T @ r, r.sum(axis=0)


def forest_apply_leaves(
    feature: np.ndarray,
    threshold: np.ndarray,
    is_leaf: np.ndarray,
    max_depth: int,
    block: np.ndarray,
) -> np.ndarray:
    """(T, n) leaf indices — the shared routing of the forest forwards."""
    T = feature.shape[0]
    n = block.shape[0]
    idx = np.zeros((T, n), dtype=np.int64)
    f_clip = np.maximum(feature, 0)
    for _ in range(max_depth):
        f = np.take_along_axis(f_clip, idx, axis=1)
        leaf = np.take_along_axis(is_leaf, idx, axis=1)
        thr = np.take_along_axis(threshold, idx, axis=1)
        xv = block[np.arange(n)[None, :], f]
        child = 2 * idx + 1 + (xv > thr)
        idx = np.where(leaf, idx, child)
    return idx


def forest_forward_reg(
    feature: np.ndarray,
    threshold: np.ndarray,
    is_leaf: np.ndarray,
    leaf_value: np.ndarray,  # (T, N, 1) per-leaf means
    max_depth: int,
    block: np.ndarray,
) -> np.ndarray:
    """(n,) regression predictions: mean of per-tree leaf means."""
    idx = forest_apply_leaves(feature, threshold, is_leaf, max_depth, block)
    return np.take_along_axis(leaf_value[:, :, 0], idx, axis=1).mean(axis=0)


# ----------------------------------------------------------------------
# Distributed random-forest fit: executor units of work.
# Per level, each partition routes ITS rows through the broadcast partial
# forest and returns an additive histogram partial; treeReduce sums them
# and the driver decides splits with ops.trees.split_level — the same
# mapPartitions+treeAggregate structure as the covariance
# (RapidsRowMatrix.scala:170-233), applied per tree level.
# ----------------------------------------------------------------------


def bin_columns(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(n, d) bin ids: bin = #{edges e : x > e} per feature — the numpy
    twin of ops/trees.bin_features (same convention, so raw thresholds
    are the winning bin's upper edge on both sides)."""
    out = np.empty(x.shape, dtype=np.int64)
    for f in range(x.shape[1]):
        out[:, f] = np.searchsorted(edges[f], x[:, f], side="left")
    return out


def forest_route(
    feature: np.ndarray,  # (T, N) int, -1 = no split
    threshold: np.ndarray,  # (T, N)
    x: np.ndarray,  # (n, d)
    level: int,
) -> np.ndarray:
    """(T, n) heap node ids of each row at ``level``; -1 = retired (the
    row's path hit a leaf above this level). Twins the routing step of
    ops/trees.grow_forest: descend LEFT on x[feature] <= threshold, which
    by the binning convention equals bin <= split bin."""
    T = feature.shape[0]
    n = x.shape[0]
    idx = np.zeros((T, n), dtype=np.int64)
    rows = np.arange(n)[None, :]
    for _ in range(level):
        active = idx >= 0
        safe = np.maximum(idx, 0)
        f = np.take_along_axis(feature, safe, axis=1)
        ok = f >= 0
        thr = np.take_along_axis(threshold, safe, axis=1)
        xv = x[rows, np.maximum(f, 0)]
        child = 2 * idx + 1 + (xv > thr)
        idx = np.where(active & ok, child, np.where(active, -1, idx))
    return idx


def level_histogram_partial(
    node_idx: np.ndarray,  # (T, n) from forest_route
    weights: np.ndarray,  # (T, n) per-tree sample weights
    x_binned: np.ndarray,  # (n, d)
    row_stats: np.ndarray,  # (n, S)
    offset: int,
    m_nodes: int,
    n_bins: int,
) -> np.ndarray:
    """(T, M, d, B, S) float64 histogram partial for one partition's rows
    — additive across partitions (the executor half of split_level)."""
    T, n = node_idx.shape
    d = x_binned.shape[1]
    S = row_stats.shape[1]
    hist = np.zeros((T, m_nodes * d * n_bins, S))
    feat_off = np.arange(d)[None, :] * n_bins
    for t in range(T):
        local = node_idx[t] - offset
        sel = (local >= 0) & (local < m_nodes) & (weights[t] > 0)
        if not np.any(sel):
            continue
        codes = (
            local[sel, None] * (d * n_bins) + feat_off + x_binned[sel]
        ).ravel()  # (n_sel * d,)
        for s in range(S):
            wts = np.repeat(weights[t, sel] * row_stats[sel, s], d)
            hist[t, :, s] += np.bincount(
                codes, weights=wts, minlength=m_nodes * d * n_bins
            )
    return hist.reshape(T, m_nodes, d, n_bins, S)


def node_totals_partial(
    node_idx: np.ndarray,
    weights: np.ndarray,
    row_stats: np.ndarray,
    offset: int,
    m_nodes: int,
) -> np.ndarray:
    """(T, M, S) per-node stat totals for one partition's rows (the
    bottom-level leaf statistics; additive across partitions)."""
    T = node_idx.shape[0]
    S = row_stats.shape[1]
    tot = np.zeros((T, m_nodes, S))
    for t in range(T):
        local = node_idx[t] - offset
        sel = (local >= 0) & (local < m_nodes) & (weights[t] > 0)
        if not np.any(sel):
            continue
        for s in range(S):
            tot[t, :, s] += np.bincount(
                local[sel], weights=weights[t, sel] * row_stats[sel, s],
                minlength=m_nodes,
            )
    return tot


def tree_weight_rng(seed: int, part_index: int):
    """Per-partition RNG for bootstrap weights, deterministic in
    (seed, partition index): every level's pass re-creates it and draws
    chunk by chunk in the same order, so executors re-derive identical
    weights without shipping state across Spark jobs."""
    return np.random.default_rng((int(seed) << 20) ^ (part_index + 1))


def draw_tree_weights(
    rng, n_trees: int, n_rows: int, rate: float, bootstrap: bool
) -> np.ndarray:
    """(T, n_rows) per-tree sample weights for one row chunk. Poisson(rate)
    with replacement / Bernoulli(rate) without — the scheme of
    ops/trees.sample_weights (the draw differs from the core's torch
    generator stream; both are valid bootstrap resamplings, and rate=1 without
    bootstrap is exactly all-ones on both sides)."""
    if not bootstrap and rate >= 1.0:
        return np.ones((n_trees, n_rows))
    if bootstrap:
        return rng.poisson(rate, (n_trees, n_rows)).astype(np.float64)
    return (rng.random((n_trees, n_rows)) < rate).astype(np.float64)


def soft_threshold(v: np.ndarray, t: float) -> np.ndarray:
    """Elementwise soft-threshold — the numpy twin of the L1 prox in
    ops/logistic.fit_logistic_elastic_net's FISTA step."""
    return np.sign(v) * np.maximum(np.abs(v) - t, 0.0)


def gram_matvec_partial(
    xs: np.ndarray, v: np.ndarray
) -> np.ndarray:
    """XsᵀXs·v partial for one standardized block — the executor unit of
    the distributed power iteration bounding the FISTA Lipschitz constant
    (the spectral-norm estimate of ops/logistic, one pass per step)."""
    return xs.T @ (xs @ v)


def knn_shard_topk(
    queries: np.ndarray,  # (nq, d) — broadcast to every shard
    items: np.ndarray,  # (m, d) — one executor's local index shard
    offset: int,  # global row index of items[0]
    k: int,
    metric: str = "euclidean",
) -> Tuple[np.ndarray, np.ndarray]:
    """Shard-local top-k — the executor unit of the SHARDED neighbor
    search: each partition holds its rows as a local
    index, queries broadcast, and the per-shard (nq, k') candidates
    tree-merge with :func:`knn_merge_candidates`. The numpy twin of
    ops/knn.knn_sq_euclidean's block step (same expansion, same
    ascending-(distance, index) contract; indices are GLOBAL via
    ``offset``). k' = min(k, m) — a shard smaller than k contributes all
    its rows.
    """
    q = queries
    x = items
    if metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    d2 = (
        np.sum(q * q, axis=1)[:, None]
        - 2.0 * (q @ x.T)
        + np.sum(x * x, axis=1)[None, :]
    )
    np.maximum(d2, 0.0, out=d2)
    kk = min(k, x.shape[0])
    part = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
    pd = np.take_along_axis(d2, part, axis=1)
    order = np.argsort(pd, axis=1, kind="stable")
    idx = np.take_along_axis(part, order, axis=1) + offset
    dist = np.take_along_axis(pd, order, axis=1)
    if metric == "euclidean":
        dist = np.sqrt(dist)
    elif metric == "cosine":
        dist = dist / 2.0
    return dist, idx.astype(np.int64)


def knn_merge_candidates(
    a: Tuple[np.ndarray, np.ndarray],
    b: Tuple[np.ndarray, np.ndarray],
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two per-shard candidate sets into the best k (the treeReduce
    combiner of the sharded search — same merge math as the device scan's
    candidate top-k)."""
    d = np.concatenate([a[0], b[0]], axis=1)
    i = np.concatenate([a[1], b[1]], axis=1)
    kk = min(k, d.shape[1])
    part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
    pd = np.take_along_axis(d, part, axis=1)
    order = np.argsort(pd, axis=1, kind="stable")
    return (
        np.take_along_axis(pd, order, axis=1),
        np.take_along_axis(np.take_along_axis(i, part, axis=1), order, axis=1),
    )


__all__ = [
    "logistic_forward",
    "forest_forward",
    "forest_forward_reg",
    "forest_apply_leaves",
    "logistic_loss_grad",
    "bin_columns",
    "forest_route",
    "level_histogram_partial",
    "node_totals_partial",
    "tree_weight_rng",
    "draw_tree_weights",
    "soft_threshold",
    "gram_matvec_partial",
    "knn_shard_topk",
    "knn_merge_candidates",
]
