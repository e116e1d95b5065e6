"""Helpers for holding the port against the reference on the same inputs.

``seeded_matrix`` makes the inputs with numpy from a seed, so both
packages see identical bytes; ``assert_close`` names what it compares and
the tolerance it was held to, so a failure reads as a parity report.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def seeded_matrix(
    n: int,
    d: int,
    seed: int = 0,
    *,
    scales: Optional[Sequence[float]] = None,
    offset: float = 0.0,
    dtype=np.float64,
) -> np.ndarray:
    """An (n, d) standard-normal matrix from ``numpy.random.default_rng(seed)``,
    columns multiplied by ``scales`` (default ones) and shifted by ``offset``."""
    x = np.random.default_rng(seed).standard_normal((n, d))
    if scales is not None:
        x = x * np.asarray(scales, dtype=np.float64)[None, :]
    return (x + offset).astype(dtype)


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch.Tensor, wherever it lives
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(name: str, got, want, rtol: float, atol: float = 0.0) -> None:
    """Elementwise ``|got - want| <= atol + rtol * |want|`` with a report
    naming ``name``, the worst element and the tolerance."""
    got_np = _host(got).astype(np.float64)
    want_np = _host(want).astype(np.float64)
    if got_np.shape != want_np.shape:
        raise AssertionError(f"{name}: shapes differ, {got_np.shape} vs {want_np.shape}")
    if got_np.size == 0:
        return
    err = np.abs(got_np - want_np)
    bound = atol + rtol * np.abs(want_np)
    if not np.all(err <= bound):
        i = np.unravel_index(np.argmax(err - bound), err.shape)
        raise AssertionError(
            f"{name}: max |err| {err.max():.3e}; at {tuple(int(v) for v in i)} "
            f"got {got_np[i]!r} want {want_np[i]!r} (rtol {rtol:.0e}, atol {atol:.0e})"
        )


def kmeans_stats_f64(
    x: torch.Tensor,
    centers: torch.Tensor,
    precision: str = "highest",
    c2: Optional[torch.Tensor] = None,
    block_rows: int = 1 << 20,
):
    """float64 statistics of the function kernels K2/K3 compute, on the
    operands the mode multiplies (each float32 part widened exactly), in
    row blocks so that the (block, k) scores fit: (sums (k, d), counts
    (k,) int64, cost, labels). ``c2`` defaults to the float64 norms of the
    centers; pass the float32 ``c2`` a kernel returned to score against the
    same rounded norms (their rounding is shared by every row of a
    cluster, so it would not average out of the cost)."""
    from spark_rapids_ml_tpu_torch.ops.kernels.kmeans import split_parts

    k, d = centers.shape
    ch, cl = (p.double() for p in split_parts(centers, precision))
    c2 = (centers.double() ** 2).sum(dim=1) if c2 is None else c2.double()
    sums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=x.device)
    cost = torch.zeros((), dtype=torch.float64, device=x.device)
    labels = torch.empty((x.shape[0],), dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], block_rows):
        xb = x[i:i + block_rows]
        xh, xl = (p.double() for p in split_parts(xb, precision))
        scores = c2[None, :] - 2.0 * (xh @ ch.T + xh @ cl.T + xl @ ch.T)
        lab = torch.argmin(scores, dim=1)
        m = torch.gather(scores, 1, lab[:, None])[:, 0]
        del scores
        sums.index_add_(0, lab, xh + xl)
        counts += torch.bincount(lab, minlength=k)
        cost += torch.sum((xb.double() ** 2).sum(dim=1) + m)
        labels[i:i + block_rows] = lab
    return sums, counts, cost, labels


def trustworthiness(x, emb, n_neighbors: int = 5) -> float:
    """sklearn's ``manifold.trustworthiness`` (euclidean) in torch, where
    the tensors lie:

        T = 1 − 2 / (n·k·(2n − 3k − 1)) · Σ_i Σ_{j ∈ kNN_emb(i)} max(0, r(i, j) − k)

    with r(i, j) the rank of j among i's neighbours in the input space
    (1 = nearest) and kNN_emb(i) i's k nearest in the embedding, self
    excluded on both sides. Pairwise (n, n) work: for a few thousand rows."""
    x = torch.as_tensor(x).double()
    emb = torch.as_tensor(emb).to(device=x.device, dtype=torch.float64)
    n, k = int(x.shape[0]), int(n_neighbors)
    if not 1 <= k < n / 2:
        raise ValueError(f"n_neighbors must be in [1, n/2), got {k} for n={n}")
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d_x = torch.cdist(x, x).masked_fill_(eye, float("inf"))
    rank = torch.empty((n, n), dtype=torch.int64, device=x.device)
    ranks = torch.arange(1, n + 1, device=x.device).expand(n, n)
    rank.scatter_(1, torch.argsort(d_x, dim=1), ranks)
    d_e = torch.cdist(emb, emb).masked_fill_(eye, float("inf"))
    nbrs = torch.topk(d_e, k, dim=1, largest=False).indices
    over = torch.gather(rank, 1, nbrs) - k
    t = float(over.clamp_min(0).sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


__all__ = ["assert_close", "kmeans_stats_f64", "seeded_matrix", "trustworthiness"]
