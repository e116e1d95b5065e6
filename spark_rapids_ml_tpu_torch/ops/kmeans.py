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

Left for later slices: ``lloyd_resumable``/``_lloyd_segment``
(checkpointed Lloyd).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.core.data import _block_to_dense
from spark_rapids_ml_tpu_torch.core.serving import prefetch_blocks, upload_block
from spark_rapids_ml_tpu_torch.ops.precision import make_dot

Dot = Union[str, Callable]


def _as_dot(dot: Dot) -> Callable:
    return make_dot(dot) if isinstance(dot, str) else dot


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


def _assign_and_accumulate(xb, mb, x2b, centers, k: int, dot: Callable):
    """One block's assignment and sufficient statistics: (sums (k, d),
    counts (k,), cost). The one-hot carries the row weights."""
    d2 = _sq_dists(xb, centers, x2b, dot)
    labels = torch.argmin(d2, dim=1)
    min_d2 = torch.gather(d2, 1, labels[:, None])[:, 0]
    del d2
    one_hot = torch.zeros((xb.shape[0], k), dtype=xb.dtype, device=xb.device)
    one_hot.scatter_(1, labels[:, None], mb[:, None].to(xb.dtype))
    sums = dot(one_hot.T, xb)
    counts = torch.sum(one_hot, dim=0)
    cost = torch.sum(min_d2 * mb)
    return sums, counts, cost


def lloyd_step(x, mask, centers, x2, dot: Dot, cosine: bool = False,
               block_rows: Optional[int] = None):
    """One Lloyd iteration: (new_centers, cost). ``dot`` is a mode name or
    a matmul callable. ``block_rows`` walks the rows in blocks so only a
    (block, k) distance matrix exists at a time; the last block may be
    short (a tensor slice needs no padding)."""
    dot = _as_dot(dot)
    k = centers.shape[0]
    n = x.shape[0]
    if block_rows is None or n <= block_rows:
        sums, counts, cost = _assign_and_accumulate(x, mask, x2, centers, k, dot)
    else:
        sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
        counts = torch.zeros((k,), dtype=x.dtype, device=x.device)
        cost = torch.zeros((), dtype=x.dtype, device=x.device)
        for i in range(0, n, block_rows):
            j = slice(i, i + block_rows)
            sb, cb, jb = _assign_and_accumulate(x[j], mask[j], x2[j], centers, k, dot)
            sums, counts, cost = sums + sb, counts + cb, cost + jb
    new_centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers
    )
    if cosine:
        new_centers = normalize_rows(new_centers)
    return new_centers, cost


def _auto_block_rows(n: int, k: int, block_rows: Optional[int]) -> int:
    """``block_rows=None``: unblocked (``n + 1``) while the (n, k) float32
    temporary stays under ~9 GB, else blocks of ~1 GB of temporaries (the
    reference's static rule; its autotuner is not ported)."""
    if block_rows is not None:
        return block_rows
    if 4 * n * k > 9_000_000_000:
        return max(8, (250_000_000 // max(k, 1) // 8) * 8)
    return n + 1


def lloyd(
    x: torch.Tensor,
    mask: torch.Tensor,
    init_centers: torch.Tensor,
    max_iter: int = 20,
    tol: float = 1e-4,
    precision: str = "highest",
    cosine: bool = False,
    block_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full Lloyd fit: (centers, cost, n_iter). Stops when no center moves
    more than ``tol`` (euclidean) or at ``max_iter``, then evaluates the
    cost once more at the converged centers. With ``cosine`` the centers
    stay unit-normalized (rows must already be)."""
    dot = make_dot(precision)
    block_rows = _auto_block_rows(x.shape[0], init_centers.shape[0], block_rows)
    x2 = torch.sum(x * x, dim=1)
    centers = init_centers
    moved = torch.tensor(math.inf, dtype=x.dtype)
    it = 0
    while bool(moved > tol * tol) and it < max_iter:
        new_centers, _ = lloyd_step(x, mask, centers, x2, dot, cosine=cosine, block_rows=block_rows)
        moved = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        centers = new_centers
        it += 1
    _, cost = lloyd_step(x, mask, centers, x2, dot, cosine=cosine, block_rows=block_rows)
    return centers, cost, it


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


def kmeans_plusplus_init(
    x: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator,
    k: int,
    precision: str = "highest",
) -> torch.Tensor:
    """Greedy k-means++ seeding on the device, no host sync.

    D² sampling with the greedy refinement: each step draws ``2 +
    ceil(log2 k)`` candidate rows with probability ∝ weight·D² (Gumbel-
    top-t) and keeps the one that minimizes the resulting potential. Rows
    of weight 0 are never chosen and add nothing to the potential."""
    dot = make_dot(precision)
    n, d = x.shape
    neg_inf = torch.tensor(-math.inf, dtype=x.dtype, device=x.device)
    t = min(2 + max(int(math.ceil(math.log2(k))), 0), n)
    x2 = torch.sum(x * x, dim=1)
    g0 = _gumbel(n, x, generator)
    first = torch.argmax(torch.where(mask > 0, g0, neg_inf))
    centers = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    min_d2 = torch.clamp(x2 - 2.0 * dot(x, x[first]) + x2[first], min=0.0)
    for i in range(1, k):
        logw = torch.where((mask > 0) & (min_d2 > 0), torch.log(mask * min_d2), neg_inf)
        g = _gumbel(n, x, generator)
        cand = torch.topk(logw + g, t).indices
        # All-zero residual (duplicate data): take the first row.
        degenerate = ~torch.isfinite(torch.max(logw))
        cand = torch.where(degenerate, first, cand)
        xc = x[cand]
        d2c = torch.clamp(
            x2[None, :] - 2.0 * dot(xc, x.T) + torch.sum(xc * xc, dim=1)[:, None], min=0.0
        )
        pot = torch.sum(torch.minimum(min_d2[None, :], d2c) * mask[None, :], dim=1)
        best = torch.argmin(pot)
        centers[i] = x[cand[best]]
        min_d2 = torch.minimum(min_d2, d2c[best])
    return centers


def random_init(x: torch.Tensor, mask: torch.Tensor, generator: torch.Generator, k: int) -> torch.Tensor:
    """Random seeding: k distinct rows of nonzero weight, by Gumbel scores
    and an exact top-k."""
    g = _gumbel(x.shape[0], x, generator)
    scores = torch.where(mask > 0, g, torch.tensor(-math.inf, dtype=x.dtype, device=x.device))
    return x[torch.topk(scores, k).indices]


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize rows: cosine distance is euclidean on normalized data."""
    norms = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.clamp(norms, min=eps)
