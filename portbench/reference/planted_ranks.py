"""One gang member's PCA rows: the planted spectrum of
``data/planted_blocked.py``, each rank's rows a draw of their own. The
gang cells' generator (``data/planted_ranks.py`` hands these functions
on) and the replay that ``reference/pca_gang.py`` makes of every rank's
rows; it imports nothing but torch.

Q, s and μ come from ``--seed`` as in ``planted_blocked.py`` (x = z·diag(s)·Qᵀ
+ μ), so every rank samples one distribution, as the partitions of one
data set do; rank r's z come from a generator of their own, seeded from
``(seed, r)`` alone, and fill the rank's rows in row blocks in place on
its device. The same seed and rank give the same rows on the same kind of
device, which is how the reference replays a rank after it has exited.

:func:`column_sums` is a shard's float64 column sums in row blocks: each
rank reports its own, and the reference's replay must read the same bits.
"""

from __future__ import annotations

import torch

#: Ranks a seed can tell apart (:func:`rank_seed`).
MAX_RANKS = 64
#: Rows a block of :func:`column_sums`: its float64 copy is 0.5 GB at
#: 1,024 features, beside a shard that fills most of the card.
SUM_ROWS = 1 << 16


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s z: distinct for every (seed, rank)."""
    if not 0 <= rank < MAX_RANKS:
        raise ValueError(f"rank must be in [0, {MAX_RANKS}), got {rank}")
    return seed * MAX_RANKS + 1 + rank


def make(shape: dict, params: dict, seed: int, device: torch.device, rank: int = 0) -> torch.Tensor:
    """Rank ``rank``'s ``shape["rows"]`` rows of ``shape["cols"]`` features."""
    n, d = int(shape["rows"]), int(shape["cols"])
    top, block = int(params["top"]), int(params["block_rows"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen, device=device, dtype=torch.float64))
    s = torch.ones(d, dtype=torch.float64, device=device)
    s[:top] += params["lift"] * params["decay"] ** torch.arange(top, dtype=torch.float64, device=device)
    mu = params["offset"] * torch.randn(d, generator=gen, device=device, dtype=torch.float64)
    qt, sf, muf = q.T.float().contiguous(), s.float(), mu.float()
    gen.manual_seed(rank_seed(seed, rank))
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    for r0 in range(0, n, block):
        rows = min(block, n - r0)
        z = torch.randn((rows, d), generator=gen, device=device, dtype=torch.float32)
        z.mul_(sf)
        torch.matmul(z, qt, out=x[r0:r0 + rows])
        x[r0:r0 + rows].add_(muf)
        del z
    return x


def column_sums(x: torch.Tensor) -> torch.Tensor:
    """The float64 column sums of ``x``, block by block in row order."""
    total = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for r0 in range(0, int(x.shape[0]), SUM_ROWS):
        total += x[r0:r0 + SUM_ROWS].double().sum(dim=0)
    return total
