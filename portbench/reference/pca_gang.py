"""Plain PCA of a gang's rows, the reference of the gang PCA cells.

The program's ranks each hold their own rows (``planted_ranks.make`` with
``rank=r``); this reference fits all of them as one matrix, the textbook
way, in float64: each rank's rows replayed on the device that made them
(card r; on the CPU, the CPU) once the ranks have exited, rank 0's rows
the ones the run holds; the column mean of all of them; the centred Gram
summed over row blocks, each rank's on its own device, then over the
ranks; ``torch.linalg.eigh``; the top ``k`` eigenvectors in descending
order and their eigenvalues over the covariance's trace. ``precision``
runs the same code in float32 with IEEE or TF32 products, as
``reference/pca.py`` does; ``ranks`` fits some ranks alone (the
dropped-rank fault). Beside the fit it returns each replayed shard's
float64 column sums (``shard_sums``), which a run holds to the sums each
rank reported of the rows it fitted.

It imports nothing of the program; answers are read and judged as
``reference/pca.py`` reads and judges them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from portbench.reference import planted_ranks
from portbench.reference.lower import matmul
from portbench.reference.pca import BLOCK_ROWS, as_answer, judge_fit, read_fit  # noqa: F401

__all__ = ["fit", "read_fit", "as_answer", "judge_fit"]


def _shards(x: torch.Tensor, config: dict, seed: int) -> list:
    """Every rank's rows: ``x`` for rank 0, the others replayed where the
    gang made them: rank r's on card r, or on ``x``'s device off the card."""
    if config["generator"] != "planted_ranks":
        raise ValueError(f"the gang reference replays planted_ranks rows, not {config['generator']!r}")
    ranks = int(config["ranks"])
    if x.is_cuda and torch.cuda.device_count() < ranks:
        raise ValueError(f"the replay of {ranks} ranks takes a card each; found {torch.cuda.device_count()}")
    out = [x]
    for r in range(1, ranks):
        device = torch.device("cuda", r) if x.is_cuda else x.device
        out.append(planted_ranks.make(config, config["data"], seed, device, rank=r))
    return out


def fit(x: torch.Tensor, config: dict, seed: int, precision: str = "float64",
        ranks: Optional[Sequence[int]] = None) -> dict:
    """``{"pc": (d, k), "ev": (k,), "shard_sums": (ranks, d)}`` tensors,
    the fit on ``x``'s device."""
    k = int(config["estimator"]["params"]["k"])
    dtype = torch.float64 if precision == "float64" else torch.float32
    rows = _shards(x, config, seed)
    sums = torch.stack([planted_ranks.column_sums(xr).to(x.device) for xr in rows])
    use = list(range(len(rows))) if ranks is None else list(ranks)
    n, d = sum(int(rows[r].shape[0]) for r in use), int(x.shape[1])
    total = torch.zeros(d, dtype=dtype, device=x.device)
    for r in use:
        for r0 in range(0, int(rows[r].shape[0]), BLOCK_ROWS):
            total += rows[r][r0:r0 + BLOCK_ROWS].to(dtype).sum(dim=0).to(x.device)
    mean = total / n
    gram = torch.zeros((d, d), dtype=dtype, device=x.device)
    for r in use:
        xr, mr = rows[r], mean.to(rows[r].device)
        part = torch.zeros((d, d), dtype=dtype, device=xr.device)
        for r0 in range(0, int(xr.shape[0]), BLOCK_ROWS):
            b = xr[r0:r0 + BLOCK_ROWS].to(dtype) - mr
            part += matmul(b.T, b, tf32=precision == "tf32")
            del b
        gram += part.to(x.device)
    del rows
    cov = gram / (n - 1)
    w, v = torch.linalg.eigh(cov)
    w, v = torch.flip(w, (0,))[:k], torch.flip(v, (1,))[:, :k]
    return {"pc": v, "ev": torch.clamp(w, min=0) / torch.trace(cov), "shard_sums": sums.cpu()}
