"""Plain KMeans, the reference of the KMeans cells.

Greedy k-means++ seeding and Lloyd's iterations as the program states
them, written again in plain torch on the rows' device in float64:

- seeding draws the first centre by the largest Gumbel score, then each
  further centre from ``2 + ceil(log2 k)`` candidates drawn with
  probability ∝ D² (Gumbel top-t) as the one that leaves the least
  potential. The draws are the program's own contract: float32 uniforms
  from a ``torch.Generator`` on the rows' device seeded with the
  estimator's seed, one vector of n for the first centre and one for
  each further one. The reference takes those uniforms and does all of
  its arithmetic in float64;
- Lloyd runs while some centre moved more than ``tol`` and fewer than
  ``maxIter`` iterations ran, an empty cluster keeping its centre; the
  cost is taken once more at the last centres.

``precision`` runs the same code in float64 (the reference), float32
with IEEE products, or float32 with TF32 products (the control). It
imports nothing of the program and reads the program's answers only
through the fitted model's public fields, to judge them.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from portbench.reference.lower import matmul

BLOCK_ROWS = 1 << 20


def _finite(value) -> float:
    """A gap as a float; NaN reads as infinitely far."""
    value = float(value)
    return value if value == value else float("inf")


def _sq_dists(xb: torch.Tensor, x2b: torch.Tensor, centers: torch.Tensor, precision: str) -> torch.Tensor:
    """(rows, k) squared distances by the Gram expansion, clamped at 0."""
    c2 = torch.sum(centers * centers, dim=1)
    xc = matmul(xb, centers.T, tf32=precision == "tf32")
    return torch.clamp(x2b[:, None] - 2.0 * xc + c2[None, :], min=0.0)


def _gumbel(n: int, gen: torch.Generator, device, dtype) -> torch.Tensor:
    u = torch.rand(n, generator=gen, dtype=torch.float32, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    u = u.to(dtype)
    return -torch.log(-torch.log(u))


def seed_centers(x: torch.Tensor, k: int, seed: int, precision: str = "float64") -> torch.Tensor:
    """Greedy k-means++ on the rows ``x`` (already in the working dtype)."""
    n = int(x.shape[0])
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    t = min(2 + max(int(math.ceil(math.log2(k))), 0), n)
    x2 = torch.sum(x * x, dim=1)
    first = int(torch.argmax(_gumbel(n, gen, x.device, x.dtype)))
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    min_d2 = _sq_dists(x, x2, x[first:first + 1], precision)[:, 0]
    for i in range(1, k):
        logw = torch.where(min_d2 > 0, torch.log(min_d2), torch.full_like(min_d2, -math.inf))
        top, cand = torch.topk(logw + _gumbel(n, gen, x.device, x.dtype), t)
        if not bool(torch.isfinite(top[0])):
            cand = torch.full_like(cand, first)
        d2c = _sq_dists(x, x2, x[cand], precision).T  # (t, n)
        pots = torch.sum(torch.minimum(min_d2[None, :], d2c), dim=1, dtype=torch.float64)
        best = int(torch.argmin(pots))
        centers[i] = x[cand[best]]
        min_d2 = torch.minimum(min_d2, d2c[best])
        del d2c
    return centers


def _pass(x: torch.Tensor, x2: torch.Tensor, centers: torch.Tensor, precision: str):
    """One assignment pass over row blocks: (sums, counts, cost). The sums
    and counts are float64 whatever the precision: only the products are
    in it (an atomic float32 sum of a cluster's 200,000 rows would err
    more than the products do)."""
    k, d = centers.shape
    sums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float64, device=x.device)
    cost = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, int(x.shape[0]), BLOCK_ROWS):
        xb, x2b = x[r0:r0 + BLOCK_ROWS], x2[r0:r0 + BLOCK_ROWS]
        d2 = _sq_dists(xb, x2b, centers, precision)
        labels = torch.argmin(d2, dim=1)
        cost += torch.sum(torch.gather(d2, 1, labels[:, None]), dtype=torch.float64)
        sums.index_add_(0, labels, xb.double())
        counts += torch.bincount(labels, minlength=k).double()
        del d2
    return sums, counts, cost


def fit(x: torch.Tensor, config: dict, seed: int, precision: str = "float64") -> dict:
    """``{"centers": (k, d), "cost": (), "iters": int}``."""
    params = config["estimator"]["params"]
    k, max_iter, tol = int(params["k"]), int(params["maxIter"]), float(params["tol"])
    xw = x.to(torch.float64 if precision == "float64" else torch.float32)
    x2 = torch.sum(xw * xw, dim=1)
    centers = seed_centers(xw, k, seed, precision)
    it, moved = 0, math.inf
    while it < max_iter and moved > tol * tol:
        sums, counts, _ = _pass(xw, x2, centers, precision)
        means = (sums / torch.clamp(counts, min=1.0)[:, None]).to(centers.dtype)
        new = torch.where(counts[:, None] > 0, means, centers)
        moved = float(torch.max(torch.sum((new - centers) ** 2, dim=1)))
        centers, it = new, it + 1
    return {"centers": centers, "cost": _pass(xw, x2, centers, precision)[2], "iters": it}


def read_fit(model) -> dict:
    """The program's fitted model, as host float64 (an answer already in
    this form, as a stand-in in the program's place gives, as it is)."""
    if isinstance(model, dict):
        return model
    return {"centers": np.asarray(model.clusterCenters(), dtype=np.float64),
            "cost": float(model.trainingCost), "iters": int(model.numIter)}


def as_answer(model: dict) -> dict:
    """A reference (or control) fit in :func:`read_fit`'s form."""
    return {"centers": model["centers"].double().cpu().numpy(), "cost": float(model["cost"]),
            "iters": int(model["iters"])}


def judge_fit(answers: Sequence[dict], ref: dict) -> dict:
    """The worst centre gap (absolute, centre by centre in seeding order),
    the worst cost gap (relative) and the count of fits whose iteration
    count differs, over every fit compared."""
    centers_gap, cost_gap, iters_off = 0.0, 0.0, 0
    for got in answers:
        if got["centers"].shape != ref["centers"].shape:
            return {"centers_max_abs": float("inf"), "cost_rel": float("inf"), "iters_off": len(answers)}
        centers_gap = max(centers_gap, _finite(np.max(np.abs(got["centers"] - ref["centers"]))))
        cost_gap = max(cost_gap, _finite(abs(got["cost"] - ref["cost"]) / ref["cost"]))
        iters_off += int(got["iters"] != ref["iters"])
    return {"centers_max_abs": centers_gap, "cost_rel": cost_gap, "iters_off": iters_off}
