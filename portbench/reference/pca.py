"""Plain PCA, the reference of the PCA cells.

The fit is the textbook one, in float64 on the rows' device: column
means, the centred Gram summed over row blocks (so a float64 copy of one
block exists at a time), ``torch.linalg.eigh`` of the covariance, the
top ``k`` eigenvectors in descending order and their eigenvalues over the
covariance's trace. ``precision`` runs the
same code in float64 (the reference), float32 with IEEE products, or
float32 with TF32 products (the control).

It imports nothing of the program. It reads the program's answers only
through the fitted model's public fields, to judge them. Components are compared up to each column's sign, which PCA leaves
free: the sign that brings the program's column nearer the reference's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from portbench.reference.lower import matmul

BLOCK_ROWS = 1 << 20


def _finite(value) -> float:
    """A gap as a float; NaN reads as infinitely far."""
    value = float(value)
    return value if value == value else float("inf")


def _dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def fit(x: torch.Tensor, config: dict, seed: int, precision: str = "float64") -> dict:
    """``{"pc": (d, k), "ev": (k,)}`` tensors on ``x``'s device (PCA
    draws nothing: ``seed`` is unused)."""
    k = int(config["estimator"]["params"]["k"])
    dtype = _dtype(precision)
    n, d = int(x.shape[0]), int(x.shape[1])
    total = torch.zeros(d, dtype=dtype, device=x.device)
    for r0 in range(0, n, BLOCK_ROWS):
        total += x[r0:r0 + BLOCK_ROWS].to(dtype).sum(dim=0)
    mean = total / n
    gram = torch.zeros((d, d), dtype=dtype, device=x.device)
    for r0 in range(0, n, BLOCK_ROWS):
        b = x[r0:r0 + BLOCK_ROWS].to(dtype) - mean
        gram += matmul(b.T, b, tf32=precision == "tf32")
        del b
    cov = gram / (n - 1)
    w, v = torch.linalg.eigh(cov)
    w, v = torch.flip(w, (0,))[:k], torch.flip(v, (1,))[:, :k]
    return {"pc": v, "ev": torch.clamp(w, min=0) / torch.trace(cov)}


def read_fit(model) -> dict:
    """The program's fitted model, as host float64 (an answer already in
    this form, as a stand-in in the program's place gives, as it is)."""
    if isinstance(model, dict):
        return model
    return {"pc": np.asarray(model.pc, dtype=np.float64),
            "ev": np.asarray(model.explainedVariance, dtype=np.float64)}


def as_answer(model: dict) -> dict:
    """A reference (or control) fit in :func:`read_fit`'s form."""
    return {key: value.double().cpu().numpy() for key, value in model.items()}


def judge_fit(answers: Sequence[dict], ref: dict) -> dict:
    """The worst component gap (absolute, each column at its nearer sign)
    and the worst explained-variance ratio gap (relative), over every fit
    compared."""
    pc_gap, ev_gap = 0.0, 0.0
    for got in answers:
        if got["pc"].shape != ref["pc"].shape or got["ev"].shape != ref["ev"].shape:
            return {"pc_max_abs": float("inf"), "ev_max_rel": float("inf")}
        signs = np.where(np.sum(got["pc"] * ref["pc"], axis=0) < 0, -1.0, 1.0)
        pc_gap = max(pc_gap, _finite(np.max(np.abs(got["pc"] * signs - ref["pc"]))))
        ev_gap = max(ev_gap, _finite(np.max(np.abs(got["ev"] - ref["ev"]) / ref["ev"])))
    return {"pc_max_abs": pc_gap, "ev_max_rel": ev_gap}
