"""Covariance ops — port of the reference's ``ops/covariance.py``.

Centering, scaling and the rank-n update as plain tensor code: on the
card ``torch.matmul`` runs the Gram on cuBLAS (the reference leaves the
same product to XLA). The hand-written Gram kernel that stands in for the
reference's Pallas kernel lives in
:mod:`spark_rapids_ml_tpu_torch.ops.kernels.covariance`.

Both paths normalize by (n_rows − 1), as the reference does.
"""

from __future__ import annotations

import torch

from spark_rapids_ml_tpu_torch.ops.precision import make_dot


def centered_gram(x: torch.Tensor, mean: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """(x − mean)ᵀ(x − mean) — the per-partition covariance partial."""
    b = x - mean
    return make_dot(precision)(b.T, b)


def mean_and_covariance(x: torch.Tensor, precision: str = "highest"):
    """Single-device fused path: returns (column means, covariance / (n − 1))."""
    n = x.shape[0]
    mean = torch.mean(x, dim=0)
    cov = centered_gram(x, mean, precision=precision) / (n - 1)
    return mean, cov


def welford_init(d: int, dtype=torch.float64, device=None) -> tuple:
    """(count, mean, M2) accumulator for streaming column stats — the
    contract of mllib ``Statistics.colStats``."""
    return (
        torch.zeros((), dtype=dtype, device=device),
        torch.zeros((d,), dtype=dtype, device=device),
        torch.zeros((d,), dtype=dtype, device=device),
    )


def welford_add_block(state: tuple, x: torch.Tensor) -> tuple:
    """Merge one block's column stats into ``state`` (Chan et al.)."""
    count, mean, m2 = state
    n_b = x.shape[0]
    if n_b == 0:  # an empty partition contributes nothing
        return state
    mean_b = torch.mean(x, dim=0)
    m2_b = torch.sum((x - mean_b) ** 2, dim=0)
    new_count = count + n_b
    delta = mean_b - mean
    new_mean = mean + delta * (n_b / new_count)
    new_m2 = m2 + m2_b + delta**2 * (count * n_b / new_count)
    return (new_count, new_mean, new_m2)
