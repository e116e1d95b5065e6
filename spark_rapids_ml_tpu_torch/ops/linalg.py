"""Core GEMM ops — port of the reference's ``ops/linalg.py``.

The reference leaves these to XLA outside any Pallas kernel, so here they
are plain ``torch.matmul`` through the precision chokepoint
(:mod:`spark_rapids_ml_tpu_torch.ops.precision`), which cuBLAS runs on the
card:
  - ``gemm_syrk``    C = BᵀB       (the reference's JNI ``dgemm``)
  - ``project_rows`` C = X·pc      (the device-resident row projection)
  - ``gemm_project`` C = AᵀB       (the reference's JNI ``dgemm_b``)
  - ``soft_threshold``             the L1 prox of both FISTA solvers
  - ``triu_to_full``               packed upper triangle -> full symmetric

Hopper computes float64 natively, so a float64 request is met in
float64: ``precision="auto"`` never resolves to the reference's
double-float emulation (``"dd"``), and an explicit ``"dd"`` means float64
on the ordinary route.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops.precision import make_dot

PRECISIONS = (
    "auto", "default", "high", "highest", "dd",
    "f32", "bf16x3", "bf16",
)


def validate_precision(value: str) -> str:
    """Shared setter-side validation for the user-facing precision params."""
    if value not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {'/'.join(PRECISIONS)}, got {value!r}"
        )
    return value


def resolve_precision(requested: str, input_dtype=None) -> str:
    """Resolve a user-facing precision request to a concrete mode.

    ``"auto"`` resolves to ``"highest"`` whatever the input dtype: float64
    input computes in native float64 (the reference resolves the same way
    with x64 on). Explicit requests pass through unchanged; ``input_dtype``
    is accepted for call-site parity with the reference."""
    validate_precision(requested)
    return "highest" if requested == "auto" else requested


def gemm_syrk(b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """C = BᵀB for row-major B (rows, cols) -> (cols, cols)."""
    return make_dot(precision)(b.T, b)


def project_rows(x: torch.Tensor, pc: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """C = X·pc — the row projection of ``PCAModel.transform``."""
    return make_dot(precision)(x, pc)


def gemm_project(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """C = AᵀB — the batched projection kernel."""
    return make_dot(precision)(a.T, b)


def soft_threshold(v: torch.Tensor, t) -> torch.Tensor:
    """Proximal operator of t·||.||₁: sign(v) · max(|v| − t, 0)."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def _triu_indices_packed(n: int):
    """(row, col) indices in the packed-upper column-major order: element
    (i, j), i <= j, at ``j(j+1)/2 + i`` (cuBLAS ``Dspr`` FILL_MODE_UPPER,
    Spark's ``BLAS.spr``)."""
    cols = np.concatenate([np.full(j + 1, j) for j in range(n)])
    rows = np.concatenate([np.arange(j + 1) for j in range(n)])
    return rows, cols


def triu_to_full(packed: torch.Tensor) -> torch.Tensor:
    """Packed upper triangle -> the full symmetric matrix; n comes from
    the length n(n+1)/2."""
    nt = int(packed.shape[0])
    n = (math.isqrt(8 * nt + 1) - 1) // 2
    if n * (n + 1) // 2 != nt:
        raise ValueError(f"packed length {nt} is not triangular")
    rows, cols = _triu_indices_packed(n)
    full = torch.zeros((n, n), dtype=packed.dtype, device=packed.device)
    full[torch.from_numpy(rows).to(full.device), torch.from_numpy(cols).to(full.device)] = packed
    return full + torch.triu(full, diagonal=1).T
