"""Core GEMM ops — port of the reference's ``ops/linalg.py``.

The reference leaves these to XLA outside any Pallas kernel, so here they
are plain ``torch.matmul`` through the precision chokepoint
(:mod:`spark_rapids_ml_tpu_torch.ops.precision`), which cuBLAS runs on the
card:
  - ``gemm_syrk``    C = BᵀB       (the reference's JNI ``dgemm``)
  - ``project_rows`` C = X·pc      (the device-resident row projection)
  - ``gemm_project`` C = AᵀB       (the reference's JNI ``dgemm_b``)

Hopper computes float64 natively, so a float64 request is met in
float64: ``precision="auto"`` never resolves to the reference's
double-float emulation (``"dd"``), and an explicit ``"dd"`` means float64
on the ordinary route.
"""

from __future__ import annotations

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
