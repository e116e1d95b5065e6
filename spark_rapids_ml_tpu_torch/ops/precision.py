"""Named GEMM precision modes — port of the reference's ``ops/precision.py``.

  ``f32`` / ``highest``  IEEE fp32 products, TF32 off (the reference's
                         ``Precision.HIGHEST``). On the card this mode
                         refuses to run with TF32 on.
  ``bf16x3`` / ``high``  the 3-pass compensated split: a = hi + lo with both
                         parts bf16-representable, A·B ≈ Ahi·Bhi + Ahi·Blo +
                         Alo·Bhi. Documented bound: max rel err ≤ 2e-4.
  ``bf16`` / ``default`` operands rounded to bf16, products accumulated in
                         fp32. Documented bound: max rel err ≤ 3e-2.

bf16 operands are carried in fp32 containers and multiplied in fp32, which
gives the reference's "bf16 multiply, fp32 accumulate" numbers exactly
(the product of two bf16 values is exact in fp32). float64 operands are
multiplied in float64 in every mode, as the reference does under x64.

:func:`resolve_policy` is reduced to "explicit request, else default";
the reference's environment knobs and autotuned decisions wait for a
later slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

MODES = ("f32", "bf16x3", "bf16")
LEGACY = ("default", "high", "highest")

#: Documented parity bounds vs the f32 product (max |err| / max |ref|).
REL_TOL = {"bf16x3": 2e-4, "bf16": 3e-2}


def validate_mode(value: str) -> str:
    if value not in MODES + LEGACY:
        raise ValueError(
            f"precision mode must be one of {'/'.join(MODES + LEGACY)}, got {value!r}"
        )
    return value


def split_hi_lo(a: torch.Tensor):
    """bf16 hi/lo split in the input's container: ``a == hi + lo`` exactly,
    ``hi`` the bf16 rounding of ``a``. Not safe on non-finite values."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    return hi, a - hi


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def _dot_highest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and a.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "precision 'highest' needs IEEE fp32 products; "
            "torch.backends.cuda.matmul.allow_tf32 is True"
        )
    return torch.matmul(a, b)


def _dot_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.float64 in (a.dtype, b.dtype):
        return _dot_highest(a, b)
    a_hi, a_lo = split_hi_lo(a)
    b_hi, b_lo = split_hi_lo(b)
    return (
        _dot_highest(_bf16(a_hi), _bf16(b_hi))
        + _dot_highest(_bf16(a_hi), _bf16(b_lo))
        + _dot_highest(_bf16(a_lo), _bf16(b_hi))
    ).to(a.dtype)


def _dot_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.float64 in (a.dtype, b.dtype):
        return _dot_highest(a, b)
    return _dot_highest(_bf16(a), _bf16(b)).to(a.dtype)


def make_dot(precision: str) -> Callable:
    """The one chokepoint mapping a mode name to a matmul-like callable."""
    if precision in ("bf16x3", "high"):
        return _dot_bf16x3
    if precision in ("bf16", "default"):
        return _dot_bf16
    if precision in ("f32", "highest", "dd"):
        # "dd" is the reference's fp64 emulation; Hopper multiplies the
        # float64 operands the dd routes feed it natively.
        return _dot_highest
    raise ValueError(f"no GEMM for precision {precision!r}")


def pallas_precision(precision: str) -> str:
    """Map a policy mode onto the KMeans kernels' vocabulary (``highest``
    / ``high`` / ``default``): ``f32`` → ``highest``, ``bf16x3`` → ``high``
    (the 3-pass split), ``bf16`` → ``default`` (one bf16 pass); the legacy
    names pass through."""
    return {"f32": "highest", "bf16x3": "high", "bf16": "default"}.get(precision, precision)


def resolve_policy(
    family: str, requested: Optional[str] = None, default: str = "highest"
) -> str:
    """The precision mode for an op family: the explicit request when
    there is one (``"auto"`` and ``"dd"`` pass through to their own
    resolution downstream), else ``default``."""
    if requested is None:
        return default
    if requested in ("auto", "dd"):
        return requested
    return validate_mode(requested)
