"""The control's precision: float32 matrix products in TF32.

The configurations state float32 with IEEE products (TF32 off). The
control computes the plain reference one step below that: TF32, which
keeps 10 of float32's 23 mantissa bits in each operand of a product. On a
CUDA tensor the card's TF32 path does it (``allow_tf32`` for the call).
On the CPU, which has none, the operands are rounded to TF32 (to
nearest, ties to even) and multiplied in float32: the card's rounding of
the operands, but not its accumulation, which over a long inner
dimension lowers a Gram's diagonal more than the rounding does (by
1.9e-3 of itself over 1,048,576 rows on an H100, against 3e-8 from the
rounding alone).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) with each mantissa rounded to TF32's 10 bits."""
    bits = t.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + keep) & ~0x1FFF
    return rounded.view(torch.float32)


@contextmanager
def products(tf32: bool):
    """Float32 products of the block in TF32 (``tf32``) or IEEE float32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``a @ b``; with ``tf32`` and float32 operands, in TF32."""
    if not tf32 or a.dtype != torch.float32:
        return a @ b
    if a.is_cuda:
        with products(True):
            return a @ b
    return round_tf32(a) @ round_tf32(b)
