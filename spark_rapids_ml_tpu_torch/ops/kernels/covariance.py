"""Kernel K1: the centered Gram ``(x − mean)ᵀ(x − mean)`` on Hopper.

Replaces the TPU kernel ``spark_rapids_ml_tpu/ops/pallas/covariance.py``
(``centered_gram_pallas``, body ``_cov_kernel``): rows streamed, centered
on load, accumulated at full precision in the input type (float32 or
float64; Hopper has a float64 path, Mosaic had none).

Bound on the card: the Gram does ``n·d·(d+1)`` flops over ``n·d`` inputs,
so at the main path's widths (d = 1024) it is bound by operations — fp32
outside the tensor cores, the ``highest`` mode's IEEE products — not by
bytes. Design (source: ``csrc/centered_gram.cu``): the (d, d) accumulator
that the TPU kernel kept in VMEM does not fit a Hopper block, so the
kernel tiles the output instead — one block per upper-triangular 64×64
tile and row chunk (split-K over rows, enough chunks to put several
blocks on every SM), partials to an ``[S, d, d]`` workspace, then a small
kernel that sums them in a fixed order and mirrors the upper triangle.
Deterministic, exactly symmetric, no atomics, no padding of ``x``.

``centered_gram_cuda`` takes the plain version only for a tensor on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from spark_rapids_ml_tpu_torch.ops.kernels import _build

NAME = "centered_gram"

#: Launches of the kernel since the last reset (the CPU route does not count).
launches = 0

#: Rows per shared-memory step of the kernel (``BK`` in the source).
ROWS_PER_STEP = 32
#: Edge of the kernel's output tile (``TILE`` in the source).
TILE = 64
#: Rows one block should walk, about: enough work per block to amortize
#: its tile load, small enough for many waves of blocks.
ROWS_PER_BLOCK = 2048
#: Cap on the partials workspace.
WORKSPACE_BYTES = 512 << 20

_SYMBOLS = {torch.float32: "centered_gram_f32", torch.float64: "centered_gram_f64"}


def centered_gram_plain(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``(x − mean)ᵀ(x − mean)``."""
    b = x - mean
    return b.T @ b


def plan_splits(n: int, d: int, itemsize: int, sms: int) -> int:
    """Row chunks (split-K) for an (n, d) input on a card with ``sms`` SMs:
    at least two blocks per SM where the rows allow it, about
    :data:`ROWS_PER_BLOCK` rows per block for large ``n``, at least
    :data:`ROWS_PER_STEP` rows per chunk, and the workspace under
    :data:`WORKSPACE_BYTES`."""
    tiles = -(-d // TILE)
    pairs = tiles * (tiles + 1) // 2
    splits = max(-(-2 * sms // pairs), -(-n // ROWS_PER_BLOCK))
    splits = min(splits, -(-n // ROWS_PER_STEP), 65535)
    splits = min(splits, WORKSPACE_BYTES // max(1, d * d * itemsize))
    return max(1, splits)


def _check(x: torch.Tensor, mean: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (n, d), got shape {tuple(x.shape)}")
    if mean.dim() != 1 or mean.shape[0] != x.shape[1]:
        raise ValueError(f"mean must have shape ({x.shape[1]},), got {tuple(mean.shape)}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"centered_gram takes float32 or float64, got {x.dtype}")
    if mean.dtype != x.dtype:
        raise TypeError(f"mean dtype {mean.dtype} != x dtype {x.dtype}")
    if mean.device != x.device:
        raise ValueError(f"mean is on {mean.device}, x on {x.device}")
    if not x.is_contiguous() or not mean.is_contiguous():
        raise ValueError("centered_gram needs contiguous (row-major) x and mean")


def centered_gram_cuda(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """``(x − mean)ᵀ(x − mean)`` as a (d, d) tensor in ``x.dtype``: the
    hand-written kernel on a CUDA tensor, the plain version on a CPU one."""
    global launches
    _check(x, mean)
    if x.device.type == "cpu":
        return centered_gram_plain(x, mean)
    if x.device.type != "cuda":
        raise ValueError(f"centered_gram runs on CUDA or CPU tensors, got {x.device}")
    n, d = int(x.shape[0]), int(x.shape[1])
    out = torch.empty((d, d), dtype=x.dtype, device=x.device)
    if n == 0 or d == 0:
        return out.zero_()
    lib = _build.load(NAME)
    fn = getattr(lib, _SYMBOLS[x.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = plan_splits(n, d, x.element_size(), sms)
    rows_per_split = -(-n // splits)
    with torch.cuda.device(x.device):
        ws = torch.empty((splits, d, d), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), mean.data_ptr(), ws.data_ptr(), out.data_ptr(),
            n, d, splits, rows_per_split, stream,
        )
    if err != 0:
        raise RuntimeError(f"centered_gram kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def reset_launches() -> None:
    global launches
    launches = 0
