"""Kernel K1: the centered Gram ``(x − mean)ᵀ(x − mean)`` on Hopper.

Replaces the TPU kernel ``spark_rapids_ml_tpu/ops/pallas/covariance.py``
(``centered_gram_pallas``, body ``_cov_kernel``): rows streamed, centered
on load, accumulated at full precision in the input type (float32 or
float64; Hopper has a float64 path, Mosaic had none).

Bound on the card: the Gram does ``n·d·(d+1)`` flops over ``n·d`` inputs,
so at the main path's widths (d = 1024) it is bound by operations — fp32
outside the tensor cores, the ``highest`` mode's IEEE products, and fp64
at the tensor-core rate — not by bytes. Design (source:
``csrc/centered_gram.cu``): the (d, d) accumulator that the TPU kernel
kept in VMEM does not fit a Hopper block, so the kernel tiles the output
instead — one block per upper-triangular 128×128 tile and row chunk
(split-K over rows), partials to an ``[S, d, d]`` workspace, then a small
kernel that sums them in a fixed order and mirrors the upper triangle.
float32 runs a register-blocked SIMT kernel (8×8 IEEE FMAs a thread, rows
copied by ``cp.async`` through a ring of three shared-memory buffers),
float64 the fp64 tensor cores (m16n8k4 ``mma.sync``); both centre the rows
before any product. :func:`plan_splits` picks the chunk count that fills
whole waves of the blocks the card holds at once, with no chunk longer
than :data:`MAX_ROWS_PER_SPLIT` rows: a running fp32 sum's rounding error
grows with its length. Where the workspace cap allows fewer chunks than
that needs (wide d), the wrapper runs the kernel on row slices and adds
their Grams in order. Deterministic, exactly symmetric, no atomics, no
padding of ``x``.

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

#: Edge of the kernel's output tile, by type (``F32_TILE``, ``F64_TILE``
#: in the source).
TILE = {torch.float32: 128, torch.float64: 128}
#: Rows per shared-memory step, by type (``F32_BK``, ``F64_BK``).
ROWS_PER_STEP = {torch.float32: 16, torch.float64: 8}
#: Fewest rows of a row chunk, so a block's loop outweighs its prologue
#: and its tile's write to the workspace.
MIN_ROWS_PER_SPLIT = 512
#: Most rows of a row chunk, the length of each thread's running sums.
#: The fp32 error grows with it: at 262,144 x 8,192 (H100, planted data)
#: one chunk gave 9.0e-5 of max |G| from the float64 Gram, chunks of
#: 65,536 rows 1.2e-5, of 32,768 rows 5.2e-6; the library call 1.5e-5.
MAX_ROWS_PER_SPLIT = 32768
#: Most waves of blocks :func:`plan_splits` considers.
MAX_WAVES = 8
#: Cap on the partials workspace.
WORKSPACE_BYTES = 512 << 20

_SYMBOLS = {torch.float32: "centered_gram_f32", torch.float64: "centered_gram_f64"}
_resident: dict = {}  # (device index, dtype) -> blocks per SM


def cost(n: int, d: int, dtype: torch.dtype) -> dict:
    """The work of one centered Gram, whichever route computes it (the
    count the cost ledger records and the bound column of the kernel table
    uses): n·d·(d+1) operations (the symmetric half, two per FMA); x and
    the mean read once, the (d, d) Gram written once."""
    item = torch.empty((), dtype=dtype).element_size()
    return {"flops": float(n * d * (d + 1)), "transcendentals": 0.0,
            "bytes_accessed": float((n * d + d + d * d) * item)}


def centered_gram_plain(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``(x − mean)ᵀ(x − mean)``."""
    b = x - mean
    return b.T @ b


def plan_splits(n: int, d: int, dtype: torch.dtype, sms: int, blocks_per_sm: int) -> int:
    """Row chunks (split-K) for an (n, d) input on a card with ``sms`` SMs
    that each hold ``blocks_per_sm`` of the type's tile blocks at once: of
    the counts that give 1 to :data:`MAX_WAVES` waves, the one whose
    ``pairs × splits`` blocks fill their last wave best (the fewest chunks
    on a tie), with at most one chunk per :data:`MIN_ROWS_PER_SPLIT` rows,
    at least one per :data:`MAX_ROWS_PER_SPLIT` rows, and the workspace
    under :data:`WORKSPACE_BYTES` (which wins); at least 1."""
    tiles = -(-d // TILE[dtype])
    pairs = tiles * (tiles + 1) // 2
    slots = max(1, sms * blocks_per_sm)
    cap = split_cap(n, d, dtype)
    floor = min(-(-n // MAX_ROWS_PER_SPLIT), cap)
    best, best_fill = floor, 0.0
    for waves in range(1, MAX_WAVES + 1):
        splits = min(max(floor, 1, waves * slots // pairs), cap)
        blocks = pairs * splits
        fill = blocks / (-(-blocks // slots) * slots)
        if fill > best_fill:
            best, best_fill = splits, fill
    return best


def split_cap(n: int, d: int, dtype: torch.dtype) -> int:
    """Most row chunks of one launch: one per :data:`MIN_ROWS_PER_SPLIT`
    rows, the ``[S, d, d]`` workspace under :data:`WORKSPACE_BYTES`."""
    itemsize = torch.finfo(dtype).bits // 8
    return max(1, min(n // MIN_ROWS_PER_SPLIT, WORKSPACE_BYTES // max(1, d * d * itemsize), 65535))


def launch_rows(n: int, d: int, dtype: torch.dtype) -> int:
    """Rows of one launch: all ``n`` unless the workspace cap leaves chunks
    longer than :data:`MAX_ROWS_PER_SPLIT`; then slices of cap × that."""
    return min(n, split_cap(n, d, dtype) * MAX_ROWS_PER_SPLIT)


def _blocks_per_sm(lib: ctypes.CDLL, dtype: torch.dtype, device: torch.device) -> int:
    """Resident tile-kernel blocks per SM, from the CUDA occupancy API (the
    registers and shared memory of the build), once per device and type."""
    key = (device.index, dtype)
    if key not in _resident:
        fn = lib.centered_gram_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        got = fn(int(dtype == torch.float64))
        if got <= 0:
            raise RuntimeError(f"centered_gram occupancy query failed: {got}")
        _resident[key] = got
    return _resident[key]


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
    if n == 0 or d == 0:
        return torch.zeros((d, d), dtype=x.dtype, device=x.device)
    lib = _build.load(NAME)
    fn = getattr(lib, _SYMBOLS[x.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    step = launch_rows(n, d, x.dtype)
    out = None
    with torch.cuda.device(x.device):
        device = torch.device("cuda", torch.cuda.current_device())
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        per_sm = _blocks_per_sm(lib, x.dtype, device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for row0 in range(0, n, step):
            xs = x[row0:row0 + step]
            rows = int(xs.shape[0])
            splits = plan_splits(rows, d, x.dtype, sms, per_sm)
            ws = torch.empty((splits, d, d), dtype=x.dtype, device=x.device)
            part = torch.empty((d, d), dtype=x.dtype, device=x.device)
            err = fn(
                xs.data_ptr(), mean.data_ptr(), ws.data_ptr(), part.data_ptr(),
                rows, d, splits, -(-rows // splits), stream,
            )
            if err != 0:
                raise RuntimeError(f"centered_gram kernel launch failed: CUDA error {err}")
            launches += 1
            del ws
            out = part if out is None else out.add_(part)
    return out


def reset_launches() -> None:
    global launches
    launches = 0
