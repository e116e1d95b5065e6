"""Kernels K2 and K3: fused KMeans assignment + update statistics on Hopper,
and the Lloyd loop around them; kernel K5: the k-means++ seeding's steps.

Replaces the TPU kernels of ``spark_rapids_ml_tpu/ops/pallas/kmeans.py``:
``assign_stats_fused`` (K2, ``csrc/kmeans_assign_stats.cu``) and
``assign_stats_packed`` (K3, ``csrc/kmeans_assign_packed.cu``), plus the
Lloyd loop ``lloyd_fused``. Both kernels take row-major (n, d) float32 and
return ``(sums (k, d), counts (k,), cost, c2 (k,))`` over the n real rows:
per row the scores ``c2 − 2·x·c``, the argmin (lowest index on ties),
then the cluster sums, integer counts (int64) and
``cost = Σ‖x‖² + Σ min score``, with the ``c2`` the kernel scored with.
The reference's transposed, padded ``(d_pad, n_pad)`` layout was a TPU
lane artifact and is not carried over (``pad_transposed`` has no
counterpart): the kernels mask the ragged edge themselves, so no padding
rows exist and the reference's closed-form padding correction in
``lloyd_fused`` drops out. No (n, k) array is written; no float atomics,
so every result is bitwise repeatable. Sources and bounds are in the
``.cu`` files.

Precision (``highest`` / ``high`` / ``default``, or the policy names
through :func:`pallas_precision`): IEEE fp32 products; the 3-pass bf16
hi/lo split (stats from ``x_hi + bf16(x − x_hi)``); one bf16-rounded pass
(stats from ``bf16(x)``). ``Σ‖x‖²`` and ``c2`` use the unrounded values.

K5 (``csrc/kmeans_seed.cu``, :func:`seed_plusplus`) replaces no TPU
kernel (the reference seeds in plain ``jnp``): each greedy k-means++ step
is two launches, K5a (``seed_select``: the distance update, the Gumbel
scores and their top t) and K5b (``seed_potentials``: the candidates'
float64 potentials and their argmin), with the chosen row kept on the
device, so the seeding makes no host sync. Its plain version is the torch
loop :func:`ops.kmeans.kmeans_plusplus_loop`, with the same draws.

Each wrapper takes its plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch.ops.kernels import _build
from spark_rapids_ml_tpu_torch.ops.kmeans import (
    kmeans_plusplus_loop,
    moved_above_tol,
    normalize_rows,
    seed_candidates,
)
from spark_rapids_ml_tpu_torch.ops.precision import make_dot, pallas_precision

FUSED_NAME = "kmeans_assign_stats"
PACKED_NAME = "kmeans_assign_packed"
SEED_NAME = "kmeans_seed"

#: Launches since the last reset, per kernel (the CPU route does not count).
launches = {"assign_stats_fused": 0, "assign_stats_packed": 0, "seed_select": 0, "seed_potentials": 0}

#: The kernels' precision codes (``PREC_*`` in ``csrc/kmeans_common.cuh``).
PRECISIONS = {"highest": 0, "high": 1, "default": 2}

#: K2's sort variant (``assign_stats_blocks`` in the source): threads of a
#: block (``BLOCK``) and its warps (``NW``); the most shared memory a Hopper
#: block may use.
FUSED_THREADS = 256
FUSED_WARPS = FUSED_THREADS // 32
MAX_SHARED_BYTES = 232_448
#: K2's warp variant (``assign_stats_warps``): rows a lane scores at each
#: register width, in "highest"/"default" and in "high" (``ROWS_16``,
#: ``ROWS_16_HIGH``, ...); the warps of a block at most (``WARPS_MAX``, and
#: ``WARPS_MAX_WIDE`` where a lane's rows take 128 registers or more) and
#: at least (``WARPS_MIN``: below it the sort variant runs); the bytes of
#: the cost's per-warp doubles (``RED_BYTES``).
FUSED_ROWS = {16: 4, 32: 2, 64: 1}
FUSED_ROWS_HIGH = {16: 2, 32: 1, 64: 1}
FUSED_WARPS_MAX = 12
FUSED_WARPS_MAX_WIDE = 8
FUSED_WARPS_MIN = 4
FUSED_RED_BYTES = 128
#: The cap on the partials workspace of a launch.
WORKSPACE_BYTES = 256 << 20

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def cost(n: int, d: int, k: int) -> dict:
    """The work of one assignment + statistics pass of K2 or K3 (and of
    their plain version; the count the cost ledger records and the bound
    column of the kernel table uses): 2·n·k·d operations (the score
    products, two per FMA); float32 x and centres read once, the sums,
    counts, cost and squared centre norms written once."""
    return {"flops": 2.0 * n * k * d, "transcendentals": 0.0,
            "bytes_accessed": float(4 * (n * d + k * d) + 4 * k * d + 8 * k + 4 + 4 * k)}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _register_width(d: int) -> int:
    """K2 holds a row in registers padded to 16, 32 or 64 features; past
    64 it reads the row from cache (0)."""
    return 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 0


def fused_shared_bytes(d: int, k: int) -> int:
    """Shared memory of a block of K2's sort variant (``smem_bytes`` in the
    source): the cost tree, the centers in two parts at the register
    width, c2, the block's (k, d) partial sums, its counts, the per-warp
    counts, the tile offsets and the row order."""
    ds = _register_width(d) or d
    return (
        8 * FUSED_THREADS
        + 4 * (2 * k * ds + k + k * d)
        + 4 * (k * (FUSED_WARPS + 2) + 1 + FUSED_THREADS)
    )


def fused_feasible(d: int, k: int) -> bool:
    """True when K2 can run at this (d, k): a block of its sort variant
    (:func:`fused_shared_bytes`) fits Hopper's 227 KB. The warp variant
    runs on a subset of these shapes (:func:`fused_warps`). The reference's
    10 MB VMEM rule (``auto_block_n``) does not carry over. At d = 16 this
    admits k up to about 1,000; the KMeans resolver sends larger fits to
    the ``xla`` route, and an explicit ``backend="fused"`` raises."""
    return d >= 1 and k >= 1 and fused_shared_bytes(d, k) <= MAX_SHARED_BYTES


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def fused_rows(dreg: int, mode: str) -> int:
    """Rows a lane of K2's warp variant scores at register width ``dreg``."""
    return (FUSED_ROWS_HIGH if mode == "high" else FUSED_ROWS)[dreg]


def fused_warp_shared_bytes(d: int, k: int, mode: str, warps: int) -> int:
    """Shared memory of a K2 warp-variant block (``warp_smem`` in the
    source): the cost's doubles, the centers' parts (two in "high"), c2,
    and per warp its stage of ``32·rows`` rows and its transpose buffer of
    16, each row ``dreg + 4`` floats, its (k + 1, dreg) sums and its
    counts, each 16-byte aligned."""
    dreg = _register_width(d)
    fixed = FUSED_RED_BYTES + 4 * ((2 if mode == "high" else 1) * k * dreg + _round4(k))
    per_warp = 4 * ((32 * fused_rows(dreg, mode) + 16) * (dreg + 4) + (k + 1) * dreg + _round4(k))
    return fixed + warps * per_warp


def fused_warps(d: int, k: int, mode: str) -> int:
    """Warps of a K2 block in the warp variant at (d, k, mode): as many as
    shared memory holds up to the cap, rounded down to a multiple of 4 (the
    same number on each of an SM's schedulers); 0 when the sort variant
    runs (d > 64, or fewer than :data:`FUSED_WARPS_MIN` warps fit)."""
    dreg = _register_width(d)
    if dreg == 0:
        return 0
    row_registers = fused_rows(dreg, mode) * dreg * (2 if mode == "high" else 1)
    cap = FUSED_WARPS_MAX_WIDE if row_registers >= 128 else FUSED_WARPS_MAX
    fixed = fused_warp_shared_bytes(d, k, mode, 0)
    if fixed >= MAX_SHARED_BYTES:
        return 0
    warps = min(cap, (MAX_SHARED_BYTES - fixed) // (fused_warp_shared_bytes(d, k, mode, 1) - fixed))
    warps -= warps % 4
    return warps if warps >= FUSED_WARPS_MIN else 0


def _packed_geometry(d_pad: int, k: int) -> Optional[Tuple[int, int, int]]:
    """(P, dg, kg) as the reference's ``_packed_geometry``: dg the group
    feature stride (16/32/64), P = 128 // dg, kg = 128 // P score slots;
    None when d_pad > 64 or k > kg."""
    for dg in (16, 32, 64):
        if d_pad <= dg:
            p = 128 // dg
            if k <= 128 // p:
                return p, dg, 128 // p
            return None
    return None


def packed_feasible(d: int, k: int) -> bool:
    """True when K3 (:func:`assign_stats_packed`) can run at this (d, k)."""
    return _packed_geometry(d + ((-d) % 8), k) is not None


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def split_parts(a: torch.Tensor, precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operand parts (hi, lo) a mode multiplies (``split`` in
    ``csrc/kmeans_common.cuh``): ``(a, 0)`` for highest, ``(bf16(a),
    bf16(a − hi))`` for high, ``(bf16(a), 0)`` for default."""
    if precision == "highest":
        return a, torch.zeros_like(a)
    hi = _bf16(a)
    return hi, (_bf16(a - hi) if precision == "high" else torch.zeros_like(a))


def stat_values(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The value each row adds to its cluster's sum in a mode: hi + lo."""
    if precision == "highest":
        return x
    hi, lo = split_parts(x, precision)
    return hi + lo


def assign_stats_plain(x: torch.Tensor, centers: torch.Tensor, precision: str = "highest") -> Stats:
    """The plain PyTorch version of K2 (and of K3): the same statistics
    through (n, k) matrices, at the mode's operand rounding."""
    precision = pallas_precision(precision)
    k = centers.shape[0]
    c2 = torch.sum(centers * centers, dim=1)
    scores = make_dot(precision)(x, centers.T)
    scores.mul_(-2.0).add_(c2[None, :])
    labels = torch.argmin(scores, dim=1)
    m = torch.gather(scores, 1, labels[:, None])[:, 0]
    del scores
    one_hot = torch.zeros((x.shape[0], k), dtype=x.dtype, device=x.device)
    one_hot.scatter_(1, labels[:, None], 1.0)
    sums = make_dot("highest")(one_hot.T, stat_values(x, precision))
    counts = torch.bincount(labels, minlength=k)
    # Σ‖x‖² + Σ min score, added row by row as the kernels do: the two
    # sums are each far larger than the cost, so adding them whole would
    # lose the cost to float32 rounding.
    cost = torch.sum(torch.sum(x * x, dim=1) + m)
    return sums, counts, cost, c2


def assign_stats_packed_plain(x: torch.Tensor, centers: torch.Tensor,
                              precision: str = "highest") -> Stats:
    """The plain version of K3: K3's statistics are K2's."""
    if not packed_feasible(x.shape[1], centers.shape[0]):
        raise ValueError(f"packing infeasible at d={x.shape[1]}, k={centers.shape[0]}")
    return assign_stats_plain(x, centers, precision)


def _check(x: torch.Tensor, centers: torch.Tensor, precision: str, what: str) -> str:
    if x.dim() != 2 or centers.dim() != 2:
        raise ValueError(f"{what}: x and centers must be 2-D, got {tuple(x.shape)}, {tuple(centers.shape)}")
    if centers.shape[1] != x.shape[1]:
        raise ValueError(f"{what}: centers width {centers.shape[1]} != x width {x.shape[1]}")
    if centers.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: needs k >= 1 and d >= 1, got {tuple(centers.shape)}")
    if x.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 x and centers, got {x.dtype} and {centers.dtype}")
    if centers.device != x.device:
        raise ValueError(f"{what}: centers are on {centers.device}, x on {x.device}")
    if not x.is_contiguous() or not centers.is_contiguous():
        raise ValueError(f"{what} needs contiguous (row-major) x and centers")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    mode = pallas_precision(precision)
    if mode not in PRECISIONS:
        raise ValueError(f"precision must be highest|high|default, got {precision!r}")
    return mode


_functions: dict = {}  # (library, symbol) -> the ctypes function, argtypes set


def _function(name: str, symbol: str, extra: int):
    """The launcher ``symbol`` of ``csrc/<name>.cu``, its C signature set
    once: (x, centers, n, d, k, *extra ints, prec, blocks, rows_per_block,
    8 pointers)."""
    key = (name, symbol)
    if key not in _functions:
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int] * extra
            + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_void_p] * 8
        )
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


_sm_counts: dict = {}  # device index -> streaming multiprocessors


def _sms(dev: torch.device) -> int:
    sms = _sm_counts.get(dev.index)
    if sms is None:
        sms = _sm_counts[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def _launch(name: str, symbol: str, x: torch.Tensor, centers: torch.Tensor, mode: str,
            unit: int, plan, extra: tuple = ()) -> Stats:
    """Allocates the outputs and the [S, k, d] partials, plans S by
    ``plan(device, n, sms)``, gives each block a multiple of ``unit`` rows,
    launches. The partials, counts and costs of the S blocks share one
    scratch allocation, and the four outputs are views of one more: the
    host's path up to the launch is part of every eager call."""
    n, d = int(x.shape[0]), int(x.shape[1])
    k = int(centers.shape[0])
    dev = x.device
    fn = _function(name, symbol, len(extra))
    blocks = plan(dev, n, _sms(dev))
    rows_per_block = -(-max(n, 1) // blocks)
    rows_per_block = -(-rows_per_block // unit) * unit
    blocks = max(1, -(-n // rows_per_block))
    counts_at = _aligned(4 * blocks * k * d)
    cost_at = counts_at + _aligned(4 * blocks * k)
    c2_at = _aligned(4 * k * d)
    cost_out_at = c2_at + _aligned(4 * k)
    counts_out_at = cost_out_at + 256
    with torch.cuda.device(dev):
        ws = torch.empty((cost_at + 8 * blocks,), dtype=torch.uint8, device=dev)
        out = torch.empty((counts_out_at + 8 * k,), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        base, obase = ws.data_ptr(), out.data_ptr()
        err = fn(
            x.data_ptr(), centers.data_ptr(), n, d, k, *extra, PRECISIONS[mode],
            blocks, rows_per_block, base, base + counts_at, base + cost_at,
            obase, obase + counts_out_at, obase + cost_out_at, obase + c2_at, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    sums = out[:4 * k * d].view(torch.float32).view(k, d)
    counts = out[counts_out_at:].view(torch.int64)
    cost = out[cost_out_at:cost_out_at + 4].view(torch.float32).view(())
    c2 = out[c2_at:c2_at + 4 * k].view(torch.float32)
    return sums, counts, cost, c2


def fused_unit(d: int, k: int, mode: str) -> int:
    """Rows a K2 block's share is a multiple of: a round of sub-tiles, one
    for each warp, in the warp variant (``32 · rows · warps``); a tile of
    :data:`FUSED_THREADS` rows in the sort variant."""
    warps = fused_warps(d, k, mode)
    return 32 * fused_rows(_register_width(d), mode) * warps if warps else FUSED_THREADS


def fused_blocks(n: int, unit: int, kd: int, sms: int, per_sm: int) -> int:
    """Blocks of a K2 launch: one wave, ``per_sm`` resident blocks on each
    of ``sms`` SMs, each walking a contiguous chunk of rows; no more than
    one per ``unit`` rows (:func:`fused_unit`); the [S, k, d] partials
    under :data:`WORKSPACE_BYTES`; at least 1."""
    return max(1, min(sms * per_sm, -(-n // unit), WORKSPACE_BYTES // max(1, 4 * kd)))


_fused_resident: dict = {}  # (device index, d, k, mode) -> resident K2 blocks per SM


def _fused_blocks_per_sm(device: torch.device, d: int, k: int, mode: str) -> int:
    """Resident K2 blocks per SM of the variant that runs at (d, k, mode),
    from the CUDA occupancy API, once per device and shape."""
    key = (device.index, d, k, mode)
    if key not in _fused_resident:
        fn = _build.load(FUSED_NAME).kmeans_assign_stats_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        with torch.cuda.device(device):
            got = fn(d, k, PRECISIONS[mode])
        if got <= 0:
            raise RuntimeError(f"kmeans_assign_stats occupancy query failed: {got}")
        _fused_resident[key] = got
    return _fused_resident[key]


def assign_stats_fused(x: torch.Tensor, centers: torch.Tensor, precision: str = "highest") -> Stats:
    """Kernel K2 on a CUDA tensor (its plain version on a CPU one):
    ``(sums (k, d), counts (k,) int64, cost, c2 (k,))`` over the n rows of
    row-major float32 ``x`` (n, d) against ``centers`` (k, d). Raises when
    the shared-memory rule (:func:`fused_feasible`) refuses (d, k). The
    warp variant runs where :func:`fused_warps` is positive, the sort
    variant elsewhere; both give the same statistics."""
    mode = _check(x, centers, precision, "assign_stats_fused")
    if x.device.type == "cpu":
        return assign_stats_plain(x, centers, mode)
    d, k = int(x.shape[1]), int(centers.shape[0])
    if not fused_feasible(d, k):
        raise ValueError(f"assign_stats_fused: d={d} x k={k} exceeds a block's shared memory")
    unit = fused_unit(d, k, mode)

    def plan(dev, n, sms):
        return fused_blocks(n, unit, k * d, sms, _fused_blocks_per_sm(dev, d, k, mode))

    out = _launch(FUSED_NAME, "kmeans_assign_stats", x, centers, mode, unit, plan)
    launches["assign_stats_fused"] += 1
    return out


#: Warps of a K3 block at each group width dg (``WARPS_16``, ``WARPS_32``,
#: ``WARPS_64`` in the source); each warp works alone on its own sub-tiles.
PACKED_WARPS = {16: 16, 32: 8, 64: 4}
_packed_resident: dict = {}  # (device index, dg, mode) -> resident K3 blocks per SM


def packed_threads(dg: int) -> int:
    """Threads of a K3 block at group width ``dg`` (``Geometry::THREADS``)."""
    return 32 * PACKED_WARPS[dg]


def packed_blocks(n: int, dg: int, sms: int, per_sm: int) -> int:
    """Blocks of a K3 launch: one wave, ``per_sm`` resident blocks on each
    of ``sms`` SMs, each walking a contiguous chunk of rows; no more than
    one per :func:`packed_threads` rows; at least 1."""
    return max(1, min(sms * per_sm, -(-n // packed_threads(dg))))


def _packed_blocks_per_sm(device: torch.device, dg: int, mode: str) -> int:
    """Resident K3 blocks per SM at (dg, mode), from the CUDA occupancy API
    (the registers and shared memory of the build), once per device. The
    aligned and misaligned variants share it, so both get one plan."""
    key = (device.index, dg, mode)
    if key not in _packed_resident:
        fn = _build.load(PACKED_NAME).kmeans_assign_packed_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
        with torch.cuda.device(device):
            got = fn(dg, PRECISIONS[mode])
        if got <= 0:
            raise RuntimeError(f"kmeans_assign_packed occupancy query failed: {got}")
        _packed_resident[key] = got
    return _packed_resident[key]


def assign_stats_packed(x: torch.Tensor, centers: torch.Tensor, precision: str = "highest") -> Stats:
    """Kernel K3, the small-d, small-k specialisation of K2, on a CUDA
    tensor (its plain version on a CPU one). Same contract and outputs as
    :func:`assign_stats_fused`; needs :func:`packed_feasible`."""
    mode = _check(x, centers, precision, "assign_stats_packed")
    d, k = int(x.shape[1]), int(centers.shape[0])
    geom = _packed_geometry(d + ((-d) % 8), k)
    if geom is None:
        raise ValueError(f"assign_stats_packed: packing infeasible at d={d}, k={k}")
    if x.device.type == "cpu":
        return assign_stats_packed_plain(x, centers, mode)
    dg = geom[1]

    def plan(dev, n, sms):
        return packed_blocks(n, dg, sms, _packed_blocks_per_sm(dev, dg, mode))

    out = _launch(PACKED_NAME, "kmeans_assign_packed", x, centers, mode, packed_threads(dg), plan,
                  (dg,))
    launches["assign_stats_packed"] += 1
    return out


def lloyd_fused(
    x: torch.Tensor,
    init_centers: torch.Tensor,
    max_iter: int = 20,
    tol: float = 1e-4,
    precision: str = "highest",
    cosine: bool = False,
    packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full Lloyd fit on K2 (or K3 with ``packed=True``; check
    :func:`packed_feasible` first): (centers, cost, n_iter), with
    :func:`ops.kmeans.lloyd`'s semantics — movement tolerance, empty
    clusters keep their center, cosine renormalisation, a final cost pass
    at the converged centers. ``x`` is (n, d) float32, row-major. The
    loop reads the movement once per iteration (one host sync each)."""
    assign = assign_stats_packed if packed else assign_stats_fused
    centers = init_centers.to(torch.float32).contiguous()
    moved = torch.tensor(math.inf, dtype=torch.float32)
    it = 0
    while moved_above_tol(moved, it, tol) and it < max_iter:
        sums, counts, _, _ = assign(x, centers, precision)
        counts = counts.to(torch.float32)
        new_centers = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers
        )
        if cosine:
            new_centers = normalize_rows(new_centers)
        moved = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        centers = new_centers.contiguous()
        it += 1
    _, _, cost, _ = assign(x, centers, precision)
    return centers, cost, it


#: K5's block (``THREADS`` in ``csrc/kmeans_seed.cu``), its widest row
#: (``D_MAX``: a thread holds a row in registers) and its most candidates a
#: step (``T_MAX``: a warp's top-t list holds one a lane); ``SEED_SELECT``
#: and ``SEED_POTENTIALS`` name K5a and K5b to the occupancy query.
SEED_THREADS = 256
SEED_D_MAX = 64
SEED_T_MAX = 32
SEED_SELECT, SEED_POTENTIALS = 0, 1


def seed_feasible(d: int, t: int) -> bool:
    """True when K5 can seed rows of width ``d`` drawing ``t`` candidates a
    step (:func:`ops.kmeans.seed_candidates`): 1 ≤ d ≤ 64 and 1 ≤ t ≤ 32.
    At t = 32, k reaches 2³⁰."""
    return 1 <= d <= SEED_D_MAX and 1 <= t <= SEED_T_MAX


def seed_keeps_d2(d: int, t: int) -> bool:
    """True when K5b keeps each row's D² to the t candidates (4·t bytes a
    row written, a (t, n) float32 buffer held through the seeding) for
    the next K5a to read the chosen one's (4 bytes), rather than K5a
    reading the row again (4·d bytes): whichever moves fewer bytes,
    t + 1 < d. Both give the same bits. At 20M × 16 rows, k = 100 (t = 9):
    128 bytes a row a step against 152, and 0.96 against 1.09 ms of K5 a
    step on an H100. Narrow rows take the other side: the PQ codebooks of
    4-wide subspaces (256 codes, t = 10) would write 40 bytes a row to
    save reading 16, and hold a buffer 2.5 times their rows (20M × 4, k =
    100: 68.4 ms a seeding keeping the D²s, 53.9 reading x again; PERF.md,
    K5)."""
    return t + 1 < d


def seed_blocks(n: int, sms: int, per_sm: int) -> int:
    """Blocks of a K5a or K5b launch: one wave, ``per_sm`` resident blocks
    on each of ``sms`` SMs, each walking row tiles of
    :data:`SEED_THREADS` (block, block + grid, ...); no more than one per
    tile; at least 1."""
    return max(1, min(sms * per_sm, -(-n // SEED_THREADS)))


class Seeding(NamedTuple):
    """What K5 leaves on the device: the centres (k, d), the row each
    copies (k,) int64, and each row's squared distance to centres
    0 … k − 2 (n,), from which the last step drew (+inf at k = 1). A fit
    keeps the centres; the rows and distances are what the card tests
    and ``chip_smoke.py`` hold against the torch loop and float64."""

    centers: torch.Tensor
    rows: torch.Tensor
    md: torch.Tensor


_seed_fns: dict = {}  # "select" / "potentials" -> the ctypes launcher, argtypes set
_seed_resident: dict = {}  # (device index, kernel, d, t) -> resident blocks per SM


def _seed_functions():
    """K5a's and K5b's launchers, built and loaded at the first call."""
    if not _seed_fns:
        lib = _build.load(SEED_NAME)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        select = lib.kmeans_seed_select
        select.argtypes = [p] * 5 + [ll, i, i, i] + [p] * 7 + [i, p]
        select.restype = i
        pots = lib.kmeans_seed_potentials
        pots.argtypes = [p] * 4 + [ll, i, i, i] + [p] * 6 + [i, p]
        pots.restype = i
        _seed_fns.update(select=select, potentials=pots)
    return _seed_fns["select"], _seed_fns["potentials"]


def _seed_blocks_per_sm(device: torch.device, kernel: int, d: int, t: int) -> int:
    """Resident K5a or K5b blocks per SM at (d, t), from the CUDA occupancy
    API, once per device and shape."""
    key = (device.index, kernel, d, t)
    if key not in _seed_resident:
        fn = _build.load(SEED_NAME).kmeans_seed_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        with torch.cuda.device(device):
            got = fn(kernel, d, t)
        if got <= 0:
            raise RuntimeError(f"kmeans_seed occupancy query failed: {got}")
        _seed_resident[key] = got
    return _seed_resident[key]


def _check_seed(x, w, k: int) -> int:
    """Refuses what K5 does not take; returns the candidates a step."""
    if x.dim() != 2:
        raise ValueError(f"seed_plusplus: x must be 2-D, got {tuple(x.shape)}")
    n, d = int(x.shape[0]), int(x.shape[1])
    if x.dtype != torch.float32:
        raise TypeError(f"seed_plusplus takes float32 x, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"seed_plusplus runs on CUDA or CPU tensors, got {x.device}")
    if w is not None and (tuple(w.shape) != (n,) or w.device != x.device):
        raise ValueError(f"seed_plusplus: weights {tuple(w.shape)} on {w.device} for {n} rows on {x.device}")
    if n < 1 or k < 1:
        raise ValueError(f"seed_plusplus needs n >= 1 and k >= 1, got n={n}, k={k}")
    t = seed_candidates(k, n)
    if not seed_feasible(d, t):
        raise ValueError(f"seed_plusplus: d={d} with {t} candidates a step is beyond K5 (d <= 64, t <= 32)")
    return t


def seed_plusplus(x: torch.Tensor, w: Optional[torch.Tensor], generator: torch.Generator,
                  k: int) -> torch.Tensor:
    """Greedy k-means++ on kernel K5 for a CUDA tensor (its plain version,
    :func:`ops.kmeans.kmeans_plusplus_loop`, for a CPU one): the (k, d)
    centres of float32 rows ``x`` (n, d) with row weights ``w`` (None: all
    1), drawn from ``generator`` on x's device."""
    _check_seed(x, w, k)
    if x.device.type == "cpu":
        return kmeans_plusplus_loop(x, w if w is not None else torch.ones(x.shape[0]), generator, k)
    return seed_plusplus_cuda(x, w, generator, k).centers


def seed_plusplus_cuda(x: torch.Tensor, w: Optional[torch.Tensor], generator: torch.Generator,
                       k: int) -> Seeding:
    """K5 on a CUDA tensor: the first centre by one K5a launch, then for
    each further centre one ``torch.rand(n, generator=...)`` vector (the
    torch loop's draws, in its order), K5a and K5b (which keeps the rows'
    D² for the next K5a where :func:`seed_keeps_d2`). Nothing is read
    back: the host queues the k − 1 steps and returns. Bitwise
    repeatable."""
    t = _check_seed(x, w, k)
    select, potentials = _seed_functions()
    x = x.contiguous()
    n, d = int(x.shape[0]), int(x.shape[1])
    dev = x.device
    f32, i64 = torch.float32, torch.int64
    w = torch.ones(n, dtype=f32, device=dev) if w is None else w.to(f32).contiguous()
    sms = _sms(dev)
    blocks_a = seed_blocks(n, sms, _seed_blocks_per_sm(dev, SEED_SELECT, d, t))
    blocks_b = seed_blocks(n, sms, _seed_blocks_per_sm(dev, SEED_POTENTIALS, d, t))
    with torch.cuda.device(dev):
        ctl = torch.zeros(2, dtype=torch.int32, device=dev)
        centers = torch.empty((k, d), dtype=f32, device=dev)
        rows = torch.empty(k, dtype=i64, device=dev)
        md = torch.empty(n, dtype=f32, device=dev) if k > 1 else torch.full((n,), math.inf, device=dev)
        cand_rows = torch.empty((SEED_T_MAX, d), dtype=f32, device=dev)
        cand_idx = torch.empty(SEED_T_MAX, dtype=i64, device=dev)
        part_v = torch.empty(blocks_a * t, dtype=f32, device=dev)
        part_i = torch.empty(blocks_a * t, dtype=i64, device=dev)
        part = torch.empty(blocks_b * t, dtype=torch.float64, device=dev)
        d2s = torch.empty((t, n), dtype=f32, device=dev) if seed_keeps_d2(d, t) and k > 2 else None
        d2s_p = d2s.data_ptr() if d2s is not None else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        xp, wp, mdp, cp, rp = x.data_ptr(), w.data_ptr(), md.data_ptr(), centers.data_ptr(), rows.data_ptr()
        crp, cip, ctlp = cand_rows.data_ptr(), cand_idx.data_ptr(), ctl.data_ptr()
        pvp, pip, pp = part_v.data_ptr(), part_i.data_ptr(), part.data_ptr()
        for step in range(k):
            u = torch.rand(n, generator=generator, dtype=f32, device=dev)
            err = select(xp, wp, u.data_ptr(), mdp, d2s_p, n, d, 1 if step == 0 else t, step, cp, rp,
                         crp, cip, pvp, pip, ctlp, blocks_a, stream)
            if err != 0:
                raise RuntimeError(f"{SEED_NAME} select launch failed: CUDA error {err}")
            launches["seed_select"] += 1
            if step == 0:
                continue
            err = potentials(xp, wp, mdp, d2s_p, n, d, t, step, crp, cip, pp, cp, rp, ctlp, blocks_b,
                             stream)
            if err != 0:
                raise RuntimeError(f"{SEED_NAME} potentials launch failed: CUDA error {err}")
            launches["seed_potentials"] += 1
    return Seeding(centers, rows, md)
