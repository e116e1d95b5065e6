"""Kernel K4: the UMAP tail accumulation on Hopper, and its plan.

Replaces the TPU kernel ``spark_rapids_ml_tpu/ops/pallas/umap.py``
``tail_accumulate`` (``csrc/umap_tail.cu``). Each epoch of the layout SGD
adds every edge's attractive gradient row to its tail's row,
``out[t] = Σ g[e]`` over the edges whose tail is t (the reference's
``zeros.at[dst].add(g)``). The edge list is fixed for a fit, so
:func:`build_tail_plan` sorts it by tail once, on the device and with
no host round trip: ``perm``, the stable argsort of the flat tails (the
reference's ``plan.perm``, element for element), and ``offsets``, the
CSR row starts over the sorted stream. The reference's tile geometry
(``TailCfg``: 256-row tiles, 1024-edge blocks, sentinel padding) was
VMEM/MXU layout and has no counterpart.

The kernel gives each warp :data:`ROWS_PER_WARP` consecutive tail rows:
a group of lanes per row when all their runs are short, else the whole
warp row by row. Each lane loads :data:`EDGES_PER_LANE` edges of its row
ahead (their ``perm`` entries, then the ``g`` rows through them), sums
in float64, and a fixed butterfly combines the lanes; each row is
written once, with no atomics: bitwise repeatable. Each wrapper takes
its plain version only for a tensor on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from spark_rapids_ml_tpu_torch.ops.kernels import _build

NAME = "umap_tail"

#: Launches since the last reset (the CPU route does not count).
launches = {"tail_accumulate": 0}

#: Warps per block of the kernel (``WARPS`` in the source).
WARPS = 8
#: Consecutive tail rows a warp takes (``ROWS_PER_WARP``).
ROWS_PER_WARP = 4
#: Edges a lane loads ahead in one round (``UNROLL``).
EDGES_PER_LANE = 8
#: Longest run that takes the grouped path, one round of its row's
#: 32 / ROWS_PER_WARP lanes (``SHORT_RUN``).
SHORT_RUN = 32 // ROWS_PER_WARP * EDGES_PER_LANE


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def cost(n: int, e: int, dim: int) -> dict:
    """The work of one tail accumulation (K4 or ``index_add_``; the count
    the cost ledger records and the bound column of the kernel table
    uses): e·dim additions; the float32 gradients, the int32 permutation
    and offsets read once, the (n, dim) float32 output written once."""
    return {"flops": float(e * dim), "transcendentals": 0.0,
            "bytes_accessed": float(4 * e * dim + 4 * e + 4 * (n + 1) + 4 * n * dim)}


class TailPlan(NamedTuple):
    """The per-fit edge sort, on the device of the graph."""

    perm: torch.Tensor     # (e,) int32: edges in stable tail-sorted order
    offsets: torch.Tensor  # (n + 1,) int32: row t's edges are perm[offsets[t]:offsets[t + 1]]
    tails: torch.Tensor    # (e,) int64: the sorted tails (the plain version's index)
    n: int
    dim: int


def plan_feasible(n: int, k: int, dim: int) -> bool:
    """The reference's routing rule (``ops/pallas/umap.py::plan_feasible``),
    kept so both packages take the same route: the embedding is at most
    128 wide and the edge stream is not empty."""
    return dim <= 128 and n * k > 0


def build_tail_plan(indices: torch.Tensor, n: int, dim: int) -> TailPlan:
    """Sort the (n, k) kNN tails of one graph, where they lie. Valid for
    any per-edge stream in head-major order (n·k rows), which is the
    order of the epoch's ``g_att.reshape(-1, dim)``. Every index must lie
    in [0, n)."""
    tails = torch.as_tensor(indices).reshape(-1).to(torch.int64)
    if tails.numel() >= 2**31:
        raise ValueError(f"tail_accumulate takes fewer than 2^31 edges, got {tails.numel()}")
    perm = torch.argsort(tails, stable=True)
    tails_sorted = tails[perm]
    rows = torch.arange(n + 1, dtype=torch.int64, device=tails.device)
    offsets = torch.searchsorted(tails_sorted, rows, out_int32=True)
    return TailPlan(perm.to(torch.int32), offsets, tails_sorted, int(n), int(dim))


def tail_accumulate_plain(g: torch.Tensor, plan: TailPlan) -> torch.Tensor:
    """The plain PyTorch version: ``zeros(n, dim).index_add_(0, tails,
    g[perm])`` over the sorted stream."""
    out = torch.zeros((plan.n, plan.dim), dtype=g.dtype, device=g.device)
    return out.index_add_(0, plan.tails, g[plan.perm.long()])


def _check(g: torch.Tensor, plan: TailPlan) -> None:
    e = int(plan.perm.shape[0])
    if g.dim() != 2 or tuple(g.shape) != (e, plan.dim):
        raise ValueError(f"tail_accumulate: edge values {tuple(g.shape)} != plan ({e}, {plan.dim})")
    if g.dtype != torch.float32:
        raise TypeError(f"tail_accumulate takes float32 edge values, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("tail_accumulate needs contiguous (row-major) edge values")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tail_accumulate runs on CUDA or CPU tensors, got {g.device}")
    for name in ("perm", "offsets", "tails"):
        if getattr(plan, name).device != g.device:
            raise ValueError(f"tail_accumulate: plan.{name} is on {getattr(plan, name).device}, g on {g.device}")
    if plan.perm.dtype != torch.int32 or plan.offsets.dtype != torch.int32:
        raise TypeError("tail_accumulate: plan.perm and plan.offsets must be int32")
    if tuple(plan.offsets.shape) != (plan.n + 1,) or plan.n < 1:
        raise ValueError(f"tail_accumulate: offsets {tuple(plan.offsets.shape)} do not fit n={plan.n}")
    if not plan.perm.is_contiguous() or not plan.offsets.is_contiguous():
        raise ValueError("tail_accumulate needs a contiguous plan")


def tail_accumulate(g: torch.Tensor, plan: TailPlan) -> torch.Tensor:
    """Kernel K4 on a CUDA tensor (its plain version on a CPU one): the
    (n, dim) float32 per-tail sums of the (n·k, dim) float32 per-edge rows
    ``g`` in head-major order."""
    _check(g, plan)
    if g.device.type == "cpu":
        return tail_accumulate_plain(g, plan)
    fn = _build.load(NAME).umap_tail_accumulate
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        out = torch.empty((plan.n, plan.dim), dtype=torch.float32, device=g.device)
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(), out.data_ptr(),
                 plan.n, plan.dim, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches["tail_accumulate"] += 1
    return out


__all__ = ["TailPlan", "build_tail_plan", "launches", "plan_feasible", "reset_launches",
           "tail_accumulate", "tail_accumulate_plain"]
