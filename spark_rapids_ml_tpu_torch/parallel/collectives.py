"""The collectives every mesh route reduces through.

The reference lets XLA insert ``psum`` / ``all_gather`` into a jitted
program over a global sharded array. PyTorch has no such array that one
process holds over many devices, so the port takes the reference's
explicit-collective form (``parallel/distributed_cov.py::
distributed_covariance_shard_map``) as its only form: each shard computes
its partial where it lives, and the partials meet here.

  - :func:`psum_data` — the sum over the data axis. Within a process the
    partials are summed on one device (the mesh's first, or the first
    partial's), in shard order. When this process belongs to a
    ``torch.distributed`` gang, that partial is then ``all_reduce``d, so
    every process ends with the identical tensor.
  - :func:`all_gather_model` — the model-axis gather: one data shard's
    column blocks joined on its first device.
  - :func:`allreduce_slots` — the host handshakes. Gloo takes CUDA tensors
    only for ``all_reduce``, ``broadcast`` and ``barrier``, and NCCL takes
    only CUDA tensors, so an all-gather is an ``all_reduce`` of a
    zero-filled ``(world, ...)`` buffer in which each process fills its
    own slot (a sum of zeros and one value is exact).
  - :func:`all_gather_data` — the data-axis all-gather of one block per
    local data shard, every shard's block in global shard order on every
    rank. It rides :func:`allreduce_slots` with the blocks' bits as
    integers of the same width (bools as ``uint8``; 2-byte bits widened to
    ``int32``, which the backends sum): a float sum would
    turn ``-0.0`` into ``+0.0`` and may quiet a NaN, an integer sum of
    zeros and one value returns its bits. The counter
    ``collectives.gather.bytes`` adds the bytes each gather reduces.

:func:`process_count` / :func:`process_index` take the place of
``jax.process_count()`` / ``jax.process_index()``: the gang's world size
and this process's rank, 1 and 0 outside a gang.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

#: The integer type of each width a block's bits are read as. Neither gloo
#: nor NCCL sums int16, so 2-byte bits travel widened to int32.
_BITS_AS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def in_gang() -> bool:
    """True when this process has joined a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The gang's world size (1 outside a gang)."""
    return dist.get_world_size() if in_gang() else 1


def process_index() -> int:
    """This process's rank in the gang (0 outside a gang)."""
    return dist.get_rank() if in_gang() else 0


def _wire_device(t: torch.Tensor) -> torch.device:
    """Where a collective may read ``t``: NCCL reads only CUDA tensors,
    gloo reads CPU and (for ``all_reduce``) CUDA tensors in place."""
    if t.device.type != "cuda" and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The gang-wide sum of ``t`` (a new tensor where ``t`` lives); ``t``
    itself outside a gang. Every rank receives the same bits."""
    if not in_gang():
        return t
    wire = t.detach().to(_wire_device(t), copy=True).contiguous()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM)
    return wire.to(t.device)


def psum_data(parts: Sequence[torch.Tensor], device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum over the data axis of one partial per local data shard:
    summed on ``device`` (default the first partial's) in shard order,
    then across the gang. A single partial outside a gang is returned as
    it is."""
    if not parts:
        raise ValueError("psum_data needs at least one partial")
    device = parts[0].device if device is None else device
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return all_reduce_sum(acc)


def all_gather_model(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """One data shard's column blocks (one per model position) joined
    along the features on the first block's device; a single block is
    returned as it is."""
    if len(blocks) == 1:
        return blocks[0]
    device = blocks[0].device
    return torch.cat([b.to(device) for b in blocks], dim=1)


def allreduce_slots(own: torch.Tensor) -> torch.Tensor:
    """The all-gather of a small per-process tensor: ``(world,) + own.shape``
    with row ``r`` holding rank ``r``'s ``own``. Outside a gang, ``own``
    with a leading axis of one."""
    if not in_gang():
        return own[None]
    buf = torch.zeros((process_count(),) + tuple(own.shape), dtype=own.dtype, device=own.device)
    buf[process_index()] = own
    return all_reduce_sum(buf)


def all_gather_data(blocks: Sequence[torch.Tensor], device: Optional[torch.device] = None) -> List[torch.Tensor]:
    """The all-gather over the data axis of one block per local data shard
    (equal shapes and dtypes on every rank): every data shard's block in
    global shard order (rank ``r``'s local shard ``i`` is shard
    ``r × local shards + i``), on ``device`` (default the first block's),
    the same bits on every rank. Outside a gang, the blocks themselves on
    ``device``."""
    if not blocks:
        raise ValueError("all_gather_data needs at least one block")
    dtype = blocks[0].dtype
    width = blocks[0].element_size()
    if width not in _BITS_AS:
        raise ValueError(f"all_gather_data moves elements of 1, 2, 4 or 8 bytes; {dtype} has {width}")
    device = blocks[0].device if device is None else device
    local = [b.to(device) for b in blocks]
    if not in_gang():
        return local
    stacked = torch.stack(local)
    bits = stacked.to(torch.uint8) if dtype == torch.bool else stacked.view(_BITS_AS[width])
    gathered = allreduce_slots(bits.to(torch.int32) if width == 2 else bits)
    bump_counter("collectives.gather.bytes", gathered.numel() * gathered.element_size())
    gathered = gathered.to(bits.dtype)
    out = gathered.to(torch.bool) if dtype == torch.bool else gathered.view(dtype)
    return list(out.reshape((-1,) + tuple(stacked.shape[1:])).unbind(0))
