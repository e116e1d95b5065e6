"""Serving path of ``transform`` — the part of the reference's
``core/serving.py`` this slice needs.

  - :func:`serve_rows`   one batch already on its device: run the
                         row-wise kernel there, result stays there.
  - :func:`serve_stream` host blocks: copy each to the device, run the
                         kernel, copy the result back, one block at a time.
  - :func:`upload_block` one raw stream block to a dense host array and
                         its copy on the device: the one place a block
                         becomes a tensor, for the fits and the transforms.
  - :func:`prefetch_blocks` one-ahead hand-off for the streaming fits:
                         block k+1 is prepared (densified, its copy to the
                         device issued) before block k is handed on.
  - :func:`reclaim_device_memory` what the fit-path OOM recovery frees
                         between attempts.
  - :func:`to_numpy`     a serving result back on the host.

Counters ``serving.h2d.bytes`` and ``serving.d2h.bytes`` count the bytes
the serving routes copy in (:func:`upload_block`) and out
(:func:`to_numpy`).

PyTorch runs eagerly and compiles nothing per shape, so the reference's
shape buckets and AOT program cache have no work to do here. Double
buffering on a copy stream from pinned memory waits for the serving
slice (and the streaming fits' H2D lever, ROADMAP A.3 L5), and so do the
serving device-cache hooks, which raise here.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.core.data import _block_to_dense, dense_block
from spark_rapids_ml_tpu_torch.core.ingest import numpy_dtype
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

#: Rows per block when a large host matrix is served block by block.
DEFAULT_STREAM_BLOCK = 65536


def serve_rows(
    fn: Callable,
    x: torch.Tensor,
    args: tuple = (),
    *,
    name: str,
    static: Optional[dict] = None,
) -> Any:
    """``fn(x, *args, **static)`` on the tensor where it lives."""
    if x.dim() == 1:
        x = x[None, :]
    with TraceRange(f"serve {name}", TraceColor.GREEN):
        return fn(x, *args, **(static or {}))


def serve_stream(
    fn: Callable,
    blocks: Iterable[Any],
    args: tuple = (),
    *,
    name: str,
    device: torch.device,
    dtype: torch.dtype,
    static: Optional[dict] = None,
) -> Iterator[np.ndarray]:
    """Yield one host result per non-empty host block: the block is copied
    to ``device`` as it is and cast to ``dtype`` there (a float32 block
    moves half the bytes of its float64 copy, to the same values),
    ``fn(block, *args, **static)`` runs there, and the result comes back as
    numpy."""
    static = static or {}
    for blk in blocks:
        with TraceRange(f"serve {name} H2D", TraceColor.CYAN):
            x_host, x_dev = upload_block(blk, device)
            if x_host.size == 0:
                continue
            x_dev = x_dev.to(dtype=dtype)
        with TraceRange(f"serve {name}", TraceColor.GREEN):
            out = fn(x_dev, *args, **static)
        bump_counter("serving.stream.blocks")
        yield to_numpy(out)


def to_numpy(out: torch.Tensor) -> np.ndarray:
    """A serving result as host numpy (counter ``serving.d2h.bytes``)."""
    host = out.cpu().numpy()
    bump_counter("serving.d2h.bytes", host.nbytes)
    return host


def upload_block(blk: Any, device: torch.device, dtype: Optional[torch.dtype] = None):
    """``(host, tensor)`` for one raw block: the dense host array and its
    copy on ``device`` in the same dtype. With ``dtype`` the block is cast
    on the host first; without it a float32 block stays float32 (it moves
    half the bytes and widens on the device to the same values) and
    anything else is float64. An empty block gives ``(0, ·)`` arrays."""
    host = dense_block(blk) if dtype is None else _block_to_dense(blk, dtype=numpy_dtype(dtype))
    bump_counter("serving.h2d.bytes", host.nbytes)
    return host, torch.as_tensor(host).to(device)


def prefetch_blocks(blocks: Iterable[Any], prepare: Callable[[Any], Any]) -> Iterator[Any]:
    """One-ahead hand-off for the streaming fit loops: block k is yielded
    only after ``prepare(block k+1)`` has run. The values are exactly
    ``prepare(block)`` in order, as the plain loop gives them. Each block
    handed on after its successor was prepared bumps
    ``fit.stream.prefetched``: the counter counts hand-offs, not overlap.
    A pageable ``.to(device)`` blocks the host, so the copies overlap
    nothing until pinned staging and a copy stream land (ROADMAP A.3 L5)."""
    pending = _none = object()
    for blk in blocks:
        current = prepare(blk)
        if pending is not _none:
            bump_counter("fit.stream.prefetched")
            yield pending
        pending = current
    if pending is not _none:
        yield pending


def reclaim_device_memory(device: Optional[torch.device] = None) -> None:
    """Best-effort release of reclaimable device memory after an OOM: a
    garbage collection (tensors held only by dropped frames or cycles)
    and, on a CUDA ``device``, the caching allocator's unused blocks. The
    fit-path recovery calls it between attempts, so the retry meets the
    device's true free memory. Counter ``fit.oom.reclaims``."""
    gc.collect()
    if device is not None and device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.empty_cache()
    bump_counter("fit.oom.reclaims")


DEVICE_CACHE_ITEM = "the serving device-cache hooks are not ported yet: ROADMAP A.8, item 17"


def note_device_cache(model) -> None:
    """Not ported: the serving runtime's registry of models holding device
    copies of their weights (ROADMAP A.8, item 17)."""
    raise NotImplementedError(DEVICE_CACHE_ITEM)


def invalidate_device_caches() -> int:
    """Not ported: dropping every registered model's device copies
    (ROADMAP A.8, item 17)."""
    raise NotImplementedError(DEVICE_CACHE_ITEM)
