"""Serving path of ``transform`` — the part of the reference's
``core/serving.py`` this slice needs.

  - :func:`serve_rows`   one batch already on its device: run the
                         row-wise kernel there, result stays there.
  - :func:`serve_stream` host blocks: copy each to the device, run the
                         kernel, copy the result back, one block at a time.

PyTorch runs eagerly and compiles nothing per shape, so the reference's
shape buckets and AOT program cache have no work to do here. Double
buffering (CUDA streams and pinned memory) waits for the serving slice.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

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
    to ``device`` at ``dtype``, ``fn(block, *args, **static)`` runs there,
    and the result comes back as numpy."""
    static = static or {}
    for blk in blocks:
        x_host = np.asarray(blk)
        if x_host.ndim == 1:
            x_host = x_host[None, :]
        if x_host.size == 0:
            continue
        with TraceRange(f"serve {name} H2D", TraceColor.CYAN):
            x_dev = torch.as_tensor(x_host).to(device=device, dtype=dtype)
        with TraceRange(f"serve {name}", TraceColor.GREEN):
            out = fn(x_dev, *args, **static)
        bump_counter("serving.stream.blocks")
        yield out.cpu().numpy()
