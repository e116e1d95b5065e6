"""Estimator input funnel — port of the single-device parts of the
reference's ``core/ingest.py``.

A ``torch.Tensor`` is consumed in place where it lives, in its own
floating dtype (an integral tensor is cast there). Host data densifies
into one matrix at :func:`default_dtype` (or the ``dtype`` the caller
pins) and goes to :func:`device.resolve_device`, which raises on the
``"cuda"`` platform without a card. The reference's mesh padding, retry
policy, fault points and CPU degradation are left out: a CPU degrade
would be a fallback that hides the device.

:func:`prepare_rows` returns ``(x, mask, n_true, d_true)``; ``mask`` is
the per-row weight (all ones, or the ``weightCol`` weights), in a dtype
wide enough to count rows exactly (at least float32).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import as_matrix, as_partitions, is_device_array
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def numpy_dtype(dtype: torch.dtype):
    """The numpy twin of a floating torch dtype (float32 or float64)."""
    return _NUMPY_DTYPE[dtype]


def default_dtype() -> torch.dtype:
    """The compute dtype of host inputs when the caller pins none:
    float32, the card's working type (the reference's non-x64 default)."""
    return torch.float32


class PreparedRows(NamedTuple):
    x: torch.Tensor  # (n, d) on its device
    mask: torch.Tensor  # (n,) row weights, 1 for an unweighted row
    n_true: int
    d_true: int


def _mask_dtype(x_dtype: torch.dtype) -> torch.dtype:
    """Masks double as row counters (sum(mask) = n); narrow types would
    lose integers above 256, so widen to at least float32."""
    return torch.promote_types(x_dtype, torch.float32)


def prepare_rows(
    rows: Any,
    dtype: Optional[torch.dtype] = None,
    device_id: int = -1,
    weights: Optional[np.ndarray] = None,
) -> PreparedRows:
    """Any supported input as rows on their device plus a weight mask."""
    with TraceRange("ingest", TraceColor.BLUE):
        if is_device_array(rows):
            if rows.dim() != 2:
                raise ValueError(f"tensor input must be 2-D, got {rows.dim()}-D")
            x = rows
            if not x.is_floating_point():
                x = x.to(dtype or default_dtype())
            _device.device_of(x)
        else:
            dt = dtype or default_dtype()
            parts = as_partitions(rows, dtype=_NUMPY_DTYPE[dt])
            host = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
            dev = _device.resolve_device(device_id)
            with TraceRange("ingest H2D", TraceColor.CYAN):
                x = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
        n, d = int(x.shape[0]), int(x.shape[1])
        mask = torch.ones(n, dtype=_mask_dtype(x.dtype), device=x.device)
        if weights is not None:
            mask = _combine_weights(mask, weights, n)
        return PreparedRows(x, mask, n, d)


def _combine_weights(mask: torch.Tensor, weights, n_true: int) -> torch.Tensor:
    """User weights combined with the validity mask (product), never
    substituted for it; the length must match the rows."""
    w_host = np.asarray(weights, dtype=np.float64).ravel()
    if w_host.shape[0] != n_true:
        raise ValueError(
            f"weight vector has {w_host.shape[0]} entries but the data has {n_true} rows"
        )
    return mask * torch.from_numpy(w_host).to(device=mask.device, dtype=mask.dtype)


def matrix_like(x: Any):
    """A (n, d) matrix in its natural residence: a tensor stays where it
    lives, anything else densifies on the host as float64 numpy. The
    model-side twin of :func:`prepare_rows` for predict inputs."""
    if is_device_array(x):
        return x[None, :] if x.dim() == 1 else x
    return as_matrix(x)
