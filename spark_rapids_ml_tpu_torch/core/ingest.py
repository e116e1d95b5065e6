"""Estimator input funnel — port of the reference's ``core/ingest.py``.

A ``torch.Tensor`` is consumed in place where it lives, in its own
floating dtype (an integral tensor is cast there). Host data densifies
into one matrix at :func:`default_dtype` (or the ``dtype`` the caller
pins) and goes to :func:`device.resolve_device`, which raises on the
``"cuda"`` platform without a card. Every host->device placement is one
retry unit of the shared policy with one ``ingest.device_put`` fault site
(:func:`guarded_placement`; a device OOM between attempts reclaims the
caches first), as in the reference; :func:`place_array` is the guarded
upload of any other whole-array input of a fit. The reference's CPU
degradation is left out: a CPU degrade would be a fallback that hides the
device.

With a mesh the rows come back as a
:class:`~spark_rapids_ml_tpu_torch.parallel.mesh.ShardedRows`, as the
reference's ``_prepare_rows_impl`` places them: a tensor is padded and
split where it lives, never through the host; host partitions go through
``shard_rows_from_partitions`` without a host concatenation; in a gang
(more than one process) the partitions are this process's rows and go
through ``shard_rows_process_local``, and a member's tensor rejoins that
host path. Weights fold into the masks.

:func:`prepare_rows` returns ``(x, mask, n_true, d_true)``; ``mask`` is
the per-row weight (all ones, or the ``weightCol`` weights), in a dtype
wide enough to count rows exactly (at least float32), or under a mesh the
list of per-shard masks.

The supervised families add :func:`prepare_labels` (the target vector
beside the rows, with the length-mismatch guard), :func:`validate_int_labels`
(the classifiers' integer-label check: one stacked readback on the card)
and :func:`to_host_f64`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, TypeVar

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import as_matrix, as_partitions, is_device_array
from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.robustness.retry import default_policy, is_oom_error
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

T = TypeVar("T")

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def numpy_dtype(dtype: torch.dtype):
    """The numpy twin of a floating torch dtype (float32 or float64)."""
    return _NUMPY_DTYPE[dtype]


def guarded_placement(place: Callable[[], T], device: Optional[torch.device] = None) -> T:
    """Run one host->device placement as one retry unit of the shared
    policy (``ingest.device_put``), its fault site first and its copy in an
    ``ingest H2D`` range. Placement is pure, so an attempt re-runs
    whole; after a device OOM the caches are reclaimed (on ``device``'s
    allocator too) before the next attempt, and a failed attempt's frames
    are cleared by the policy, so nothing it placed stays allocated."""

    def attempt():
        fault_point("ingest.device_put")
        with TraceRange("ingest H2D", TraceColor.CYAN):
            return place()

    def reclaim(_attempt: int, exc: BaseException) -> None:
        if is_oom_error(exc):
            from spark_rapids_ml_tpu_torch.core.serving import reclaim_device_memory

            reclaim_device_memory(device if device is not None and device.type == "cuda" else None)

    return default_policy().run(attempt, name="ingest.device_put", on_retry=reclaim)


def place_array(arr: Any, dtype: Optional[torch.dtype] = None, device: Optional[torch.device] = None) -> torch.Tensor:
    """Guarded upload of a whole-array fit input beside :func:`prepare_rows`
    (a PCA partition, the sketch's host matrix): the same fault site,
    retry policy and OOM reclaim. A tensor is moved or cast where asked,
    with no fault site, as the reference leaves device inputs alone."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=dtype)
    host = np.asarray(arr)
    dev = device if device is not None else _device.resolve_device()
    return guarded_placement(lambda: torch.as_tensor(host).to(device=dev, dtype=dtype), dev)


def default_dtype() -> torch.dtype:
    """The compute dtype of host inputs when the caller pins none:
    float32, the card's working type (the reference's non-x64 default)."""
    return torch.float32


class PreparedRows(NamedTuple):
    x: Any  # (n, d) tensor on its device, or ShardedRows under a mesh
    mask: Any  # (n,) row weights, 1 for an unweighted row; per-shard masks under a mesh
    n_true: int
    d_true: int


def _mask_dtype(x_dtype: torch.dtype) -> torch.dtype:
    """Masks double as row counters (sum(mask) = n); narrow types would
    lose integers above 256, so widen to at least float32."""
    return torch.promote_types(x_dtype, torch.float32)


def prepare_rows(
    rows: Any,
    mesh=None,
    dtype: Optional[torch.dtype] = None,
    device_id: int = -1,
    weights: Optional[np.ndarray] = None,
) -> PreparedRows:
    """Any supported input as rows on their device plus a weight mask."""
    with TraceRange("ingest", TraceColor.BLUE):
        if mesh is not None:
            return _prepare_rows_mesh(rows, mesh, dtype, weights)
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
            x = guarded_placement(lambda: torch.from_numpy(np.ascontiguousarray(host)).to(dev), dev)
        n, d = int(x.shape[0]), int(x.shape[1])
        mask = torch.ones(n, dtype=_mask_dtype(x.dtype), device=x.device)
        if weights is not None:
            mask = _combine_weights(mask, weights, n)
        return PreparedRows(x, mask, n, d)


def _prepare_rows_mesh(rows: Any, mesh, dtype: Optional[torch.dtype], weights) -> PreparedRows:
    """The mesh branches of :func:`prepare_rows` (module docstring)."""
    from spark_rapids_ml_tpu_torch.parallel.collectives import process_count
    from spark_rapids_ml_tpu_torch.parallel.distributed import shard_rows_process_local
    from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows_from_partitions, shard_tensor_rows

    gang = process_count() > 1
    if gang and is_device_array(rows):
        # A member's tensor is its local rows: it enters the gang's layout
        # through the process-local host path (one local shard's pull), in
        # its own floating dtype.
        if dtype is None and rows.is_floating_point():
            dtype = rows.dtype
        rows = to_host(rows)
    if is_device_array(rows):
        if rows.dim() != 2:
            raise ValueError(f"tensor input must be 2-D, got {rows.dim()}-D")
        x = rows if rows.is_floating_point() else rows.to(dtype or default_dtype())
        _device.device_of(x)
        # Resharding a live tensor is pure placement: one retry unit.
        sharded = guarded_placement(lambda: shard_tensor_rows(x, mesh), mesh.first_device)
    else:
        dt = dtype or default_dtype()
        parts = as_partitions(rows, dtype=_NUMPY_DTYPE[dt])
        # The host partitions' placement loop is its own retry unit
        # (parallel/mesh.place_host_rows).
        if gang:
            sharded = shard_rows_process_local(parts, mesh, dtype=_NUMPY_DTYPE[dt])
        else:
            sharded = shard_rows_from_partitions(parts, mesh, dtype=_NUMPY_DTYPE[dt])
    sharded = sharded.with_masks(_mask_dtype(sharded.dtype))
    if weights is not None:
        # Weights are local like the rows: checked against this process's
        # row count, laid out as the rows are, multiplied into the masks.
        n_local = sum(sharded.valid)
        w_host = np.asarray(weights, dtype=np.float64).ravel()
        if w_host.shape[0] != n_local:
            raise ValueError(
                f"weight vector has {w_host.shape[0]} entries but the data has {n_local} rows"
            )
        sharded = sharded.fold_weights(sharded.split_vector(w_host, sharded.masks[0].dtype))
    return PreparedRows(sharded, sharded.masks, sharded.n, sharded.d)


def _combine_weights(mask: torch.Tensor, weights, n_true: int) -> torch.Tensor:
    """User weights combined with the validity mask (product), never
    substituted for it; the length must match the rows."""
    w_host = np.asarray(weights, dtype=np.float64).ravel()
    if w_host.shape[0] != n_true:
        raise ValueError(
            f"weight vector has {w_host.shape[0]} entries but the data has {n_true} rows"
        )
    w = guarded_placement(lambda: torch.from_numpy(w_host).to(device=mask.device, dtype=mask.dtype), mask.device)
    return mask * w


def matrix_like(x: Any):
    """A (n, d) matrix in its natural residence: a tensor stays where it
    lives, anything else densifies on the host as float64 numpy. The
    model-side twin of :func:`prepare_rows` for predict inputs."""
    if is_device_array(x):
        return x[None, :] if x.dim() == 1 else x
    return as_matrix(x)


def prepare_labels(
    y: Any,
    n_pad: int,
    n_true: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
    rows: Any = None,
):
    """A label/target vector placed beside :func:`prepare_rows` output, at
    ``dtype`` (default :func:`default_dtype`), zero-padded to ``n_pad``.
    A tensor stays where it lives; host labels go to ``device``. Beside
    mesh ``rows`` (a ``ShardedRows``), the labels are this process's and
    come back laid out as the rows are: one tensor per data shard.

    ``n_true`` (the rows' true count) guards against a length-mismatched
    ``(X, y)`` pair: only padding may be zero-filled — a ``y`` shorter than
    the data would otherwise train on phantom rows."""
    dtype = dtype or default_dtype()
    if rows is not None:
        n_local = sum(rows.valid)
        count = int(y.reshape(-1).shape[0]) if is_device_array(y) else np.asarray(y).ravel().shape[0]
        if count != n_local:
            raise ValueError(f"label vector has {count} entries but the data has {n_local} rows")
        return rows.split_vector(y, dtype)
    if is_device_array(y):
        ys = y.reshape(-1).to(dtype)
        if n_true is not None and int(ys.shape[0]) != n_true:
            raise ValueError(
                f"label vector has {int(ys.shape[0])} entries but the data has {n_true} rows"
            )
        pad = n_pad - int(ys.shape[0])
        if pad:
            ys = torch.nn.functional.pad(ys, (0, pad))
        return ys
    y_arr = np.asarray(y).ravel()
    if n_true is not None and y_arr.shape[0] != n_true:
        raise ValueError(
            f"label vector has {y_arr.shape[0]} entries but the data has {n_true} rows"
        )
    y_host = np.zeros(n_pad, dtype=torch.empty((), dtype=dtype).numpy().dtype)
    y_host[: y_arr.shape[0]] = y_arr
    return torch.from_numpy(y_host).to(device if device is not None else _device.resolve_device())


def validate_int_labels(y: Any):
    """The classifiers' label check: non-negative integers. On a tensor it
    costs ONE readback — the integrality flag, the minimum and the maximum
    travel as one stacked tensor (the class count sets shapes, so a sync
    is inherent; an O(n) pull of the labels is what must not happen).

    Returns ``(y_int, n_classes)``: ``y_int`` is int64 where the labels
    live (a tensor) or a host int64 array."""
    if is_device_array(y):
        y = y.reshape(-1)
        y_int = y.to(torch.int64)
        if y.is_floating_point():
            integral = torch.all(y == y_int.to(y.dtype))
        else:
            integral = torch.ones((), dtype=torch.bool, device=y.device)
        integral_i, lo, hi = torch.stack(
            [integral.to(torch.int64), torch.min(y_int), torch.max(y_int)]
        ).tolist()
        if not integral_i:
            raise ValueError("labels must be integers in [0, numClasses)")
        if lo < 0:
            raise ValueError("labels must be >= 0")
        return y_int, hi + 1
    y_host = np.asarray(y).ravel()
    y_int = y_host.astype(np.int64)
    if not np.array_equal(y_int, y_host):
        raise ValueError("labels must be integers in [0, numClasses)")
    if y_int.size and y_int.min() < 0:
        raise ValueError("labels must be >= 0")
    return y_int, int(y_int.max()) + 1 if y_int.size else 1


def to_host_f64(x) -> np.ndarray:
    """Any array or tensor as host float64 (the reference's ``double[]``
    surface). Models call it lazily, so a fit on the card pays the copy
    only when someone reads the result."""
    return to_host(x, np.float64)
