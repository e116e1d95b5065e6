"""Fit-path device-memory budget: pricing, admission, degradation, recovery.

Port of the reference's ``core/membudget.py``. Without it a host matrix
larger than the card's free memory dies inside ``prepare_rows``'
``.to(device)`` with a raw ``torch.OutOfMemoryError``.

  1. **Pricing** — :func:`padded_input_bytes` mirrors what the port's
     ``prepare_rows`` places: the rows in the fit's dtype plus the row
     mask (no mesh padding: the port has no mesh route yet). The cost
     ledger is not ported (ROADMAP A.9), so :func:`ledger_measured_bytes`
     is None and every decision is priced "declared"
     (counter ``fit.admission.declared``).
  2. **Admission** — :func:`fit_memory_guard` prices a host input against
     :func:`fit_mem_budget` (``TPUML_FIT_MEM_BUDGET``; unset = the free
     memory of the fit's card, :func:`free_hbm_bytes`; 0 = gate off).
     Over budget it either reroutes to the family's streaming fit through
     a ``HostArrayBlockReader`` (``TPUML_FIT_DEGRADE=auto``) or raises the
     structured :class:`FitMemoryError`.
  3. **Recovery** — :func:`run_fit_with_oom_recovery` and
     :func:`run_streaming_with_recovery` treat a device OOM
     (``robustness/retry.is_oom_error``) as a retryable degradation:
     reclaim, then stream at halved block rows, then raise the structured
     error. The reroute runs after the ``except`` block is left and the
     failed attempt's traceback is cleared: in PyTorch a live traceback
     holds the failed attempt's frames, and with them its CUDA tensors.

:func:`fit_within_budget` is the sequence each family's ``_fit`` runs
(guard, degraded reroute, in-memory fit under recovery). A stream or a
tensor that meets an OOM has no host matrix to re-block, so it ends in
``FitMemoryError`` (the reference copies a device array back instead).

Observable as in the reference: ``fit_admission`` events, the
``fit.admission.*`` and ``fit.oom.*`` counters, and the ``degrade``
warning/event/counter triple of ``robustness/degrade.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, TypeVar

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.robustness.degrade import record_degradation
from spark_rapids_ml_tpu_torch.robustness.retry import is_oom_error
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice, env_int, reject_autotune
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

T = TypeVar("T")

FIT_MEM_BUDGET_ENV = "TPUML_FIT_MEM_BUDGET"
FIT_OOM_RETRIES_ENV = "TPUML_FIT_OOM_RETRIES"
FIT_DEGRADE_ENV = "TPUML_FIT_DEGRADE"

DEFAULT_FIT_OOM_RETRIES = 3

#: Halving never goes below this: a block this small that still OOMs is
#: not a blocking problem.
MIN_BLOCK_ROWS = 256


class FitMemoryError(RuntimeError):
    """An estimator fit cannot run within the device-memory budget and no
    degradation rung was available: the structured replacement for a raw
    ``torch.OutOfMemoryError``. Carries ``family``, ``needed_bytes`` and
    ``budget_bytes`` (0 when unknown); the message names the knobs and
    inputs that unblock the fit."""

    def __init__(
        self,
        family: str,
        why: str,
        *,
        needed_bytes: int = 0,
        budget_bytes: int = 0,
        hint: str = "",
    ):
        self.family = family
        self.needed_bytes = int(needed_bytes)
        self.budget_bytes = int(budget_bytes)
        parts = [f"{family} fit cannot run within the device-memory budget: {why}"]
        if needed_bytes:
            parts.append(
                f"priced ~{self.needed_bytes:,} device bytes against a "
                f"budget of {self.budget_bytes:,}"
            )
        parts.append(
            hint
            or (
                f"raise {FIT_MEM_BUDGET_ENV} (or set it to 0 to disable the "
                "gate), pass a streaming source (core.data.ArrowBlockReader "
                "over parquet, or a block reader / iterator factory), or "
                "shrink the input"
            )
        )
        super().__init__(" — ".join(parts))


# --- budget & knob resolution ------------------------------------------


def free_hbm_bytes(device_id: int = -1) -> Optional[int]:
    """Free memory of the fit's card (``gpuId``; -1 = the first) as the
    caching allocator sees it: the driver's free bytes plus the blocks the
    allocator has reserved but not handed out (``mem_get_info`` counts
    those as used). None on the CPU platform or without a card, which
    turns the default budget into "gate off" where there is no device
    memory to protect."""
    if _device.get_platform() != "cuda" or not torch.cuda.is_available():
        return None
    dev = _device.resolve_device(device_id)
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))


def fit_mem_budget(device_id: int = -1) -> int:
    """The fit admission budget in bytes: an explicit
    ``TPUML_FIT_MEM_BUDGET`` wins (0 = gate off); unset defaults to
    :func:`free_hbm_bytes`, and 0 (off) where that is None."""
    explicit = env_int(FIT_MEM_BUDGET_ENV, None, minimum=0)
    if explicit is not None:
        return explicit
    return free_hbm_bytes(device_id) or 0


def fit_oom_retries() -> int:
    """Streaming attempts after a device OOM (block rows halving between
    attempts) before the structured budget error."""
    return env_int(FIT_OOM_RETRIES_ENV, DEFAULT_FIT_OOM_RETRIES, minimum=1)


def degrade_to_streaming_enabled() -> bool:
    """``TPUML_FIT_DEGRADE``: auto (default) reroutes over-budget host
    fits to streaming; off raises :class:`FitMemoryError` instead."""
    return env_choice(FIT_DEGRADE_ENV, ("auto", "off"), "auto") == "auto"


# --- pricing ------------------------------------------------------------


def _numpy_dtype(dtype: Any) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


def padded_input_bytes(n: int, d: int, dtype: Any) -> int:
    """Device bytes ``prepare_rows`` allocates for an (n, d) host input:
    the rows plus the row mask, whose dtype is the rows' widened to at
    least float32 (``core/ingest._mask_dtype``). ``dtype`` is a numpy or
    torch dtype."""
    np_dtype = _numpy_dtype(dtype)
    mask_itemsize = np.promote_types(np_dtype, np.float32).itemsize
    return int(n) * int(d) * np_dtype.itemsize + int(n) * mask_itemsize


def ledger_measured_bytes(*family_prefixes: str) -> Optional[int]:
    """The cost ledger's measured bytes for a fit family: always None,
    as the ledger is not ported (ROADMAP A.9)."""
    return None


def measured_or_declared(measured: Optional[int], declared: int, counter_prefix: str) -> int:
    """A measurement outranks the declared estimate; the
    ``<prefix>.measured`` / ``<prefix>.declared`` counters record which
    side priced each decision."""
    if measured is not None:
        bump_counter(f"{counter_prefix}.measured")
        return int(measured)
    bump_counter(f"{counter_prefix}.declared")
    return int(declared)


# --- admission ----------------------------------------------------------


@dataclass
class FitAdmission:
    """One admission decision. ``degrade=True`` means the caller reroutes
    to its streaming fit over :attr:`matrix` (the densified host input);
    ``degrade=False`` means proceed in memory."""

    degrade: bool
    matrix: Optional[np.ndarray] = None
    needed_bytes: int = 0
    budget_bytes: int = 0
    reason: str = ""


_ADMIT = FitAdmission(degrade=False)


def host_matrix(rows: Any) -> np.ndarray:
    """Densify a host fit input to the matrix the streaming reroute
    blocks over, at the dtype of the user's container (float64 when it
    has none)."""
    from spark_rapids_ml_tpu_torch.core.data import as_matrix, infer_input_dtype

    return as_matrix(rows, dtype=infer_input_dtype(rows))


def fit_memory_guard(
    family: str,
    rows: Any,
    *,
    can_stream: bool,
    why_cannot_stream: str = "",
    dtype: Any = None,
    ledger_families: Sequence[str] = (),
    extra_bytes: int = 0,
    device_id: int = -1,
) -> FitAdmission:
    """Price a fit's host input against the device-memory budget.

    Waves through (``degrade=False``) whenever there is nothing to
    decide: gate off, a streaming source, a tensor (it computes where it
    lives), or an input whose shape cannot be known without the copy this
    gate exists to avoid. Over budget, either returns a ``degrade=True``
    decision (recording the warning + event + counter) or raises
    :class:`FitMemoryError` when this configuration cannot stream or
    ``TPUML_FIT_DEGRADE=off``. ``dtype`` is the dtype the fit places the
    rows in (default ``core/ingest.default_dtype``); ``extra_bytes``
    prices sidecar device arrays sized with the input.
    """
    from spark_rapids_ml_tpu_torch.core.data import host_rows_shape, is_streaming_source

    if is_streaming_source(rows):
        return _ADMIT
    budget = fit_mem_budget(device_id)
    if budget <= 0:
        return _ADMIT
    shape = host_rows_shape(rows)
    if shape is None:
        return _ADMIT
    n, d = shape
    if dtype is None:
        from spark_rapids_ml_tpu_torch.core.ingest import default_dtype

        dtype = default_dtype()
    reject_autotune()  # the reference prices through the tuner's model here
    declared = padded_input_bytes(n, d, dtype) + int(extra_bytes)
    measured = ledger_measured_bytes(*ledger_families) if ledger_families else None
    # Input placement is unavoidable either way; a measurement would bound
    # the solver's working set on top of it.
    needed = declared + measured_or_declared(measured, 0, "fit.admission")
    if needed <= budget:
        bump_counter("fit.admission.admitted")
        return _ADMIT
    if can_stream and degrade_to_streaming_enabled():
        bump_counter("fit.admission.degraded")
        emit(
            "fit_admission", action="degrade", family=family, rows=n,
            features=d, needed_bytes=needed, budget_bytes=budget,
        )
        record_degradation(
            f"{family} fit",
            f"input of ~{needed:,} device bytes exceeds the fit memory "
            f"budget of {budget:,} (set {FIT_DEGRADE_ENV}=off to fail "
            "instead)",
            "streaming",
            "the streaming fit path",
        )
        return FitAdmission(
            degrade=True,
            matrix=host_matrix(rows),
            needed_bytes=needed,
            budget_bytes=budget,
            reason="over budget",
        )
    bump_counter("fit.admission.rejected")
    emit(
        "fit_admission", action="reject", family=family, rows=n,
        features=d, needed_bytes=needed, budget_bytes=budget,
        can_stream=can_stream,
    )
    why = "input exceeds the budget"
    if not can_stream:
        why += " and " + (why_cannot_stream or "this family has no streaming fit")
    else:
        why += f" and {FIT_DEGRADE_ENV}=off disables streaming degradation"
    raise FitMemoryError(family, why, needed_bytes=needed, budget_bytes=budget)


# --- OOM recovery -------------------------------------------------------


def _drop_tracebacks(exc: BaseException) -> None:
    """Clear the tracebacks along an exception's cause/context chain: each
    holds the frames of the failed attempt, and those hold its tensors."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _reclaim(device_id: int) -> None:
    from spark_rapids_ml_tpu_torch.core.serving import reclaim_device_memory

    dev = None
    if _device.get_platform() == "cuda" and torch.cuda.is_available():
        dev = _device.resolve_device(device_id)
    reclaim_device_memory(dev)


def _run_classified(fn: Callable[[], T]):
    """``(result, None)``, or ``(None, exc)`` for a device OOM with its
    tracebacks cleared, once the ``except`` block has been left. A
    :class:`FitMemoryError` and every other error propagate."""
    try:
        return fn(), None
    except FitMemoryError:
        raise
    except BaseException as exc:
        if not is_oom_error(exc):
            raise
        failure = exc
    _drop_tracebacks(failure)
    return None, failure


def run_streaming_with_recovery(
    family: str,
    fit_with_reader: Callable[[Any], T],
    matrix: np.ndarray,
    *,
    block_rows: Optional[int] = None,
    device_id: int = -1,
) -> T:
    """Run a streaming fit over ``matrix`` through a fresh
    ``HostArrayBlockReader``, retrying at halved block rows after each
    device OOM (memory reclaimed between attempts) up to
    ``TPUML_FIT_OOM_RETRIES`` attempts. The first attempt uses the block
    size an explicit streaming fit would (``fit_block_rows(family,
    width=, itemsize=)``), so an undisturbed degraded fit is bit-identical
    to the explicit one."""
    from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader, fit_block_rows

    if block_rows:
        block = int(block_rows)
    else:
        reject_autotune()  # the reference measures and commits block sizes here
        block = fit_block_rows(
            family, width=int(matrix.shape[1]), itemsize=int(np.dtype(matrix.dtype).itemsize)
        )
    attempts = fit_oom_retries()
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        result, failure = _run_classified(
            lambda: fit_with_reader(HostArrayBlockReader(matrix, block_rows=block))
        )
        if failure is None:
            if attempt:
                bump_counter("fit.oom.recovered")
                emit(
                    "fit_admission", action="recovered", family=family,
                    attempt=attempt, block_rows=block,
                )
            return result
        last = failure
        bump_counter("fit.oom.events")
        _reclaim(device_id)
        if attempt + 1 < attempts:
            block = max(MIN_BLOCK_ROWS, block // 2)
            bump_counter("fit.oom.block_halved")
            emit(
                "fit_admission", action="halve", family=family,
                attempt=attempt, block_rows=block,
            )
    raise FitMemoryError(
        family,
        f"streaming fit still exhausted device memory after {attempts} "
        f"attempt(s) down to {block} rows per block",
    ) from last


def run_fit_with_oom_recovery(
    family: str,
    attempt_fn: Callable[[], T],
    fallback: Optional[Callable[[], T]] = None,
    *,
    device_id: int = -1,
) -> T:
    """Run the in-memory fit body; treat a device OOM as a retryable
    degradation: leave the ``except`` block, clear the failed attempt's
    traceback, reclaim, and run ``fallback`` (the family's streaming
    reroute). Without a fallback, or with ``TPUML_FIT_DEGRADE=off``, the
    OOM becomes a structured :class:`FitMemoryError`; it never escapes
    raw. Every other error propagates untouched."""
    result, failure = _run_classified(attempt_fn)
    if failure is None:
        return result
    bump_counter("fit.oom.events")
    emit("fit_admission", action="oom", family=family, error=type(failure).__name__)
    _reclaim(device_id)
    if fallback is None or not degrade_to_streaming_enabled():
        bump_counter("fit.admission.rejected")
        raise FitMemoryError(
            family,
            "device memory was exhausted mid-fit and this "
            "configuration cannot degrade to streaming",
        ) from failure
    record_degradation(
        f"{family} fit",
        "device out of memory mid-fit; memory reclaimed",
        "streaming",
        "the streaming fit path",
    )
    result = fallback()
    bump_counter("fit.oom.recovered")
    emit("fit_admission", action="recovered", family=family, attempt=0)
    return result


def fit_within_budget(
    family: str,
    rows: Any,
    in_memory: Callable[[], T],
    streaming: Callable[[Any], T],
    *,
    can_stream: bool,
    why_cannot_stream: str,
    dtype: Any = None,
    ledger_families: Sequence[str] = (),
    device_id: int = -1,
) -> T:
    """A family's ``_fit`` after its own routing, as the reference's five
    estimators spell it out: :func:`fit_memory_guard` on ``rows``; over
    budget, ``streaming(reader)`` over the densified input; otherwise
    ``in_memory()`` under :func:`run_fit_with_oom_recovery`, whose
    fallback is the same streaming reroute for a host input that can
    stream (a stream or a tensor has no host matrix to re-block)."""
    from spark_rapids_ml_tpu_torch.core.data import is_device_array, is_streaming_source

    guard = fit_memory_guard(
        family, rows, can_stream=can_stream, why_cannot_stream=why_cannot_stream,
        dtype=dtype, ledger_families=ledger_families, device_id=device_id,
    )
    if guard.degrade:
        return run_streaming_with_recovery(family, streaming, guard.matrix, device_id=device_id)
    fallback = None
    if can_stream and not is_streaming_source(rows) and not is_device_array(rows):
        def fallback():
            return run_streaming_with_recovery(family, streaming, host_matrix(rows), device_id=device_id)
    return run_fit_with_oom_recovery(family, in_memory, fallback, device_id=device_id)


def reraise_if_oom(exc: BaseException, family: str, device_id: int = -1) -> None:
    """The fit-boundary safety net (``Estimator.fit``): turn any device
    OOM that escaped the per-family recovery into the structured
    :class:`FitMemoryError`. A no-op for every other error, including an
    already-structured FitMemoryError."""
    if isinstance(exc, FitMemoryError) or not is_oom_error(exc):
        return
    bump_counter("fit.oom.events")
    emit("fit_admission", action="oom", family=family, error=type(exc).__name__)
    _reclaim(device_id)
    raise FitMemoryError(family, "device memory was exhausted during the fit") from exc
