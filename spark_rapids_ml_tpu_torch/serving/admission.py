"""Admission for the online-serving queue — port of the reference's
``serving/admission.py``.

Two gates, both shedding with a structured :class:`Overloaded` instead of
queueing without bound:

  - **Queue depth** (``TPUML_SERVE_QUEUE``): a bounded request queue.
  - **Device-memory budget** (``TPUML_SERVE_MEM_BUDGET`` bytes, 0 = off):
    each request is priced before admission from its declared sizes, the
    bucketed input block plus the kernel's outputs at that bucket (the
    signature's ``output_spec``), and the bytes of admitted, unfinished
    requests must stay within the budget. The reservation is released when
    the request completes, sheds or times out. Once the bucket's program
    was captured under the cost ledger (``TPUML_COST_LEDGER=1``, on CUDA),
    the server prices with its measured temp + output bytes instead
    (counter ``serving.admission.measured``; else ``.declared``).

:func:`execute_with_fallback` runs one batch on the accelerator path. A
device failure fails that batch's futures with the error, as the
reference does with ``TPUML_DEGRADE`` off; ``TPUML_DEGRADE=cpu`` raises
``NotImplementedError``: the port does not fall back to the CPU, which
would hide the device.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.core.serving import serve_rows
from spark_rapids_ml_tpu_torch.observability.events import TraceContext, emit
from spark_rapids_ml_tpu_torch.robustness.degrade import degrade_mode
from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature, tree_leaves
from spark_rapids_ml_tpu_torch.utils.lockcheck import guarded, make_condition
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

QUEUE_ENV = "TPUML_SERVE_QUEUE"
MEM_BUDGET_ENV = "TPUML_SERVE_MEM_BUDGET"

DEFAULT_QUEUE_LIMIT = 1024

DEGRADE_REFUSED = (
    "TPUML_DEGRADE=cpu: the port does not fall back to the CPU when a device "
    "batch fails (a CPU answer would hide the device); unset it or set it to off"
)


class Overloaded(RuntimeError):
    """Structured shed: the runtime refused a request at admission.

    ``reason`` is ``"queue"`` (depth bound hit) or ``"memory"`` (the
    request's priced bytes would push reserved device memory past the
    budget); the other fields snapshot the state the decision was made
    on. ``retry_after_ms`` is the backoff hint: the p95 of the live
    request-latency histogram, roughly one queue residency."""

    def __init__(self, reason: str, model: str, *, queue_depth: int, queue_limit: int,
                 reserved_bytes: int = 0, request_bytes: int = 0, mem_budget: int = 0,
                 retry_after_ms: float = 0.0):
        self.reason = reason
        self.model = model
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit
        self.reserved_bytes = reserved_bytes
        self.request_bytes = request_bytes
        self.mem_budget = mem_budget
        self.retry_after_ms = float(retry_after_ms)
        if reason == "memory":
            detail = (f"request needs ~{request_bytes} device bytes but {reserved_bytes} of the "
                      f"{mem_budget}-byte budget ({MEM_BUDGET_ENV}) is reserved")
        else:
            detail = f"queue is at its depth bound {queue_limit} ({QUEUE_ENV})"
        super().__init__(f"serving overloaded ({reason}) for {model!r}: {detail}")


#: Backoff hint while the latency histogram is still empty.
DEFAULT_RETRY_AFTER_MS = 10.0


def retry_after_hint_ms(default_ms: float = DEFAULT_RETRY_AFTER_MS) -> float:
    """The shed backoff hint: p95 of ``serving.request.latency_ms``, or
    ``default_ms`` while that histogram holds nothing usable."""
    from spark_rapids_ml_tpu_torch.observability.metrics import percentile_from_histogram
    from spark_rapids_ml_tpu_torch.serving.batcher import _latency_hist

    p95 = percentile_from_histogram(_latency_hist().value(), 0.95)
    if p95 is None or not p95 > 0:
        return float(default_ms)
    return float(p95)


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed before its batch dispatched."""

    def __init__(self, model: str, waited_ms: float, deadline_ms: float):
        self.model = model
        self.waited_ms = waited_ms
        self.deadline_ms = deadline_ms
        super().__init__(f"serving deadline exceeded for {model!r}: waited "
                         f"{waited_ms:.1f} ms of a {deadline_ms:.1f} ms budget")


@dataclass
class Request:
    """One admitted unit of work: ``n`` rows for one model version."""

    key: Tuple  # (name, version, d, dtype): the coalescing identity
    x: np.ndarray  # (n, d) host rows at the compute dtype
    n: int
    version: Any  # registry.ModelVersion
    run_id: str
    future: Future = field(default_factory=Future)
    cost: int = 0  # priced device bytes (bucketed input + outputs)
    enqueue_mono: float = 0.0
    deadline: Optional[float] = None  # absolute monotonic seconds
    timeout_ms: float = 0.0
    trace: Optional[TraceContext] = None  # the submitter's trace, for the dispatcher

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and (now or time.monotonic()) > self.deadline


class AdmissionQueue:
    """The bounded, budget-priced request queue one dispatcher drains.

    ``submit`` applies both gates under one lock and raises
    :class:`Overloaded` on shed; the dispatcher pops the oldest request,
    drains compatible ones and waits on the condition for stragglers. A
    request holds its byte reservation until :meth:`release`."""

    def __init__(self, limit: int, mem_budget: int = 0):
        self.limit = int(limit)
        self.mem_budget = int(mem_budget)
        self._dq: "deque[Request]" = deque()  # guarded-by: _cond
        self._cond = make_condition("serving.admission")
        self._reserved = 0  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond

    def submit(self, req: Request) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("serving queue is closed")
            if len(self._dq) >= self.limit:
                raise self._shed(req, "queue")
            if self.mem_budget and self._reserved + req.cost > self.mem_budget:
                raise self._shed(req, "memory")
            self._reserved += req.cost
            req.enqueue_mono = time.monotonic()
            self._dq.append(req)
            self._cond.notify_all()

    def _shed(self, req: Request, reason: str) -> Overloaded:
        """Count and log one shed and build its :class:`Overloaded`. Reads
        queue state directly: it only runs under ``self._cond`` — the
        lint's interprocedural guarded-by pass proves every call site holds
        it, and ``guarded()`` asserts the same at runtime when the
        sanitizer is armed."""
        guarded(self._cond, "AdmissionQueue._dq")
        depth, reserved = len(self._dq), self._reserved
        bump_counter(f"serving.shed.{reason}")
        emit("serving", action="shed", reason=reason, model=req.key[0], version=req.key[1],
             rows=req.n, run_id=req.run_id, depth=depth, reserved_bytes=reserved)
        extra = (dict(reserved_bytes=reserved, request_bytes=req.cost, mem_budget=self.mem_budget)
                 if reason == "memory" else {})
        return Overloaded(reason, req.key[0], queue_depth=depth, queue_limit=self.limit,
                          retry_after_ms=retry_after_hint_ms(), **extra)

    def release(self, req: Request) -> None:
        """Free the request's byte reservation (completion, shed, timeout)."""
        with self._cond:
            self._reserved -= req.cost

    def depth(self) -> int:
        with self._cond:
            return len(self._dq)

    def reserved_bytes(self) -> int:
        with self._cond:
            return self._reserved

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def pop_first(self, timeout: float) -> Optional[Request]:
        """The oldest queued request, waiting up to ``timeout`` for one."""
        with self._cond:
            if not self._dq:
                self._cond.wait(timeout=timeout)
            if not self._dq:
                return None
            return self._dq.popleft()

    def drain_compatible(self, key: Tuple, max_rows: int) -> List[Request]:
        """Remove, in arrival order, every queued request with ``key`` whose
        rows still fit in ``max_rows``; the rest stay queued."""
        out: List[Request] = []
        with self._cond:
            kept: List[Request] = []
            budget = max_rows
            for req in self._dq:
                if req.key == key and req.n <= budget:
                    out.append(req)
                    budget -= req.n
                else:
                    kept.append(req)
            if out:
                self._dq.clear()
                self._dq.extend(kept)
        return out

    def drain_all(self) -> List[Request]:
        """Empty the queue (shutdown without drain)."""
        with self._cond:
            out = list(self._dq)
            self._dq.clear()
        return out

    def wait_for_arrival(self, deadline_mono: float) -> bool:
        """Block until a submit lands or ``deadline_mono`` passes: True if
        woken by a submit, False on timeout."""
        with self._cond:
            remaining = deadline_mono - time.monotonic()
            if remaining <= 0:
                return False
            return self._cond.wait(timeout=remaining)


def signature_device(sig: ServingSignature):
    """The device a signature's weights live on (its tensor route's)."""
    for leaf in tree_leaves(sig.weights):
        if hasattr(leaf, "device"):
            return leaf.device
    raise ValueError(f"signature {sig.name!r} has no tensor weights")


def execute_with_fallback(sig: ServingSignature, x: np.ndarray):
    """One batch of host rows through the bucketed program cache on the
    signature's device, with the weights the family's host route uses. A
    device failure propagates to the batch's futures; ``TPUML_DEGRADE=cpu``
    raises ``NotImplementedError`` (module docstring)."""
    if degrade_mode() == "cpu":
        raise NotImplementedError(DEGRADE_REFUSED)
    device = signature_device(sig)
    return serve_rows(sig.kernel, x, sig.weights_on(device, host=True), static=sig.static,
                      name=sig.name, device=device)
