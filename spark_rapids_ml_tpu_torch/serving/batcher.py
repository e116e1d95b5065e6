"""Micro-batching: N callers, one bucketed execution — port of the
reference's ``serving/batcher.py``.

Callers submit single rows or small blocks; one dispatcher thread
coalesces compatible requests (same model, same version, same width and
compute dtype) into one padded bucket, runs one cached program for all of
them (on the card, one CUDA graph replay), and scatters row slices back to
the per-request futures.

A batch is bounded two ways: ``TPUML_SERVE_MAX_BATCH`` rows per dispatch,
and ``TPUML_SERVE_MAX_DELAY_MS`` of coalescing wait measured from the
first request of the forming batch. With ``TPUML_AUTOTUNE=on`` the window
follows the measured p95 program wall of the model's serving kernel
(:meth:`MicroBatcher._delay_s_for`; on the card the ledger's walls are
device time), falling back to the knob until enough walls were seen.

Version atomicity follows from the coalescing key: a request admitted
against version N only shares a batch with version N, so a hot swap
splits the stream between programs and never mixes weights within one.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.observability import autotune as _autotune
from spark_rapids_ml_tpu_torch.observability.events import emit, trace_scope
from spark_rapids_ml_tpu_torch.observability.metrics import histogram
from spark_rapids_ml_tpu_torch.serving.admission import (
    AdmissionQueue,
    DeadlineExceeded,
    Request,
    execute_with_fallback,
)
from spark_rapids_ml_tpu_torch.serving.signature import tree_map
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

MAX_BATCH_ENV = "TPUML_SERVE_MAX_BATCH"
MAX_DELAY_ENV = "TPUML_SERVE_MAX_DELAY_MS"

DEFAULT_MAX_BATCH = 256
DEFAULT_MAX_DELAY_MS = 5.0

#: Buckets of the request-latency histogram (milliseconds).
LATENCY_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 5000.0)

#: Buckets of the batch-fill histogram (dispatched rows / max_batch).
FILL_BUCKETS = (0.0625, 0.125, 0.25, 0.5, 0.75, 1.0)


def _latency_hist():
    return histogram("serving.request.latency_ms", "submit-to-result latency per request",
                     buckets=LATENCY_MS_BUCKETS)


def _fill_hist():
    return histogram("serving.batch.fill", "dispatched rows as a fraction of TPUML_SERVE_MAX_BATCH",
                     buckets=FILL_BUCKETS)


class MicroBatcher:
    """One dispatcher thread coalescing an :class:`AdmissionQueue`."""

    #: How often a parked dispatcher rechecks the stop flag.
    _IDLE_POLL_S = 0.05

    def __init__(self, queue: AdmissionQueue, *, max_batch: int = DEFAULT_MAX_BATCH,
                 max_delay_ms: float = DEFAULT_MAX_DELAY_MS):
        self._queue = queue
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._drain = True
        self._inflight = 0  # guarded-by: _lock
        self._lock = make_lock("serving.batcher")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._loop, name="tpuml-serve-dispatch", daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Signal the dispatcher down: ``drain=True`` finishes every queued
        request first, ``drain=False`` fails them now."""
        self._drain = drain
        self._stop = True
        if not drain:
            for req in self._queue.drain_all():
                self._queue.release(req)
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(RuntimeError("serving runtime closed before dispatch"))
        thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)

    def inflight(self) -> int:
        """Requests dispatched and not yet resolved."""
        with self._lock:
            return self._inflight

    def _loop(self) -> None:
        while True:
            first = self._queue.pop_first(timeout=self._IDLE_POLL_S)
            if first is None:
                if self._stop and (not self._drain or self._queue.depth() == 0):
                    return
                continue
            if self._fail_if_expired(first):
                continue
            self._execute(self._gather(first))
            # Hold no request while parked: it would keep its version's
            # weights alive past a retire.
            first = None

    def _gather(self, first: Request) -> List[Request]:
        """Everything compatible already queued, then stragglers until the
        batch fills or the window from ``first``'s enqueue closes."""
        batch = [first]
        rows = first.n
        flush_at = first.enqueue_mono + self._delay_s_for(first)
        while rows < self.max_batch:
            for req in self._queue.drain_compatible(first.key, self.max_batch - rows):
                if not self._fail_if_expired(req):
                    batch.append(req)
                    rows += req.n
            if rows >= self.max_batch or self._stop:
                break
            if not self._queue.wait_for_arrival(flush_at):
                # The window closed: one last sweep, then flush.
                for req in self._queue.drain_compatible(first.key, self.max_batch - rows):
                    if not self._fail_if_expired(req):
                        batch.append(req)
                        rows += req.n
                break
        return batch

    def _delay_s_for(self, first: Request) -> float:
        """The coalescing window for the batch forming behind ``first``:
        ``TPUML_SERVE_MAX_DELAY_MS`` unless the autotuner has measured the
        p95 program wall of this model's serving kernel — a batch should
        wait about the time one dispatch saves."""
        tuner = _autotune.active()
        if tuner is None:
            return self.max_delay_s
        return tuner.recommend_delay_s(first.version.signature.name, self.max_delay_s)

    def _fail_if_expired(self, req: Request) -> bool:
        now = time.monotonic()
        if not req.expired(now):
            return False
        self._queue.release(req)
        waited_ms = (now - req.enqueue_mono) * 1e3
        bump_counter("serving.deadline.expired")
        with trace_scope(req.trace):
            emit("serving", action="timeout", model=req.key[0], version=req.key[1], rows=req.n,
                 run_id=req.run_id, waited_ms=round(waited_ms, 3))
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(DeadlineExceeded(req.key[0], waited_ms, req.timeout_ms))
        return True

    def _execute(self, batch: List[Request]) -> None:
        name, version = batch[0].key[0], batch[0].key[1]
        sig = batch[0].version.signature
        total = sum(r.n for r in batch)
        x = np.concatenate([r.x for r in batch], axis=0) if len(batch) > 1 else batch[0].x
        with self._lock:
            self._inflight += len(batch)
        bump_counter("serving.batch.dispatch")
        bump_counter("serving.batch.rows_total", total)
        _fill_hist().observe(total / self.max_batch)
        # The batch-level events and the one execution land in the first
        # request's trace; per-request events join each request's own.
        with trace_scope(batch[0].trace):
            emit("serving", action="dispatch", model=name, version=version, rows=total,
                 requests=len(batch), run_ids=[r.run_id for r in batch])
        try:
            with trace_scope(batch[0].trace), TraceRange(f"serve batch {name}", TraceColor.GREEN):
                outs = execute_with_fallback(sig, x)
        except Exception as exc:  # fault isolation: the batch's futures carry the error
            for req in batch:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(exc)
                with trace_scope(req.trace):
                    emit("serving", action="error", model=name, version=version, run_id=req.run_id,
                         exc=type(exc).__name__)
            bump_counter("serving.batch.errors")
        else:
            now = time.monotonic()
            offset = 0
            for req in batch:
                lo, hi = offset, offset + req.n
                sliced = tree_map(
                    lambda leaf: leaf[lo:hi] if np.ndim(leaf) >= 1 and np.shape(leaf)[0] == total else leaf,
                    outs,
                )
                offset = hi
                latency_ms = (now - req.enqueue_mono) * 1e3
                _latency_hist().observe(latency_ms)
                # The (name, version) whose weights answered rides the future.
                req.future.model_name = name
                req.future.model_version = version
                if req.future.set_running_or_notify_cancel():
                    req.future.set_result(sliced)
                with trace_scope(req.trace):
                    emit("serving", action="complete", model=name, version=version, rows=req.n,
                         run_id=req.run_id, latency_ms=round(latency_ms, 3))
        finally:
            for req in batch:
                self._queue.release(req)
            with self._lock:
                self._inflight -= len(batch)
