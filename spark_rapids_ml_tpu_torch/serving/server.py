"""ServingRuntime — the in-process online-inference façade; port of the
reference's ``serving/server.py``.

One object ties the runtime together: a :class:`ModelRegistry` (shared or
owned), an :class:`AdmissionQueue` with the depth and memory gates, and a
:class:`MicroBatcher` dispatcher thread. Callers use ``submit`` (rows in,
``Future`` out), ``submit_many`` and ``close`` (drains by default), plus
the registry's register → warm → alias → retire lifecycle.

Every request carries its own ``run_id`` from admission to completion
(``serving`` events: enqueue, dispatch, complete, shed, timeout) and a
trace carried to the dispatcher thread; ``serving.queue.depth`` and
``serving.inflight`` are live gauges, ``serving.request.latency_ms`` and
``serving.batch.fill`` histograms; :func:`runtime_snapshots` lists every
live runtime's state. The reference's ``observability.report`` section,
its health probes and the Prometheus exposition are the observability
item's (ROADMAP A.9).

Host rows are served as every family's host route serves them: in
float64, with the signature's host weights where it has them, so a
runtime answer equals ``model.predict`` / ``transform`` of the same rows
at the same bucket.
"""

from __future__ import annotations

import time
import weakref
from concurrent.futures import Future
from typing import Any, Iterable, List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.core.ingest import numpy_dtype
from spark_rapids_ml_tpu_torch.core.membudget import measured_or_declared
from spark_rapids_ml_tpu_torch.core.serving import HOST_DTYPE, ladder_bucket_rows
from spark_rapids_ml_tpu_torch.observability import costs as _costs
from spark_rapids_ml_tpu_torch.observability.events import (
    begin_trace,
    current_trace_context,
    emit,
    new_run_id,
    trace_scope,
)
from spark_rapids_ml_tpu_torch.observability import opsplane
from spark_rapids_ml_tpu_torch.observability.metrics import gauge
from spark_rapids_ml_tpu_torch.serving.admission import (
    DEFAULT_QUEUE_LIMIT,
    MEM_BUDGET_ENV,
    QUEUE_ENV,
    AdmissionQueue,
    Request,
    signature_device,
)
from spark_rapids_ml_tpu_torch.serving.batcher import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_DELAY_MS,
    MAX_BATCH_ENV,
    MAX_DELAY_ENV,
    MicroBatcher,
)
from spark_rapids_ml_tpu_torch.serving.registry import ModelRegistry, ModelVersion
from spark_rapids_ml_tpu_torch.serving.signature import spec_bytes
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_int
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

#: Live runtimes, held weakly.
_RUNTIMES: "weakref.WeakSet[ServingRuntime]" = weakref.WeakSet()
_runtime_seq_lock = make_lock("serving.runtime_seq")
_runtime_seq = 0  # guarded-by: _runtime_seq_lock


def runtime_snapshots() -> List[dict]:
    """Point-in-time state of every live :class:`ServingRuntime`."""
    return [rt.snapshot() for rt in list(_RUNTIMES)]


class ServingRuntime:
    """In-process online serving: micro-batching, admission, registry.

    Parameters default from the ``TPUML_SERVE_*`` knobs; explicit
    arguments win. ``start=False`` parks the dispatcher (requests queue,
    nothing runs) until :meth:`start`."""

    def __init__(self, registry: Optional[ModelRegistry] = None, *, max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None, queue_limit: Optional[int] = None,
                 mem_budget: Optional[int] = None, start: bool = True):
        global _runtime_seq
        self.registry = registry if registry is not None else ModelRegistry()
        self.max_batch = max_batch if max_batch is not None else env_int(MAX_BATCH_ENV, DEFAULT_MAX_BATCH, minimum=1)
        self.max_delay_ms = (max_delay_ms if max_delay_ms is not None
                             else env_float(MAX_DELAY_ENV, DEFAULT_MAX_DELAY_MS, minimum=0.0))
        self.queue_limit = (queue_limit if queue_limit is not None
                            else env_int(QUEUE_ENV, DEFAULT_QUEUE_LIMIT, minimum=1))
        self.mem_budget = mem_budget if mem_budget is not None else env_int(MEM_BUDGET_ENV, 0, minimum=0)
        self._queue = AdmissionQueue(self.queue_limit, self.mem_budget)
        self._batcher = MicroBatcher(self._queue, max_batch=self.max_batch, max_delay_ms=self.max_delay_ms)
        self._closed = False
        with _runtime_seq_lock:
            _runtime_seq += 1
            self.runtime_id = f"serving-runtime-{_runtime_seq}"
        gauge("serving.queue.depth", "queued serving requests").set_function(
            self._queue.depth, runtime=self.runtime_id)
        gauge("serving.inflight", "requests in execution").set_function(
            self._batcher.inflight, runtime=self.runtime_id)
        _RUNTIMES.add(self)
        if start:
            self.start()

    # --- registry delegates ---

    def register(self, name: str, model: Any, **kwargs) -> ModelVersion:
        return self.registry.register(name, model, **kwargs)

    def load(self, name: str, path: str, model_cls=None, **kwargs) -> ModelVersion:
        return self.registry.load(name, path, model_cls, **kwargs)

    def set_alias(self, name: str, alias: str, version: int) -> None:
        self.registry.set_alias(name, alias, version)

    def rollback(self, name: str, alias: str = "prod") -> int:
        return self.registry.rollback(name, alias)

    def retire(self, name: str, version: int) -> None:
        self.registry.retire(name, version)

    def warm(self, name: str, **kwargs) -> int:
        return self.registry.warm(name, **kwargs)

    # --- lifecycle ---

    def start(self) -> None:
        if self._closed:
            raise RuntimeError("serving runtime is closed")
        self._batcher.start()
        # Dispatcher-thread aliveness folds into this process's /healthz:
        # a runtime whose dispatcher died (or never restarted after a
        # stop) is unhealthy.
        opsplane.add_probe(f"dispatcher.{self.runtime_id}", lambda: self._closed or self._batcher.running)

    @property
    def running(self) -> bool:
        return self._batcher.running

    def close(self, drain: bool = True) -> None:
        """Stop the runtime: ``drain=True`` answers every queued request
        before the dispatcher exits, ``drain=False`` fails them now.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        if drain and not self._batcher.running and self._queue.depth():
            self._batcher.start()  # a parked runtime still owes its callers answers
        self._batcher.stop(drain=drain)
        self._queue.close()
        gauge("serving.queue.depth").remove(runtime=self.runtime_id)
        gauge("serving.inflight").remove(runtime=self.runtime_id)
        opsplane.remove_probe(f"dispatcher.{self.runtime_id}")
        emit("serving", action="close", runtime=self.runtime_id, drain=drain)

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # --- the request path ---

    def submit(self, name: str, x: Any, *, timeout: Optional[float] = None,
               version: Optional[Any] = None) -> Future:
        """Admit one request, a row ``(d,)`` or a block ``(k, d)``, for
        ``name`` (or ``"name@alias"``); the ``Future`` resolves to the
        serving kernel's output for exactly those rows, as numpy.

        ``timeout`` (seconds) is a deadline: a request not dispatched by
        then fails with :class:`DeadlineExceeded`. Raises
        :class:`Overloaded` when admission sheds."""
        if self._closed:
            raise RuntimeError("serving runtime is closed")
        mv = self.registry.resolve(name, version)
        sig = mv.signature
        xh = np.asarray(x)
        if xh.ndim == 1:
            xh = xh[None, :]
        if xh.ndim != 2:
            raise ValueError(f"serving input must be 1-D or 2-D, got {xh.ndim}-D")
        if xh.shape[1] != sig.n_features:
            raise ValueError(f"model {mv.name!r} v{mv.version} expects {sig.n_features} "
                             f"features, got {xh.shape[1]}")
        dtype = np.dtype(numpy_dtype(HOST_DTYPE))
        xh = np.ascontiguousarray(xh, dtype=dtype)
        n = int(xh.shape[0])
        # observe=False: the execution path feeds the ladder's histogram;
        # pricing agrees on the bucket without counting the request twice.
        bucket = ladder_bucket_rows(max(n, 1), name=sig.name, width=sig.n_features, observe=False)
        # The measured price once the bucket's program was captured under
        # the cost ledger, else the declared one: the bucketed input block
        # and the outputs at that bucket.
        cost = measured_or_declared(
            _costs.measured_request_bytes(sig.kernel, sig.static, bucket, sig.n_features, HOST_DTYPE,
                                          sig.weights_on(signature_device(sig), host=True))
            if _costs.active() is not None else None,
            bucket * sig.n_features * dtype.itemsize + spec_bytes(sig.output_spec(bucket, HOST_DTYPE)),
            "serving.admission",
        )
        tc = current_trace_context() or begin_trace()
        req = Request(
            key=(mv.name, mv.version, int(xh.shape[1]), str(dtype)),
            x=xh, n=n, version=mv, run_id=new_run_id("serve"), cost=cost,
            deadline=(time.monotonic() + timeout) if timeout is not None else None,
            timeout_ms=float(timeout) * 1e3 if timeout is not None else 0.0,
            trace=tc,
        )
        with trace_scope(tc):
            emit("serving", action="enqueue", model=mv.name, version=mv.version, rows=n,
                 run_id=req.run_id, cost_bytes=cost)
            self._queue.submit(req)  # raises Overloaded on shed
        bump_counter("serving.requests")
        bump_counter("serving.request.rows", n)
        return req.future

    def submit_many(self, name: str, xs: Iterable[Any], *, timeout: Optional[float] = None,
                    version: Optional[Any] = None) -> List[Future]:
        """One future per element of ``xs``, all against the version
        ``name`` resolves to now (consistent across a concurrent swap)."""
        mv = self.registry.resolve(name, version)
        return [self.submit(mv.name, x, timeout=timeout, version=mv.version) for x in xs]

    # --- introspection ---

    def queue_depth(self) -> int:
        return self._queue.depth()

    def inflight(self) -> int:
        return self._batcher.inflight()

    def snapshot(self) -> dict:
        return {
            "runtime": self.runtime_id,
            "running": self.running,
            "closed": self._closed,
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_ms,
            "queue_limit": self.queue_limit,
            "mem_budget": self.mem_budget,
            "queue_depth": self._queue.depth(),
            "reserved_bytes": self._queue.reserved_bytes(),
            "inflight": self._batcher.inflight(),
            "models": self.registry.snapshot(),
        }
