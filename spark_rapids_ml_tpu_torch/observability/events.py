"""Structured JSON-lines event log — the sink of the reference's
``observability/events.py``.

``TPUML_EVENT_LOG=<path|stderr>`` turns it on; unset it is off and
:func:`emit` costs one module-global check. Every record is one JSON
object per line with the reference's envelope::

    {"event": "<type>", "ts": <wall epoch>, "mono": <monotonic>,
     "pid": <os pid>, "process": 0, "run_id": "<serve-...|null>",
     "trace": "<trace id|null>", ...type fields...}

``run_id`` comes from the ambient :func:`run_scope` (a contextvar): every
``serve_rows`` call opens one, and a scope already open is joined, so a
transform inside a caller's scope shares its id. Each request of the
serving runtime carries its own ``run_id`` as a field. ``trace`` is the
ambient :class:`TraceContext`: a fresh run roots one, and
:func:`current_trace_context` / :func:`trace_scope` carry it across a
thread hop (the runtime's submitter to its dispatcher thread).
``process`` stays 0, and cross-process trace carriers, span trees, the
flight ring and the telemetry directory wait for the observability item
(ROADMAP A.9). The sink is configured at the first :func:`emit` (or by
:func:`configure`), not when the module is imported.

:data:`SCHEMA` lists the record kinds the port writes, each with the
fields the reference's ``validate_record`` requires of it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import sys
import threading
import time
from typing import Optional

from spark_rapids_ml_tpu_torch.utils.envknobs import env_str

EVENT_LOG_ENV = "TPUML_EVENT_LOG"

#: The record kinds the port writes and the fields each must carry (the
#: reference's ``SCHEMA`` entries for them): run scopes, the degradation
#: records, the fit memory guard's, the pipeline fuser's, the serving
#: layer's, the fault, retry, checkpoint and persistence records, and the
#: continuous-training lifecycle's.
SCHEMA = {
    "run": frozenset({"action", "kind", "label"}),
    "degrade": frozenset({"what", "why", "fallback"}),
    "fit_admission": frozenset({"action", "family"}),
    "pipeline_fusion": frozenset({"action", "pipeline"}),
    "serving": frozenset({"action"}),
    "registry_rollback": frozenset({"model", "alias", "version", "previous"}),
    "fault": frozenset({"action"}),
    "retry": frozenset({"site", "attempt", "outcome"}),
    "checkpoint": frozenset({"action", "step"}),
    "gang_resize": frozenset({"action", "from_members", "to_members"}),
    "persistence": frozenset({"action", "path"}),
    "lifecycle": frozenset({"action"}),
}


# --- trace context -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The trace a run or request belongs to: ``trace_id`` names the
    episode; ``span_id`` / ``parent_span_id`` are carried for the
    reference's shape (the port records no spans yet: ROADMAP A.9)."""

    trace_id: str
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None


def new_trace_id() -> str:
    return os.urandom(8).hex()


_TRACE: "contextvars.ContextVar[Optional[TraceContext]]" = contextvars.ContextVar(
    "tpuml_torch_trace_ctx", default=None
)


def begin_trace() -> TraceContext:
    """A fresh root :class:`TraceContext`."""
    return TraceContext(new_trace_id())


def current_trace() -> Optional[TraceContext]:
    """The ambient trace of this context, or None."""
    return _TRACE.get()


def current_trace_context() -> Optional[TraceContext]:
    """What to hand across a thread hop: the ambient trace (there are no
    open spans to parent to yet)."""
    return _TRACE.get()


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    """Make ``ctx`` the ambient trace for the block (None: no-op) — the
    carrier for the dispatcher thread."""
    if ctx is None:
        yield None
        return
    token = _TRACE.set(ctx)
    try:
        yield ctx
    finally:
        _TRACE.reset(token)


# --- run scopes --------------------------------------------------------

_run_seq = itertools.count(1)


class RunContext:
    """One run's identity: ``run_id``, its kind and label, its start."""

    __slots__ = ("run_id", "kind", "label", "t0_wall", "t0_mono")

    def __init__(self, run_id: str, kind: str, label: str):
        self.run_id = run_id
        self.kind = kind
        self.label = label
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()


_CTX: "contextvars.ContextVar[Optional[RunContext]]" = contextvars.ContextVar(
    "tpuml_torch_run_ctx", default=None
)


def new_run_id(kind: str) -> str:
    """``<kind>-<pid hex>-<sequence>-<random>``, the reference's form."""
    return f"{kind}-{os.getpid():x}-{next(_run_seq):04x}-{os.urandom(3).hex()}"


def current_run() -> Optional[RunContext]:
    return _CTX.get()


def current_run_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.run_id if ctx is not None else None


@contextlib.contextmanager
def run_scope(kind: str, label: str = ""):
    """Enter (or join) a run: a fresh ``run_id`` when none is active, the
    ambient one otherwise. A fresh run with no ambient trace roots one."""
    cur = _CTX.get()
    if cur is not None:
        yield cur
        return
    ctx = RunContext(new_run_id(kind), kind, label)
    token = _CTX.set(ctx)
    t_token = _TRACE.set(begin_trace()) if _TRACE.get() is None else None
    emit("run", action="start", kind=kind, label=label)
    try:
        yield ctx
    finally:
        _CTX.reset(token)
        emit("run", action="end", kind=kind, label=label, run_id=ctx.run_id)
        if t_token is not None:
            _TRACE.reset(t_token)

_UNSET = object()
_sink = _UNSET  # guarded by _sink_lock for writes; None = disabled
_sink_owned = False
_sink_lock = threading.Lock()
_n_emitted = 0


def configure(path: Optional[str] = None) -> Optional[str]:
    """(Re)wire the sink: explicit ``path``, else ``TPUML_EVENT_LOG``,
    else disabled. ``"stderr"`` streams to stderr; anything else appends
    to that file. Returns the destination (None = disabled)."""
    global _sink, _sink_owned
    dest = path if path is not None else env_str(EVENT_LOG_ENV)
    with _sink_lock:
        if _sink_owned:
            try:
                _sink.close()
            except OSError:  # best-effort close of the old sink
                pass
        _sink, _sink_owned = None, False
        if not dest:
            return None
        if dest == "stderr":
            _sink = sys.stderr
        else:
            os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
            _sink = open(dest, "a", buffering=1)
            _sink_owned = True
    return dest


def enabled() -> bool:
    return _sink is not _UNSET and _sink is not None


def emitted_count() -> int:
    """Total records written since import."""
    with _sink_lock:
        return _n_emitted


def emit(etype: str, **fields) -> None:
    """Write one record; with no sink this returns after one check."""
    global _n_emitted
    if _sink is _UNSET:
        configure()
    if _sink is None:
        return
    ctx = _CTX.get()
    tc = _TRACE.get()
    rec = {
        "event": etype,
        "ts": time.time(),
        "mono": time.monotonic(),
        "pid": os.getpid(),
        "process": 0,
        "run_id": ctx.run_id if ctx is not None else None,
        "trace": tc.trace_id if tc is not None else None,
    }
    rec.update(fields)
    line = json.dumps(rec, default=str)
    with _sink_lock:
        if _sink is None or _sink is _UNSET:  # reconfigured under us
            return
        try:
            _sink.write(line + "\n")
            _sink.flush()
        except (OSError, ValueError):  # closed stream: drop, never raise
            return
        _n_emitted += 1
