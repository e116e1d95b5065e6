"""Structured JSON-lines event log — port of the reference's
``observability/events.py``.

``TPUML_EVENT_LOG=<path|stderr>`` turns it on; unset (the default) it is
OFF and :func:`emit` is one module-global check — the serving hot path
and the range path pay nothing (the budget test holds this to an
allocation bound). The sink is resolved from the environment at its first
use (the first record, range or :func:`enabled` call), or by
:func:`configure`; importing the module opens nothing.

Every record is one JSON object per line with a common envelope::

    {"event": "<type>", "ts": <wall epoch>, "mono": <monotonic>,
     "pid": <os pid>, "process": <gang rank>,
     "run_id": "<fit-...|serve-...|null>", "trace": "<trace id|null>",
     ...type fields...}

``run_id`` comes from the ambient :func:`run_scope` (a contextvar): the
estimator base class opens one per fit, the serving entries open one per
transform/predict call, and an outer scope is REUSED by everything
nested inside it, so one fit's spans, retry attempts, fault firings and
checkpoint writes (the async writer receives a copied context) join on
one id.

``trace`` is the distributed identity: a :class:`TraceContext` (trace id
+ the span remote children parent to) propagated across process
boundaries via an env-var carrier (:func:`inject_env` on the launcher,
:func:`extract_env` — or simply environment inheritance — on the member)
and across in-process thread hops via :func:`current_trace_context` +
:func:`trace_scope`. A gang fit or a served request is ONE trace id in
every member's records, and span ids are globally unique, so
per-process shards reassemble into one tree (``observability/trace.py``).

``process`` is the gang rank: :func:`set_process_index` (called by
``parallel.distributed.initialize``), else ``TPUML_PROCESS_ID``, else 0.

``TPUML_TELEMETRY_DIR=<dir>`` turns on PER-PROCESS SHARDING: each
process appends to its own ``events-<pid>.jsonl`` under the dir (taking
precedence over ``TPUML_EVENT_LOG``) and writes an at-exit
``metrics-<pid>.json`` snapshot plus a ``manifest-<pid>.json`` (pid,
process index, trace roots, shard names). :func:`flush_telemetry` writes
the manifest early for long-lived processes and tests.

:data:`SCHEMA` names every record type and its required fields;
:func:`validate_record` is the validator, the reference's own.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import contextvars

from spark_rapids_ml_tpu_torch.utils.envknobs import EnvKnobError, env_int, env_str, reject_step5_later

EVENT_LOG_ENV = "TPUML_EVENT_LOG"
TELEMETRY_DIR_ENV = "TPUML_TELEMETRY_DIR"
TRACE_ID_ENV = "TPUML_TRACE_ID"
TRACE_PARENT_ENV = "TPUML_TRACE_PARENT"
FLIGHT_ENV = "TPUML_FLIGHT"

#: Spans kept per run context for report building (reports read a window
#: of this deque; an unbounded long-lived scope must not grow forever).
MAX_RUN_SPANS = 16384

# --- record schema -----------------------------------------------------

#: Fields every record carries.
BASE_FIELDS = frozenset(
    {"event", "ts", "mono", "pid", "process", "run_id", "trace"}
)

#: Required extra fields per record type — the single source of truth
#: for schema validation (tests + CLI).
SCHEMA: Dict[str, frozenset] = {
    "run": frozenset({"action", "kind", "label"}),
    "span": frozenset(
        {"name", "start", "end", "dur", "ok", "exc", "depth", "parent",
         "span", "thread"}
    ),
    "counters": frozenset({"counters"}),
    "retry": frozenset({"site", "attempt", "outcome"}),
    "fault": frozenset({"action"}),
    "degrade": frozenset({"what", "why", "fallback"}),
    "checkpoint": frozenset({"action", "step"}),
    "heartbeat": frozenset({"seq", "interval"}),
    "barrier": frozenset({"action", "attempt"}),
    "serving": frozenset({"action"}),
    "fit_admission": frozenset({"action", "family"}),
    "compile": frozenset({"classification", "kernel"}),
    "autotune": frozenset({"action"}),
    "report": frozenset({"kind", "summary"}),
    "profile": frozenset({"action", "dir"}),
    "distributed": frozenset({"action"}),
    "gang_fit": frozenset({"action"}),
    "elastic": frozenset({"action"}),
    "gang_resize": frozenset({"action", "from_members", "to_members"}),
    "lifecycle": frozenset({"action"}),
    "registry_rollback": frozenset({"model", "alias", "version", "previous"}),
    "persistence": frozenset({"action", "path"}),
    "telemetry": frozenset({"action", "path"}),
    "lockcheck": frozenset({"action", "lock"}),
    "pipeline_fusion": frozenset({"action", "pipeline"}),
    "slo": frozenset({"action", "objective"}),
}


def validate_record(rec: Any) -> List[str]:
    """Problems with one decoded record (empty list = valid)."""
    problems: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    etype = rec.get("event")
    if etype not in SCHEMA:
        problems.append(f"unknown event type {etype!r}")
        return problems
    for f in BASE_FIELDS:
        if f not in rec:
            problems.append(f"{etype}: missing base field {f!r}")
    for f in SCHEMA[etype]:
        if f not in rec:
            problems.append(f"{etype}: missing field {f!r}")
    for f in ("ts", "mono"):
        if f in rec and not isinstance(rec[f], (int, float)):
            problems.append(f"{etype}: {f} must be a number")
    return problems


# --- trace context -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Dapper-style trace coordinates carried across process and thread
    boundaries alongside ``run_id``.

    ``trace_id`` names the whole distributed episode; ``span_id`` is the
    span that REMOTE (other-process / other-thread) children parent to —
    the caller's innermost open span at hand-off time; ``parent_span_id``
    is that span's own parent, carried for introspection only."""

    trace_id: str
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None


def new_trace_id() -> str:
    return os.urandom(8).hex()


_TRACE: "contextvars.ContextVar[Optional[TraceContext]]" = contextvars.ContextVar(
    "tpuml_trace_ctx", default=None
)
#: Trace propagated INTO this process via the env carrier — the ambient
#: fallback when no in-process scope is active, so a spawned gang member
#: joins the launcher's trace with zero member-side code.
_env_trace: Optional[TraceContext] = None
_trace_roots: set = set()  # guarded-by: _sink_lock


def _note_trace_root(trace_id: str) -> None:
    with _sink_lock:
        _trace_roots.add(trace_id)


def begin_trace() -> TraceContext:
    """A fresh root :class:`TraceContext`, recorded as one of THIS
    process's trace roots (the shard manifest lists them)."""
    tc = TraceContext(new_trace_id())
    _note_trace_root(tc.trace_id)
    return tc


def current_trace() -> Optional[TraceContext]:
    """The ambient trace: an in-process :func:`trace_scope` if one is
    active, else the trace injected via the env carrier, else None."""
    tc = _TRACE.get()
    return tc if tc is not None else _env_trace


def current_trace_context() -> Optional[TraceContext]:
    """Snapshot for a cross-thread/cross-process hop: the ambient trace
    id with the caller's innermost OPEN span as the remote children's
    parent — hand it to the receiving thread's :func:`trace_scope`."""
    tc = current_trace()
    if tc is None:
        return None
    from spark_rapids_ml_tpu_torch.utils.tracing import current_span_id

    sid = current_span_id()
    if sid is None:
        return tc
    return TraceContext(tc.trace_id, sid, tc.span_id)


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    """Make ``ctx`` the ambient trace for the block (None = no-op): the
    in-memory carrier for dispatcher threads, async writers, and any
    other hop that outlives the submitting frame."""
    if ctx is None:
        yield None
        return
    token = _TRACE.set(ctx)
    try:
        yield ctx
    finally:
        _TRACE.reset(token)


def inject_env(env: Optional[dict] = None) -> dict:
    """Write the current trace coordinates into an env-var carrier
    (``TPUML_TRACE_ID`` / ``TPUML_TRACE_PARENT``) for a process about to
    be spawned — or a task closure about to ship to an executor. With no
    ambient trace a fresh one is begun, so one gang launch is one trace.
    Mutates and returns ``env`` (a new dict when omitted)."""
    tc = current_trace_context()
    if tc is None:
        tc = begin_trace()
    carrier = env if env is not None else {}
    carrier[TRACE_ID_ENV] = tc.trace_id
    if tc.span_id:
        carrier[TRACE_PARENT_ENV] = tc.span_id
    else:
        carrier.pop(TRACE_PARENT_ENV, None)
    return carrier


def extract_env() -> Optional[TraceContext]:
    """The member side of :func:`inject_env`: the TraceContext this
    process's environment carries, or None. :func:`configure` calls this
    once and keeps the result as the ambient fallback."""
    trace_id = env_str(TRACE_ID_ENV)
    if not trace_id:
        return None
    return TraceContext(trace_id, env_str(TRACE_PARENT_ENV))


# --- run scopes --------------------------------------------------------

_run_seq = itertools.count(1)


class RunContext:
    """One run's identity + in-memory span collector (for reports)."""

    __slots__ = ("run_id", "kind", "label", "spans", "t0_wall", "t0_mono", "_lock")

    def __init__(self, run_id: str, kind: str, label: str):
        self.run_id = run_id
        self.kind = kind
        self.label = label
        self.spans: deque = deque(maxlen=MAX_RUN_SPANS)
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self._lock = threading.Lock()

    def add_span(self, record: dict) -> None:
        with self._lock:
            self.spans.append(record)

    def span_window(self, start: int) -> List[dict]:
        """Spans recorded since index ``start`` (report windows)."""
        with self._lock:
            return list(self.spans)[start:]

    def span_count(self) -> int:
        with self._lock:
            return len(self.spans)


_CTX: "contextvars.ContextVar[Optional[RunContext]]" = contextvars.ContextVar(
    "tpuml_run_ctx", default=None
)


def new_run_id(kind: str) -> str:
    return f"{kind}-{os.getpid():x}-{next(_run_seq):04x}-{os.urandom(3).hex()}"


def current_run() -> Optional[RunContext]:
    return _CTX.get()


def current_run_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.run_id if ctx is not None else None


@contextlib.contextmanager
def run_scope(kind: str, label: str = ""):
    """Enter (or join) a run: a fresh ``run_id`` when none is active, the
    AMBIENT one otherwise — a transform inside a fit, or a fit+transform
    pair inside a caller's job scope, shares the outer id so the whole
    episode joins in the event log. A fresh run with no ambient trace
    (in-process or env-injected) also roots a fresh trace, so every run
    is part of exactly one trace."""
    cur = _CTX.get()
    if cur is not None:
        yield cur
        return
    ctx = RunContext(new_run_id(kind), kind, label)
    token = _CTX.set(ctx)
    t_token = None
    if current_trace() is None:
        t_token = _TRACE.set(begin_trace())
    emit("run", action="start", kind=kind, label=label)
    try:
        yield ctx
    finally:
        _CTX.reset(token)
        emit("run", action="end", kind=kind, label=label,
             run_id=ctx.run_id)
        if t_token is not None:
            _TRACE.reset(t_token)


# --- the sink ----------------------------------------------------------

_UNSET = object()
_sink = _UNSET  # None = disabled: emit() is a single attribute check;
# _UNSET until the first use resolves the environment (configure).
# (_sink itself is deliberately NOT lock-guarded: the disabled fast path
# reads it lock-free once, then re-checks under the lock before writing.)
_sink_owned = False  # guarded-by: _sink_lock
_sink_lock = threading.Lock()
_n_emitted = 0  # guarded-by: _sink_lock
#: Active telemetry-dir sharding: {"dir": <dir>, "shard": <shard path>}.
_telemetry: Optional[dict] = None  # guarded-by: _sink_lock
_process_index: Optional[int] = None
#: Flight-recorder ring (``TPUML_FLIGHT=<N>``): the last N record dicts,
#: captured EVEN when no sink is configured — the crash dump's evidence.
#: None (the default) keeps the disabled emit() path allocation-free.
_flight_ring: Optional[deque] = None


def flight_ring() -> Optional[deque]:
    """The live flight ring (None when ``TPUML_FLIGHT`` is off)."""
    return _flight_ring


def set_process_index(idx: int) -> None:
    """Called by ``parallel.distributed.initialize`` once the gang is up;
    before that the envelope falls back to ``TPUML_PROCESS_ID`` or 0."""
    global _process_index
    _process_index = int(idx)


def _resolve_process_index() -> int:
    if _process_index is not None:
        return _process_index
    try:
        idx = env_int("TPUML_PROCESS_ID")
    except EnvKnobError:
        # A malformed rank must not make every emit() raise — the
        # distributed bring-up validates the same knob loudly.
        return 0
    return 0 if idx is None else idx


def telemetry_dir() -> Optional[str]:
    """The per-process telemetry shard root, when sharding is on."""
    return env_str(TELEMETRY_DIR_ENV)


def configure(path: Optional[str] = None) -> Optional[str]:
    """(Re)wire the sink: explicit ``path``, else a per-process shard
    under ``TPUML_TELEMETRY_DIR``, else ``TPUML_EVENT_LOG``, else
    disabled. The telemetry dir outranks the single-file knob because N
    gang members interleaving one file is exactly what shards exist to
    avoid. ``"stderr"`` streams to stderr; anything else appends to that
    file. Also re-reads the env trace carrier, so a freshly spawned
    member picks up its launcher's trace. Returns the active destination
    (None = disabled)."""
    global _sink, _sink_owned, _telemetry, _env_trace
    _env_trace = extract_env()
    shard_opened = None
    with _sink_lock:
        if _sink_owned:
            try:
                _sink.close()
            except OSError:  # pragma: no cover - best-effort close
                pass
        _sink, _sink_owned, _telemetry = None, False, None
        dest = path
        if dest is None:
            tdir = telemetry_dir()
            if tdir:
                dest = os.path.join(
                    os.path.abspath(tdir), f"events-{os.getpid()}.jsonl"
                )
                _telemetry = {"dir": os.path.abspath(tdir), "shard": dest}
            else:
                dest = env_str(EVENT_LOG_ENV)
        if not dest:
            # No sink — but the flight ring arms regardless: the crash
            # dump must work in processes that never configured a log.
            _configure_flight()
            return None
        if dest == "stderr":
            _sink = sys.stderr
        else:
            parent = os.path.dirname(os.path.abspath(dest))
            os.makedirs(parent, exist_ok=True)
            _sink = open(dest, "a", buffering=1)
            _sink_owned = True
        shard_opened = dest if _telemetry is not None else None
    _configure_flight()
    if shard_opened is not None:
        emit("telemetry", action="shard_open", path=shard_opened)
    return dest


def _configure_flight() -> None:
    """Arm (or disarm) the flight-recorder ring from ``TPUML_FLIGHT``.
    Armed, the ring captures every emit() — sink or no sink — and
    ``observability.flightrec`` hooks fatal exceptions to dump it."""
    global _flight_ring
    try:
        n = env_int(FLIGHT_ENV, 0, minimum=0)
    except EnvKnobError:
        n = 0
    if not n:
        _flight_ring = None
        return
    if _flight_ring is None or _flight_ring.maxlen != n:
        _flight_ring = deque(maxlen=int(n))
    try:
        from spark_rapids_ml_tpu_torch.observability import flightrec

        flightrec.arm()
    except Exception:  # pragma: no cover - recorder must never break emit
        pass


def _resolve_sink():
    """The sink, wired from the environment at its first use."""
    if _sink is _UNSET:
        configure()
    return _sink


def enabled() -> bool:
    return _resolve_sink() is not None


def emitted_count() -> int:
    """Total records written since import — the zero-events assertion."""
    with _sink_lock:
        return _n_emitted


def emit(etype: str, **fields) -> None:
    """Write one record. With no sink configured (and no flight ring
    armed) this returns after one module-global check — the disabled
    path allocates nothing. An armed ``TPUML_FLIGHT`` ring captures the
    record dict even when the sink is off: the crash dump works without
    an event log configured."""
    sink = _sink
    if sink is _UNSET:
        sink = _resolve_sink()
    ring = _flight_ring
    if sink is None and ring is None:
        return
    global _n_emitted
    ctx = _CTX.get()
    tc = current_trace()
    rec = {
        "event": etype,
        "ts": time.time(),
        "mono": time.monotonic(),
        "pid": os.getpid(),
        "process": _resolve_process_index(),
        "run_id": ctx.run_id if ctx is not None else None,
        "trace": tc.trace_id if tc is not None else None,
    }
    rec.update(fields)
    if ring is not None:
        ring.append(rec)  # deque.append is atomic; maxlen bounds it
    if sink is None:
        return
    line = json.dumps(rec, default=str)
    with _sink_lock:
        if _sink is None:  # reconfigured under us
            return
        try:
            _sink.write(line + "\n")
            _sink.flush()
        except (OSError, ValueError):  # closed stream: drop, never raise
            return
        _n_emitted += 1


def flush_telemetry() -> Optional[str]:
    """Write this process's telemetry manifest (pid, process index, trace
    roots, shard names) plus a metrics snapshot under the active
    telemetry dir. atexit does this automatically; long-lived launchers
    and tests call it to publish shards before the process ends. Returns
    the manifest path (None when sharding is off)."""
    _resolve_sink()
    with _sink_lock:
        tele = dict(_telemetry) if _telemetry is not None else None
        emitted = _n_emitted
        roots = sorted(_trace_roots)
    if tele is None:
        return None
    # The reference writes its cost-ledger shard (costs-<pid>.json) and
    # the ops port here; both belong to step 5's later parts.
    reject_step5_later("TPUML_COST_LEDGER", "TPUML_COST_LEDGER_DUMP", "TPUML_OPS_PORT")
    from spark_rapids_ml_tpu_torch.observability.metrics import dump_snapshot

    pid = os.getpid()
    metrics_path = os.path.join(tele["dir"], f"metrics-{pid}.json")
    try:
        dump_snapshot(metrics_path)
    except OSError:  # pragma: no cover - best-effort snapshot
        metrics_path = None
    manifest = {
        "pid": pid,
        "process": _resolve_process_index(),
        "shard": os.path.basename(tele["shard"]),
        "metrics": os.path.basename(metrics_path) if metrics_path else None,
        "costs": None,
        "ops_port": None,
        "trace_roots": roots,
        "emitted": emitted,
        # One (wall, mono) sample at a single instant — the merger's
        # cross-process clock-alignment anchor.
        "ts": time.time(),
        "mono": time.monotonic(),
    }
    path = os.path.join(tele["dir"], f"manifest-{pid}.json")
    try:
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")
    except OSError:  # pragma: no cover - best-effort manifest
        return None
    return path


def install_sigterm_flush():
    """Install a SIGTERM handler that dumps the flight ring and flushes
    this process's telemetry shard (manifest + metrics) BEFORE raising
    ``SystemExit(143)`` — a SIGTERM'd gang member must not leave a
    manifest-less shard behind (the default handler kills the process
    before any atexit flush runs). Returns an undo callable.
    ``signal.signal`` is main-thread-only: off the main thread the normal
    exit-path flush covers retirement, so a failed install degrades to a
    no-op undo."""
    import signal

    def _handler(signum, frame):
        try:
            from spark_rapids_ml_tpu_torch.observability import flightrec

            flightrec.dump("sigterm")
        except Exception:
            pass
        try:
            flush_telemetry()
        except Exception:
            pass
        raise SystemExit(143)

    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread
        return lambda: None

    def _undo() -> None:
        try:
            signal.signal(signal.SIGTERM, prev)
        except (ValueError, TypeError):
            pass

    return _undo


def _close_at_exit() -> None:  # pragma: no cover - interpreter teardown
    global _sink, _sink_owned
    with _sink_lock:
        if _sink is not None and _sink_owned:
            try:
                _sink.close()
            except OSError:
                pass
        _sink, _sink_owned = None, False


def _flush_at_exit() -> None:  # pragma: no cover - interpreter teardown
    try:
        flush_telemetry()
    except Exception:
        pass


atexit.register(_close_at_exit)
# LIFO: the manifest flush (registered later) runs BEFORE the sink close,
# so the recorded emit count is final.
atexit.register(_flush_at_exit)
# The env trace carrier is read at import (environment only, no file), so
# a spawned member's first run scope joins its launcher's trace before
# the sink is wired.
_env_trace = extract_env()
