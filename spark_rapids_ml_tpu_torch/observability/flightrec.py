"""Flight recorder — the crash dump that closes the killed-member hole.

Port of the reference's ``observability/flightrec.py``. The telemetry
merge has one blind spot: a member killed before its atexit flush leaves
an event shard with NO manifest (a warning of ``trace.assemble``), and
its in-registry metrics die with the process. ``TPUML_FLIGHT=<N>`` arms a bounded ring of the last N
event records inside :func:`events.emit` — captured even when no event
sink is configured at all, so the recorder costs one deque append on
the instrumented path and NOTHING when disarmed.

:func:`dump` writes ``flight-<pid>.json`` — ring contents, all-thread
Python stacks, a metrics snapshot and trace roots — into
``TPUML_FLIGHT_DIR`` (default: the active telemetry dir, else the
working directory). Its ``locks`` entry is the empty list the reference
writes with its lock sanitizer off, and ``costs`` is None: the sanitizer
and the cost ledger are ROADMAP A.9 step 5's later parts, and so is the
reference's third trigger, the lock sanitizer's stall strike. The
triggers here:

  - **fatal exception** — ``sys.excepthook`` / ``threading.excepthook``
    chain (the original hooks still run), installed by :func:`arm`;
  - **SIGTERM** — ``events.install_sigterm_flush``, installed by the
    processes that own their main thread, not here: signal handlers are
    per-role policy.

``observability/trace.py`` accepts the dump as a merge source: for a
pid with no manifest, the flight doc stands in as manifest + metrics
shard + event source, so the post-mortem merge is whole again.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional

from spark_rapids_ml_tpu_torch.utils.envknobs import env_str

FLIGHT_DIR_ENV = "TPUML_FLIGHT_DIR"

#: The on-disk document marker (``trace.py`` keys on it).
DOC_KIND = "tpuml-flight"

_arm_lock = threading.Lock()
_armed = False  # guarded-by: _arm_lock
_dump_lock = threading.Lock()
_dumped_reasons: set = set()  # guarded-by: _dump_lock
_prev_excepthook = None
_prev_threading_excepthook = None


def armed() -> bool:
    with _arm_lock:
        return _armed


def _ring_records() -> List[dict]:
    from spark_rapids_ml_tpu_torch.observability import events as _ev

    ring = _ev.flight_ring()
    return list(ring) if ring is not None else []


def _thread_stacks() -> List[dict]:
    """Python stacks of every live thread (best-effort)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(
            {
                "ident": ident,
                "name": names.get(ident),
                "stack": traceback.format_stack(frame),
            }
        )
    return out


def flight_dir() -> str:
    """Where dumps land: ``TPUML_FLIGHT_DIR``, else the active telemetry
    dir, else the working directory."""
    d = env_str(FLIGHT_DIR_ENV)
    if d:
        return os.path.abspath(d)
    from spark_rapids_ml_tpu_torch.observability import events as _ev

    tdir = _ev.telemetry_dir()
    return os.path.abspath(tdir) if tdir else os.getcwd()


def build_doc(reason: str, detail: Optional[dict] = None) -> dict:
    """The dump document, assembled from live state (no I/O)."""
    import time

    from spark_rapids_ml_tpu_torch.observability import events as _ev
    from spark_rapids_ml_tpu_torch.observability.metrics import default_registry

    doc: Dict[str, Any] = {
        "kind": DOC_KIND,
        "pid": os.getpid(),
        "process": _ev._resolve_process_index(),
        "reason": reason,
        "detail": detail or {},
        # The same single-instant (wall, mono) sample a manifest carries:
        # the merger's clock-alignment anchor for this pid.
        "ts": time.time(),
        "mono": time.monotonic(),
        "ring": _ring_records(),
        "threads": _thread_stacks(),
        "locks": [],
        "trace_roots": sorted(_ev._trace_roots),
        "emitted": _ev.emitted_count(),
    }
    try:
        doc["metrics"] = default_registry.snapshot()
    except Exception:  # pragma: no cover - a scrape bug must not lose the ring
        doc["metrics"] = None
    doc["costs"] = None
    return doc


def dump(reason: str, detail: Optional[dict] = None,
         path: Optional[str] = None, once: bool = True) -> Optional[str]:
    """Write ``flight-<pid>.json``; returns the path (None when nothing
    was written). ``once=True`` (the default) dedupes per reason — a
    stall storm produces one dump, not hundreds."""
    with _dump_lock:
        if once and reason in _dumped_reasons:
            return None
        _dumped_reasons.add(reason)
    try:
        doc = build_doc(reason, detail)
        dest = path or os.path.join(flight_dir(), f"flight-{os.getpid()}.json")
        parent = os.path.dirname(os.path.abspath(dest))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{dest}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, default=str)
            f.write("\n")
        os.replace(tmp, dest)
    except Exception:  # pragma: no cover - the recorder must never raise
        return None
    try:
        from spark_rapids_ml_tpu_torch.observability.events import emit

        emit("telemetry", action="flight_dump", path=dest, reason=reason)
    except Exception:  # pragma: no cover
        pass
    return dest


def reset() -> None:
    """Forget which reasons already dumped (test isolation)."""
    with _dump_lock:
        _dumped_reasons.clear()


def disarm() -> None:
    """Put back the exception hooks :func:`arm` replaced (test isolation;
    the reference's tests restore the hooks by hand)."""
    global _armed, _prev_excepthook, _prev_threading_excepthook
    with _arm_lock:
        if not _armed:
            return
        _armed = False
        if sys.excepthook is _on_fatal and _prev_excepthook is not None:
            sys.excepthook = _prev_excepthook
        if threading.excepthook is _on_thread_fatal and _prev_threading_excepthook is not None:
            threading.excepthook = _prev_threading_excepthook
        _prev_excepthook = _prev_threading_excepthook = None


# --- trigger installation ----------------------------------------------


def _on_fatal(exc_type, exc, tb) -> None:
    dump("fatal", {"exc": getattr(exc_type, "__name__", str(exc_type))})
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _on_thread_fatal(args) -> None:
    if args.exc_type is not SystemExit:
        dump(
            "fatal-thread",
            {
                "exc": getattr(args.exc_type, "__name__", str(args.exc_type)),
                "thread": getattr(args.thread, "name", None),
            },
        )
    if _prev_threading_excepthook is not None:
        _prev_threading_excepthook(args)


def arm() -> None:
    """Install the fatal-exception triggers (idempotent; called by
    ``events._configure_flight`` whenever ``TPUML_FLIGHT`` is set). The
    previous hooks keep running after ours. The reference also hooks its
    lock sanitizer's stall strikes here; that waits for the sanitizer
    (ROADMAP A.9, step 5's later parts)."""
    global _armed, _prev_excepthook, _prev_threading_excepthook
    with _arm_lock:
        if _armed:
            return
        _armed = True
        _prev_excepthook = sys.excepthook
        sys.excepthook = _on_fatal
        _prev_threading_excepthook = threading.excepthook
        threading.excepthook = _on_thread_fatal
