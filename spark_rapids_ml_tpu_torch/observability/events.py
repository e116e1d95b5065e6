"""Structured JSON-lines event log — the sink of the reference's
``observability/events.py``.

``TPUML_EVENT_LOG=<path|stderr>`` turns it on; unset it is off and
:func:`emit` costs one module-global check. Every record is one JSON
object per line with the reference's envelope::

    {"event": "<type>", "ts": <wall epoch>, "mono": <monotonic>,
     "pid": <os pid>, "process": 0, "run_id": null, "trace": null,
     ...type fields...}

``run_id`` and ``trace`` stay null and ``process`` 0: run scopes,
distributed traces, the flight ring and the telemetry directory wait for
the observability item (ROADMAP A.9). The sink is configured at the first
:func:`emit` (or by :func:`configure`), not when the module is imported.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from spark_rapids_ml_tpu_torch.utils.envknobs import env_str

EVENT_LOG_ENV = "TPUML_EVENT_LOG"

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
    rec = {
        "event": etype,
        "ts": time.time(),
        "mono": time.monotonic(),
        "pid": os.getpid(),
        "process": 0,
        "run_id": None,
        "trace": None,
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
