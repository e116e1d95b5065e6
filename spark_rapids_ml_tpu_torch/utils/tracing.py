"""Profiling ranges and counter aliases — port of the reference's
``utils/tracing.py``.

  - :class:`TraceRange` / ``NvtxRange`` — the RAII range (the reference's
    nine ARGB colours), recording span id / parent id / depth, an ``ok``
    flag and the exception type when the body raises, and feeding the
    ambient run context (for ``model.fit_report()`` stage trees) and the
    event log (as ``span`` records) when either is active. The ring of
    ``(name, start, end)`` tuples keeps the reference's shape, and the
    disabled path stays allocation-light (the reference's budget).
    On CUDA each range is also an NVTX range (``torch.cuda.nvtx``), and
    while a ``torch.profiler`` session is active it is entered as a
    ``torch.profiler.record_function`` of the same name, so ranges show up
    by name in the trace ``observability.profiling.maybe_profile`` writes
    (the counterpart of the reference's ``jax.profiler.TraceAnnotation``).
  - ``bump_counter`` / ``counter_value`` / ``counters`` /
    ``clear_counters`` — aliases over the typed registry's counters
    (``observability/metrics.py``), with the flat-dict semantics of before.

A span's ``start``/``end``/``dur`` are host clock readings
(``time.perf_counter``): around a CUDA launch they time the enqueue, not
the card's work, as the reference's spans time JAX's async dispatch.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from enum import Enum
from typing import Deque, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from spark_rapids_ml_tpu_torch.observability.events import (
    current_run as _current_run,
    current_trace as _current_trace,
    emit as _emit,
    enabled as _log_enabled,
)
from spark_rapids_ml_tpu_torch.observability.metrics import default_registry


class TraceColor(Enum):
    """ARGB colors, values identical to the reference's ``TraceColor``."""

    GREEN = 0xFF76B900
    BLUE = 0xFF0071C5
    PURPLE = 0xFF8A2BE2
    CYAN = 0xFF00FFFF
    RED = 0xFFFF0000
    YELLOW = 0xFFFFFF00
    WHITE = 0xFFFFFFFF
    DARK_GREEN = 0xFF006400
    ORANGE = 0xFFFFA500


# Alias matching the reference class name for drop-in reads of calling code.
NvtxColor = TraceColor

_events_lock = threading.Lock()
_events: Deque[Tuple[str, float, float]] = deque(maxlen=4096)


# --- counter aliases (registry-backed) ---


def bump_counter(name: str, amount: int = 1) -> None:
    """Increment a named counter (created at zero on first bump)."""
    default_registry.counter(name).inc(amount)


def counter_value(name: str) -> int:
    return default_registry.counter(name).value()


def counters(prefix: str = "") -> dict:
    """Snapshot of all counters whose name starts with ``prefix``."""
    return default_registry.counters_snapshot(prefix)


def clear_counters(prefix: str = "") -> None:
    """Drop every counter whose name starts with ``prefix``."""
    default_registry.clear(prefix, kinds=("counter",))


def recent_events() -> list:
    with _events_lock:
        return list(_events)


def clear_events() -> None:
    with _events_lock:
        _events.clear()


#: Per-thread mirror of the open-range stacks — (span_id, name, start)
#: tuples keyed by thread ident: "what is every thread doing right now".
_open_stacks: dict = {}  # guarded-by: _events_lock


def open_spans() -> dict:
    """Currently-open span stacks per live thread (outermost first):
    ``{ident: {"thread": name, "spans": [{span,name,depth,open_s}]}}``."""
    now = time.perf_counter()
    with _events_lock:
        items = {i: list(s) for i, s in _open_stacks.items() if s}
    alive = {t.ident: t.name for t in threading.enumerate()}
    return {
        ident: {
            "thread": alive[ident],
            "spans": [
                {
                    "span": sid,
                    "name": name,
                    "depth": depth,
                    "open_s": round(now - start, 6),
                }
                for depth, (sid, name, start) in enumerate(stack)
            ],
        }
        for ident, stack in items.items()
        if ident in alive
    }


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` (autograd profiler) session is open in
    this process."""
    return bool(getattr(_autograd_profiler, "_is_profiler_enabled", False))


# --- the RAII range ---

_span_ids = itertools.count(1)
# Globally-unique span ids: a per-process prefix (pid + random epoch, so
# a recycled pid cannot collide across a long telemetry run) + a local
# counter. Cross-process trace assembly resolves parents by these ids.
_SPAN_EPOCH = f"{os.getpid():x}-{os.urandom(2).hex()}"
_span_stack = threading.local()


def _new_span_id() -> str:
    return f"{_SPAN_EPOCH}-{next(_span_ids):x}"


def _stack() -> list:
    s = getattr(_span_stack, "s", None)
    if s is None:
        s = _span_stack.s = []
    return s


def current_span_id() -> Optional[str]:
    """This thread's innermost open span id — the parent a cross-thread
    or cross-process child should adopt (events.current_trace_context)."""
    s = getattr(_span_stack, "s", None)
    return s[-1] if s else None


class TraceRange:
    """RAII profiling range: ``with TraceRange("compute cov", TraceColor.RED): ...``

    Each range carries a process-unique ``span_id``; nesting is tracked
    per thread, so ``parent_id``/``depth`` let reports rebuild the stage
    tree. On exit, ``ok`` records whether the body raised and
    ``exc_type`` the exception class name. NVTX ranges carry no colour
    through ``torch.cuda.nvtx``; the colour is kept for call-site parity.
    """

    __slots__ = (
        "name", "color", "_start", "_pushed", "_record",
        "span_id", "parent_id", "depth", "ok", "exc_type",
    )

    def __init__(self, name: str, color: Optional[TraceColor] = None):
        self.name = name
        self.color = color
        self._start = 0.0
        self._pushed = False
        self._record = None
        self.ok = True
        self.exc_type: Optional[str] = None

    def __enter__(self) -> "TraceRange":
        stack = _stack()
        if stack:
            self.parent_id = stack[-1]
        else:
            # Thread/process entry point: parent to the ambient trace's
            # hand-off span (set by trace_scope or the env carrier), so a
            # dispatcher thread's or gang member's root spans attach to
            # the submitting span in the merged trace tree.
            tc = _current_trace()
            self.parent_id = tc.span_id if tc is not None else None
        self.depth = len(stack)
        self.span_id = _new_span_id()
        stack.append(self.span_id)
        self._start = time.perf_counter()
        ident = threading.get_ident()
        with _events_lock:
            _open_stacks.setdefault(ident, []).append(
                (self.span_id, self.name, self._start)
            )
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._pushed = True
        if profiler_active():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None) -> None:
        if self._record is not None:
            self._record.__exit__(exc_type, exc, tb)
            self._record = None
        if self._pushed:
            torch.cuda.nvtx.range_pop()
            self._pushed = False
        end = time.perf_counter()
        stack = _stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        elif self.span_id in stack:  # tolerate interleaved exits
            stack.remove(self.span_id)
        self.ok = exc_type is None
        self.exc_type = getattr(exc_type, "__name__", None)
        ident = threading.get_ident()
        with _events_lock:
            _events.append((self.name, self._start, end))
            mirror = _open_stacks.get(ident)
            if mirror is not None:
                for i in range(len(mirror) - 1, -1, -1):
                    if mirror[i][0] == self.span_id:
                        del mirror[i]
                        break
                if not mirror:
                    del _open_stacks[ident]
        # Everything below is inert unless a run scope or event sink is
        # active — the disabled path allocates one dict at most when a
        # report is actually being recorded.
        ctx = _current_run()
        if ctx is not None or _log_enabled():
            record = {
                "name": self.name,
                "start": self._start,
                "end": end,
                "dur": end - self._start,
                "ok": self.ok,
                "exc": self.exc_type,
                "depth": self.depth,
                "parent": self.parent_id,
                "span": self.span_id,
                "thread": threading.get_ident(),
            }
            if ctx is not None:
                ctx.add_span(record)
            _emit("span", **record)


# Alias matching the reference class name (NvtxRange.java:37).
NvtxRange = TraceRange
