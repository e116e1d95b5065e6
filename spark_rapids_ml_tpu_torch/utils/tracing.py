"""Profiling ranges and plain counters.

Twin of the reference's ``utils/tracing.py``: the same RAII range and the
same nine ARGB colours (reference ``NvtxRange``/``NvtxColor``), here over
``torch.cuda.nvtx.range_push``/``range_pop`` when CUDA is available, so
the ranges show up in any NVTX-aware trace. Off CUDA the range costs one
availability check. The counters are a plain dict under a lock; the
reference's metrics registry waits for the observability slice (the
event log's JSON-lines sink is ``observability/events.py``).
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Dict, Optional

import torch


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


class TraceRange:
    """``with TraceRange("compute cov", TraceColor.RED): ...`` — an NVTX
    range on CUDA, nothing elsewhere. NVTX ranges carry no colour through
    ``torch.cuda.nvtx``; the colour is kept for call-site parity."""

    __slots__ = ("name", "color", "_pushed")

    def __init__(self, name: str, color: Optional[TraceColor] = None):
        self.name = name
        self.color = color
        self._pushed = False

    def __enter__(self) -> "TraceRange":
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._pushed = True
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None) -> None:
        if self._pushed:
            torch.cuda.nvtx.range_pop()
            self._pushed = False


_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}


def bump_counter(name: str, amount: int = 1) -> None:
    """Increment a named counter (created at zero on first bump)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + amount


def counter_value(name: str) -> int:
    with _counters_lock:
        return _counters.get(name, 0)


def counters(prefix: str = "") -> Dict[str, int]:
    """Snapshot of every counter whose name starts with ``prefix``."""
    with _counters_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def clear_counters(prefix: str = "") -> None:
    """Drop every counter whose name starts with ``prefix``."""
    with _counters_lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]
