"""The device trace of a traced run, and the reductions the readers share.

:class:`Profiler` opens one ``torch.profiler`` session (host and CUDA
activities) around a slice of a run and marks the slice with a range of
its own, :data:`WINDOW`. The session is written as a Chrome trace into
the run's temporary directory, read back into a :class:`Trace` and
deleted. The port's ``TraceRange`` spans enter the session as
``record_function`` ranges (``user_annotation``) on the thread that opens
them; CUDA kernels, copies and sets come from CUPTI with the correlation
id of the host call that launched them, so each device operation is
attributed to the spans around its launch.

Only one profiler session may be open in a process: the benchmark keeps
the port's own (``TPUML_PROFILE_DIR``) off.
"""

from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW = "portbench traced slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Op:
    """One device operation; times in seconds on the trace's clock."""

    name: str
    start: float
    end: float
    launch_tid: Optional[int] = None
    launch_ts: Optional[float] = None
    spans: Tuple[str, ...] = ()


@dataclass
class Span:
    name: str
    tid: int
    start: float
    end: float


@dataclass
class Trace:
    window: Tuple[float, float]
    window_tid: Optional[int]
    ops: List[Op] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self) -> List[Op]:
        """Device operations launched inside the traced slice."""
        lo, hi = self.window
        return [op for op in self.ops if op.launch_ts is not None and lo <= op.launch_ts <= hi]

    def busy_s(self) -> float:
        """Seconds of the slice in which some device operation ran."""
        return sum(b - a for a, b in _union(self.ops, self.window))

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def _union(ops: Iterable[Op], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    lo, hi = window
    merged: List[List[float]] = []
    for a, b in sorted((max(op.start, lo), min(op.end, hi)) for op in ops if op.end > lo and op.start < hi):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def parse(doc: dict) -> Trace:
    """A :class:`Trace` from a Chrome trace document (``traceEvents``)."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    launches: Dict[int, Tuple[int, float]] = {}
    spans: List[Span] = []
    window, window_tid = None, None
    raw_ops = []
    for e in events:
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            raw_ops.append((e.get("name", "?"), ts, ts + dur, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[int(corr)] = (e.get("tid"), ts)
        elif cat == "user_annotation" and not str(e.get("name", "")).startswith("ProfilerStep#"):
            if e.get("name") == WINDOW:
                window, window_tid = (ts, ts + dur), e.get("tid")
            else:
                spans.append(Span(e.get("name", "?"), e.get("tid"), ts, ts + dur))
    if window is None:
        window = (min((o[1] for o in raw_ops), default=0.0), max((o[2] for o in raw_ops), default=0.0))
    by_tid: Dict[int, List[Span]] = {}
    for s in spans:
        by_tid.setdefault(s.tid, []).append(s)
    for lst in by_tid.values():
        lst.sort(key=lambda s: s.start)
    trace = Trace(window, window_tid, spans=spans)
    for name, start, end, corr in raw_ops:
        tid, ts = launches.get(int(corr), (None, None)) if corr is not None else (None, None)
        enclosing: Tuple[str, ...] = ()
        if tid is not None:
            lst = by_tid.get(tid, [])
            i = bisect_right([s.start for s in lst], ts)
            enclosing = tuple(s.name for s in sorted(lst[:i], key=lambda s: s.end - s.start)
                              if s.start <= ts <= s.end)
        trace.ops.append(Op(name, start, end, tid, ts, enclosing))
    trace.ops.sort(key=lambda op: op.start)
    return trace


def device_seconds(ops: Iterable[Op]) -> float:
    return sum(op.end - op.start for op in ops)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the slice, and the
    idle gaps summed by what the host was doing: the innermost span around
    the launch of the operation that ended the gap (``caller thread`` for a
    launch outside every span; ``slice end`` after the last)."""
    lo, hi = trace.window
    by_name: Dict[str, float] = {}
    for op in trace.ops:
        a, b = max(op.start, lo), min(op.end, hi)
        if b > a:
            by_name[op.name] = by_name.get(op.name, 0.0) + (b - a)
    busy = _union(trace.ops, trace.window)
    starts = sorted(trace.ops, key=lambda op: op.start)
    gaps: Dict[str, float] = {}
    edge, j = lo, 0
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            while j < len(starts) and starts[j].start < a:
                j += 1
            nxt = starts[j] if j < len(starts) else None
            label = "slice end" if nxt is None or a >= hi else (nxt.spans[0] if nxt.spans else "caller thread")
            gaps[label] = gaps.get(label, 0.0) + (a - edge)
        edge = max(edge, b)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}


def _all_threads():
    """Kineto's setting that records the ranges and launches of every
    thread (the scoring callers run beside the thread that opens the
    session); None where this torch has no such setting."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class Profiler:
    """One profiled slice: :meth:`prepare` (slow: the session's CUPTI and
    host set-up, done before the slice so that it does not eat into it),
    then ``with profiler: ...`` records the slice; then ``.result``. The
    session runs on a schedule of one warm-up and one recorded step, so
    preparing records nothing."""

    def __init__(self, device: torch.device):
        self.device = device
        self.result: Optional[Trace] = None
        self._prof = None
        self._range = None

    def prepare(self) -> None:
        if self._prof is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts, experimental_config=_all_threads(), on_trace_ready=self._collect,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1))
        self._prof.__enter__()

    def __enter__(self) -> "Profiler":
        self.prepare()
        self._prof.step()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.step()
        self._prof.__exit__(*exc)
        self._prof = None

    def _collect(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                self.result = parse(json.load(fh))
        finally:
            os.unlink(path)
