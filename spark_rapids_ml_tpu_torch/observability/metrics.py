"""Typed metrics — the part of the reference's ``observability/metrics.py``
the serving runtime reads: :class:`Counter`, :class:`Gauge` (with
``set_function`` and ``remove``), fixed-bucket :class:`Histogram`, the
:class:`Registry` that owns them, the module-level ``counter`` /
``gauge`` / ``histogram`` getters, ``ROW_BUCKETS``, ``TIME_BUCKETS`` and
:func:`percentile_from_histogram`.

A name is registered once with one kind; asking for it as another kind
raises :class:`MetricError`. Every metric holds one series per label set.
The plain counters the port already bumps (``utils.tracing.bump_counter``)
stay a flat dict of their own.

The text exposition (``render_prometheus_snapshot``, ``parse_exposition``,
``dump_snapshot``) and ``TPUML_METRICS_DUMP`` wait for the observability
item (ROADMAP A.9) and raise :class:`NotImplementedError` naming it;
:meth:`Registry.snapshot` gives the same state as a dict.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

#: Buckets for duration-valued histograms (seconds): 1 ms .. 60 s.
TIME_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: Buckets for row-count histograms: the serving layer's pow-2 row
#: buckets, so the histogram reads as "requests by program bucket".
ROW_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384, 65536)

DEFAULT_BUCKETS = TIME_BUCKETS

EXPOSITION_ITEM = (
    "the Prometheus text exposition is not ported yet: it is part of the "
    "observability item (ROADMAP A.9); Registry.snapshot() gives the same state"
)

LabelKey = Tuple[Tuple[str, str], ...]


class MetricError(ValueError):
    """A metric was used inconsistently (kind clash, no buckets)."""


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: LabelKey) -> str:
    """Flat display name: ``name`` or ``name{a="x",b="y"}``."""
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, Union[int, float]] = {}  # guarded by _lock

    def _snapshot_series(self) -> Dict[LabelKey, Union[int, float]]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """A count that only goes up, one series per label set."""

    kind = "counter"

    def inc(self, amount: Union[int, float] = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> Union[int, float]:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """A value that goes up and down, or a callable read when the gauge
    is read (``set_function``): a queue depth read from the queue."""

    kind = "gauge"

    def __init__(self, name: str, help: str):
        super().__init__(name, help)
        self._functions: Dict[LabelKey, Callable[[], float]] = {}  # guarded by _lock

    def set(self, value: Union[int, float], **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._functions.pop(key, None)
            self._series[key] = value

    def inc(self, amount: Union[int, float] = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series.pop(key, None)
            self._functions[key] = fn

    def remove(self, **labels) -> None:
        """Drop one series and any callable behind it (a closed runtime
        leaves no stale depth behind)."""
        key = _label_key(labels)
        with self._lock:
            self._series.pop(key, None)
            self._functions.pop(key, None)

    def value(self, **labels) -> Union[int, float]:
        key = _label_key(labels)
        with self._lock:
            fn = self._functions.get(key)
            if fn is None:
                return self._series.get(key, 0)
        return fn()  # outside the lock: the callable may take locks of its own

    def _snapshot_series(self) -> Dict[LabelKey, Union[int, float]]:
        with self._lock:
            out = dict(self._series)
            fns = list(self._functions.items())
        for key, fn in fns:
            try:
                out[key] = fn()
            except Exception:  # a dead callable must not fail a snapshot
                out[key] = float("nan")
        return out


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus semantics): per label set, a
    count per ``le`` bucket (cumulative when read), ``sum`` and ``count``."""

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise MetricError(f"histogram {name!r} needs at least one bucket")
        # label key -> [counts per bucket + the overflow, sum, count]
        self._series: Dict[LabelKey, list] = {}

    def _blank(self) -> list:
        return [[0] * (len(self.buckets) + 1), 0.0, 0]

    def observe(self, value: Union[int, float], **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        idx = next((i for i, b in enumerate(self.buckets) if v <= b), len(self.buckets))
        with self._lock:
            cell = self._series.get(key)
            if cell is None:
                cell = self._series[key] = self._blank()
            cell[0][idx] += 1
            cell[1] += v
            cell[2] += 1

    def value(self, **labels) -> dict:
        """``{"buckets": {le: cumulative count}, "sum": s, "count": n}``."""
        with self._lock:
            cell = self._series.get(_label_key(labels)) or self._blank()
            counts, total, n = cell[0][:], cell[1], cell[2]
        cum, out = 0, {}
        for b, c in zip(self.buckets, counts):
            cum += c
            out[b] = cum
        out[float("inf")] = cum + counts[-1]
        return {"buckets": out, "sum": total, "count": n}

    def _snapshot_series(self):
        with self._lock:
            keys = list(self._series)
        return {k: self.value(**dict(k)) for k in keys}


class Registry:
    """Get-or-create home of every metric; :data:`default_registry` is the
    process's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # guarded by _lock

    def _get(self, name: str, kind: type, help: str, **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, help, **kwargs)
            elif not isinstance(m, kind):
                raise MetricError(f"metric {name!r} is a {m.kind}, not a {kind.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "", buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help, buckets=buckets)

    def metrics(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    def clear(self, prefix: str = "", kinds: Optional[Tuple[str, ...]] = None) -> None:
        """Drop every metric whose name starts with ``prefix`` (optionally
        only of ``kinds``)."""
        with self._lock:
            for name in [n for n, m in self._metrics.items()
                         if n.startswith(prefix) and (kinds is None or m.kind in kinds)]:
                del self._metrics[name]

    def snapshot(self) -> dict:
        """Every metric as a JSON-ready dict, grouped by kind."""
        out = {"ts": time.time(), "counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self.metrics().items()):
            series = m._snapshot_series()
            if isinstance(m, Histogram):
                out["histograms"][name] = {
                    _series_name(name, k): {
                        "buckets": {str(le): c for le, c in v["buckets"].items()},
                        "sum": v["sum"],
                        "count": v["count"],
                    }
                    for k, v in series.items()
                }
            else:
                group = "counters" if isinstance(m, Counter) else "gauges"
                for k, v in series.items():
                    out[group][_series_name(name, k)] = v
        return out

    def render_prometheus(self) -> str:
        """Not ported: the text exposition (ROADMAP A.9)."""
        raise NotImplementedError(EXPOSITION_ITEM)


default_registry = Registry()


def counter(name: str, help: str = "") -> Counter:
    return default_registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return default_registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return default_registry.histogram(name, help, buckets=buckets)


def percentile_from_histogram(hist_value: dict, q: float) -> Optional[float]:
    """Linearly interpolated percentile from a histogram's :meth:`value`.
    ``None`` when it holds no usable signal (no observations, or all of
    them in the overflow bucket); the top finite edge when the percentile
    lands in the overflow but finite buckets hold mass."""
    count = hist_value["count"]
    if count == 0:
        return None
    target = q * count
    prev_le, prev_cum = 0.0, 0
    for le, cum in sorted(hist_value["buckets"].items()):
        if cum >= target:
            if le == float("inf"):
                return prev_le if prev_cum > 0 else None
            if cum == prev_cum:
                return le
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_le + frac * (le - prev_le)
        prev_le, prev_cum = le, cum
    return prev_le if prev_cum > 0 else None


def render_prometheus_snapshot(snapshot: dict, helps: Optional[Dict[str, str]] = None) -> str:
    """Not ported: the text exposition (ROADMAP A.9)."""
    raise NotImplementedError(EXPOSITION_ITEM)


def parse_exposition(text: str) -> Dict[str, dict]:
    """Not ported: the text exposition (ROADMAP A.9)."""
    raise NotImplementedError(EXPOSITION_ITEM)


def dump_snapshot(path: str, registry: Optional[Registry] = None) -> None:
    """Not ported: the text exposition (ROADMAP A.9)."""
    raise NotImplementedError(EXPOSITION_ITEM)
