"""Typed metrics registry — counters, gauges, fixed-bucket histograms.

Port of the reference's ``observability/metrics.py``. The flat counter
surface of ``utils/tracing.py`` (``bump_counter`` / ``counter_value`` /
``counters`` / ``clear_counters``) is a set of aliases over THIS
registry's counters, so every counter name the port bumps lands in the
registry, its snapshots and its text exposition.

  - **Types.** A name is registered once with one kind; asking for it as
    another kind raises :class:`MetricError`.
  - **Labels.** Every metric holds one time series per label set
    (``counter("retry.attempts").inc(site="ingest")``); the unlabeled
    series is the ``()`` key, which is what the flat-dict view exposes.
  - **Gauges** may carry a callable (``set_function``) evaluated at
    snapshot time — how ``gang.heartbeat.age_seconds`` reads as an age
    rather than a stale timestamp.
  - **Histograms** are fixed-bucket (Prometheus semantics: cumulative
    ``le`` buckets, ``sum``, ``count``).
  - **Exposition.** :func:`render_prometheus_snapshot` emits the text
    format (``tpuml_`` prefix, dots to underscores), byte for byte the
    reference's for the same registry operations; :meth:`Registry.snapshot`
    returns a JSON-ready dict. ``TPUML_METRICS_DUMP=<path>`` writes a
    snapshot at interpreter exit (``.prom`` suffix selects the text format).
"""

from __future__ import annotations

import atexit
import json
import re
import time
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

from spark_rapids_ml_tpu_torch.utils.envknobs import env_str
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock

METRICS_DUMP_ENV = "TPUML_METRICS_DUMP"

#: Buckets for duration-valued histograms (seconds): 1 ms .. 60 s.
TIME_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Buckets for row-count histograms: the serving layer's pow-2 shape
#: buckets, so the histogram reads directly as "programs by bucket".
ROW_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384, 65536)

DEFAULT_BUCKETS = TIME_BUCKETS

LabelKey = Tuple[Tuple[str, str], ...]


class MetricError(ValueError):
    """A metric was used inconsistently (kind clash, bad labels)."""


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: LabelKey) -> str:
    """Flat display name: ``name`` or ``name{a="x",b="y"}``."""
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


def _prom_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return f"tpuml_{out}"


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = make_lock(f"metrics.{name}")
        self._series: Dict[LabelKey, Union[int, float]] = {}  # guarded-by: _lock

    def _snapshot_series(self) -> Dict[LabelKey, Union[int, float]]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically increasing named count, one series per label set."""

    kind = "counter"

    def inc(self, amount: Union[int, float] = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> Union[int, float]:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """A value that can go up and down — or a callable evaluated at
    snapshot time (``set_function``), for ages and sizes derived from
    live state."""

    kind = "gauge"

    def __init__(self, name: str, help: str):
        super().__init__(name, help)
        self._functions: Dict[LabelKey, Callable[[], float]] = {}  # guarded-by: _lock

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
        """Drop one series (and any callable behind it) — how a finished
        gang member retires its heartbeat-age gauge instead of reporting
        an ever-growing age into every later snapshot."""
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
        return fn()  # outside the lock: user code must not deadlock us

    def _snapshot_series(self) -> Dict[LabelKey, Union[int, float]]:
        with self._lock:
            out = dict(self._series)
            fns = list(self._functions.items())
        for key, fn in fns:
            try:
                out[key] = fn()
            except Exception:  # a dead callback must not kill a scrape
                out[key] = float("nan")
        return out


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus semantics): per label set, a
    cumulative count per ``le`` bucket plus ``sum`` and ``count``."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise MetricError(f"histogram {name!r} needs at least one bucket")
        # _series maps label key -> [counts per bucket + inf, sum, count]
        self._series: Dict[LabelKey, list] = {}

    def _blank(self) -> list:
        return [[0] * (len(self.buckets) + 1), 0.0, 0]

    def observe(self, value: Union[int, float], **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            cell = self._series.get(key)
            if cell is None:
                cell = self._series[key] = self._blank()
            counts, _, _ = cell
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    idx = i
                    break
            counts[idx] += 1
            cell[1] += v
            cell[2] += 1

    def value(self, **labels) -> dict:
        """``{"buckets": {le: cumulative_count}, "sum": s, "count": n}``."""
        with self._lock:
            cell = self._series.get(_label_key(labels))
            if cell is None:
                cell = self._blank()
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
    """Get-or-create home for every metric; one instance
    (:data:`default_registry`) backs the whole process."""

    def __init__(self):
        self._lock = make_lock("metrics.registry")
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: _lock

    def _get(self, name: str, kind: type, help: str, **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise MetricError(
                    f"metric {name!r} is a {m.kind}, not a {kind.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(
        self, name: str, help: str = "", buckets: Iterable[float] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(name, Histogram, help, buckets=buckets)

    def metrics(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    # --- legacy flat-dict views (the utils/tracing counter surface) ---

    def counters_snapshot(self, prefix: str = "") -> Dict[str, Union[int, float]]:
        """Flat ``{display_name: value}`` of every counter series whose
        metric name starts with ``prefix`` — the shape the old
        ``tracing.counters()`` returned (unlabeled series keep their
        plain name, so every pre-registry assertion still holds)."""
        out: Dict[str, Union[int, float]] = {}
        for name, m in self.metrics().items():
            if not isinstance(m, Counter) or not name.startswith(prefix):
                continue
            for key, v in m._snapshot_series().items():
                out[_series_name(name, key)] = v
        return out

    def clear(self, prefix: str = "", kinds: Optional[Tuple[str, ...]] = None) -> None:
        """Drop every metric whose name starts with ``prefix`` (optionally
        restricted to ``kinds``) — test isolation, reconfigs."""
        with self._lock:
            for name in [
                n
                for n, m in self._metrics.items()
                if n.startswith(prefix) and (kinds is None or m.kind in kinds)
            ]:
                del self._metrics[name]

    # --- exposition ---

    def snapshot(self) -> dict:
        """JSON-ready snapshot of every metric, grouped by kind."""
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
        """The Prometheus text exposition format (metric names prefixed
        ``tpuml_``, dots to underscores). Delegates to the ONE shared
        renderer (:func:`render_prometheus_snapshot`), so a
        ``TPUML_METRICS_DUMP`` ``.prom`` file and a saved snapshot render
        to the same bytes for the same state."""
        helps = {name: m.help for name, m in self.metrics().items() if m.help}
        return render_prometheus_snapshot(self.snapshot(), helps=helps)


default_registry = Registry()


# --- module-level conveniences (the names the call sites use) ---


def counter(name: str, help: str = "") -> Counter:
    return default_registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return default_registry.gauge(name, help)


def histogram(
    name: str, help: str = "", buckets: Iterable[float] = DEFAULT_BUCKETS
) -> Histogram:
    return default_registry.histogram(name, help, buckets=buckets)


def percentile_from_histogram(hist_value: dict, q: float) -> Optional[float]:
    """Linear-interpolated percentile from a fixed-bucket histogram
    snapshot (``{"buckets": {le: cumulative}, "count": n}``). Returns
    ``None`` when the histogram holds no usable signal — zero
    observations, or every observation in the +Inf overflow bucket —
    so callers (``Overloaded.retry_after_ms``, the batcher deadline)
    fall back to their static defaults instead of trusting the top
    bucket edge. When the percentile itself lands in +Inf but finite
    buckets hold mass, the top finite edge is reported (the
    histogram's resolution limit). Shared by the serving shed-backoff
    hint (``serving.admission.retry_after_hint_ms``) and the SLO monitor."""
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


# --- the ONE Prometheus exposition renderer ---
#
# Everything renders a Registry.snapshot()-shaped dict through the
# functions below, so a registry and its saved snapshot give the same text.

_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:\\.|[^"\\])*)"')


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _split_series_name(series: str) -> Tuple[str, list]:
    """``name{a="x",b="y"}`` -> ``("name", [("a", "x"), ("b", "y")])``.
    Snapshot keys store raw (unescaped) label values; escaping is a
    render-time concern."""
    base, brace, rest = series.partition("{")
    if not brace:
        return series, []
    return base, [(k, v) for k, v in _LABEL_RE.findall(rest)]


def _render_labels(pairs) -> str:
    if not pairs:
        return ""
    # Sorted, matching the registry's series-key order (`_label_key`),
    # so an appended ``le`` lands where the in-registry renderer always
    # put it and exposition stays byte-stable across render paths.
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in sorted(pairs)
    )
    return f"{{{inner}}}"


def render_prometheus_snapshot(
    snapshot: dict, helps: Optional[Dict[str, str]] = None
) -> str:
    """Render a :meth:`Registry.snapshot` dict as Prometheus text
    exposition: ``# HELP``/``# TYPE`` per metric, ``tpuml_`` prefix,
    dots to underscores, label values escaped. The single renderer
    behind :meth:`Registry.render_prometheus` and ``TPUML_METRICS_DUMP``
    ``.prom`` dumps."""
    helps = helps or {}
    lines = []
    by_metric: Dict[str, list] = {}
    kinds: Dict[str, str] = {}
    for group, kind in (("counters", "counter"), ("gauges", "gauge")):
        for series, value in sorted(snapshot.get(group, {}).items()):
            base, labels = _split_series_name(series)
            kinds.setdefault(base, kind)
            by_metric.setdefault(base, []).append((labels, value))
    for base in sorted(by_metric):
        pname = _prom_name(base)
        if helps.get(base):
            lines.append(f"# HELP {pname} {_escape_help(helps[base])}")
        lines.append(f"# TYPE {pname} {kinds[base]}")
        for labels, value in by_metric[base]:
            lines.append(f"{pname}{_render_labels(labels)} {float(value)}")
    for name, series_map in sorted(snapshot.get("histograms", {}).items()):
        pname = _prom_name(name)
        if helps.get(name):
            lines.append(f"# HELP {pname} {_escape_help(helps[name])}")
        lines.append(f"# TYPE {pname} histogram")
        for series, cell in sorted(series_map.items()):
            _, labels = _split_series_name(series)
            for le, c in cell["buckets"].items():
                le_s = "+Inf" if le in ("inf", "Infinity") else le
                lines.append(
                    f"{pname}_bucket"
                    f"{_render_labels(labels + [('le', le_s)])} {c}"
                )
            suffix = _render_labels(labels)
            lines.append(f"{pname}_sum{suffix} {cell['sum']}")
            lines.append(f"{pname}_count{suffix} {cell['count']}")
    return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse Prometheus text exposition back into
    ``{metric: {"type", "help", "series": {display_name: value}}}`` —
    the conformance oracle for the round-trip test and the CI scrape
    validation gate. Raises :class:`MetricError` on a malformed line."""
    out: Dict[str, dict] = {}

    def cell(pname: str) -> dict:
        return out.setdefault(
            pname, {"type": None, "help": None, "series": {}}
        )

    for i, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            pname, _, help_text = rest.partition(" ")
            cell(pname)["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            pname, _, kind = rest.partition(" ")
            if kind not in ("counter", "gauge", "histogram"):
                raise MetricError(f"line {i}: unknown metric type {kind!r}")
            cell(pname)["type"] = kind
            continue
        if line.startswith("#"):
            continue
        m = re.match(
            r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?\s+(\S+)$", line
        )
        if m is None:
            raise MetricError(f"line {i}: malformed series line {line!r}")
        name, braces, raw = m.group(1), m.group(2) or "", m.group(3)
        labels = [
            (k, v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(braces)
        ]
        try:
            value = float(raw)
        except ValueError:
            raise MetricError(f"line {i}: non-numeric value {raw!r}")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and out.get(name[: -len(suffix)], {}).get(
                "type"
            ) == "histogram":
                base = name[: -len(suffix)]
        series = name + (
            "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
            if labels
            else ""
        )
        cell(base)["series"][series] = value
    return out


def dump_snapshot(path: str, registry: Optional[Registry] = None) -> None:
    """Write a snapshot to ``path`` — Prometheus text if it ends in
    ``.prom``, JSON otherwise."""
    registry = registry or default_registry
    with open(path, "w") as f:
        if path.endswith(".prom"):
            f.write(registry.render_prometheus())
        else:
            json.dump(registry.snapshot(), f, indent=2, default=str)
            f.write("\n")


def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    path = env_str(METRICS_DUMP_ENV)
    if path:
        try:
            dump_snapshot(path)
        except OSError:
            pass


atexit.register(_dump_at_exit)
