"""Declared SLOs with error-budget burn rates — objectives, not gauges.

Port of the reference's ``observability/slo.py``.

``TPUML_SLO`` declares what "healthy" means, e.g.::

    TPUML_SLO='serving.p95_ms<=50;shed.rate<=0.01;freshness.age_s<=600'

Each ``;``-separated objective is ``<name><op><threshold>`` with ``op``
in ``<=``/``>=``. :class:`SloMonitor` evaluates them on ROLLING WINDOWS
over the metrics the serving tier already publishes — no new
instrumentation on the hot path:

  - ``serving.pNN_ms`` — the tail of the window's latency distribution
    (the in-process runtime's ``serving.request.latency_ms``; the
    router's ``serving.router.latency_ms`` is read first when present,
    and comes with the distributed tier, ROADMAP A.9 item 17b), as
    bucket deltas between ticks.
    The error budget is the objective's own tail mass (p95<=50 allows
    5% of requests over 50ms); the published burn rate is
    actual-tail-mass / allowed-tail-mass, so burn > 1 = budget burning
    faster than declared.
  - ``shed.rate`` — window shed+rejected over window offered.
  - ``freshness.age_s`` (or any other name) — an instantaneous value:
    a registered source callable (:meth:`SloMonitor.set_source` — the
    lifecycle controller wires model age), else a same-named gauge;
    burn = value / threshold.

Every tick sets the ``slo.burn_rate{objective=...}`` gauge; breach and
recovery edges emit structured ``slo`` events (a first-class SCHEMA
type) and notify subscribers — the lifecycle ``DriftMonitor`` subscribes
breaches as refit votes (``DriftMonitor.on_slo_breach``); the router's
scaler, which reads the gauge as a scale-up vote, is item 17b.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Callable, Dict, List, Optional

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    counter,
    default_registry,
    gauge,
)
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_str

SLO_ENV = "TPUML_SLO"
SLO_EVERY_ENV = "TPUML_SLO_EVERY_MS"

BURN_GAUGE = "slo.burn_rate"

_PCT_RE = re.compile(r"\.p(\d{1,2})_ms$")


class SloSpecError(ValueError):
    """A malformed ``TPUML_SLO`` spec — refused loudly at parse time."""


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    op: str  # "<=" or ">="
    threshold: float

    def spec(self) -> str:
        return f"{self.name}{self.op}{self.threshold:g}"


def parse_slo(spec: str) -> List[Objective]:
    """``'a<=1;b>=2'`` -> objectives. Empty/whitespace spec -> []."""
    out: List[Objective] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^([A-Za-z0-9_.]+)\s*(<=|>=)\s*([0-9.eE+-]+)$", part)
        if m is None:
            raise SloSpecError(
                f"malformed SLO objective {part!r} "
                "(want <name><=|>=><threshold>)"
            )
        try:
            threshold = float(m.group(3))
        except ValueError:
            raise SloSpecError(f"bad threshold in SLO objective {part!r}")
        out.append(Objective(m.group(1), m.group(2), threshold))
    return out


#: Counters summed into the window's shed / offered totals. Only the
#: families live in THIS process move, so summing the whole set is safe.
_SHED_COUNTERS = (
    "serving.router.shed",
    "serving.router.rejected",
    "serving.shed.queue",
    "serving.shed.memory",
)
_OFFERED_COUNTERS = ("serving.requests", "serving.router.requests")

#: Latency histograms, preferred first (the router's view when routing).
_LATENCY_HISTS = ("serving.router.latency_ms", "serving.request.latency_ms")


def _counter_total(names) -> float:
    total = 0.0
    metrics = default_registry.metrics()
    for name in names:
        m = metrics.get(name)
        if isinstance(m, Counter):
            total += sum(m._snapshot_series().values())
    return total


def _latency_value() -> Optional[dict]:
    metrics = default_registry.metrics()
    for name in _LATENCY_HISTS:
        m = metrics.get(name)
        if isinstance(m, Histogram):
            v = m.value()
            if v["count"] > 0:
                return v
    return None


def _tail_fraction_above(value: dict, threshold: float) -> float:
    """Fraction of a (possibly delta) cumulative-bucket histogram above
    ``threshold``, linearly interpolated inside the crossing bucket."""
    count = value["count"]
    if count <= 0:
        return 0.0
    prev_le, prev_cum = 0.0, 0.0
    at = None
    for le, cum in sorted(value["buckets"].items()):
        if le >= threshold:
            if le == float("inf") or cum <= prev_cum:
                at = float(cum if le == threshold else prev_cum)
            else:
                frac = (threshold - prev_le) / (le - prev_le)
                at = prev_cum + frac * (cum - prev_cum)
            break
        prev_le, prev_cum = le, cum
    if at is None:
        at = float(count)
    return max(0.0, min(1.0, (count - at) / count))


def _delta_hist(cur: dict, prev: Optional[dict]) -> dict:
    if prev is None:
        return cur
    return {
        "buckets": {
            le: c - prev["buckets"].get(le, 0)
            for le, c in cur["buckets"].items()
        },
        "sum": cur["sum"] - prev["sum"],
        "count": cur["count"] - prev["count"],
    }


class SloMonitor:
    """Evaluate declared objectives on rolling windows; publish burn
    rates; notify subscribers on breach/recovery edges.

    ``tick()`` is deterministic (tests drive it directly);
    :meth:`start` runs it on a daemon thread every
    ``TPUML_SLO_EVERY_MS``."""

    def __init__(self, spec: Optional[str] = None):
        raw = spec if spec is not None else (env_str(SLO_ENV) or "")
        self.objectives = parse_slo(raw)
        self._lock = threading.Lock()
        self._prev: Dict[str, dict] = {}  # guarded-by: _lock
        self._breached: Dict[str, bool] = {}  # guarded-by: _lock
        self._sources: Dict[str, Callable[[], Optional[float]]] = {}
        self._subs: List[Callable[[dict], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- wiring ---

    def set_source(self, name: str, fn: Callable[[], Optional[float]]) -> None:
        """Provide the instantaneous value behind a value-objective
        (``freshness.age_s`` <- the lifecycle controller's model age)."""
        self._sources[name] = fn

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        """``fn(record)`` runs on every breach/recovery edge — the
        scale/refit vote hookup."""
        if fn not in self._subs:
            self._subs.append(fn)

    # --- evaluation ---

    def _eval_one(self, obj: Objective, prev: Dict[str, dict]) -> dict:
        pct = _PCT_RE.search("." + obj.name)
        if pct is not None and obj.op == "<=":
            q = int(pct.group(1)) / 100.0
            cur = _latency_value()
            if cur is None:
                return {"burn": 0.0, "value": None, "window": 0}
            window = _delta_hist(cur, prev.get(obj.name))
            prev[obj.name] = cur
            n = window["count"]
            if n <= 0:
                return {"burn": 0.0, "value": None, "window": 0}
            bad = _tail_fraction_above(window, obj.threshold)
            allowed = max(1.0 - q, 1e-9)
            return {"burn": bad / allowed, "value": round(bad, 6), "window": n}
        if obj.name == "shed.rate" and obj.op == "<=":
            shed = _counter_total(_SHED_COUNTERS)
            offered = _counter_total(_OFFERED_COUNTERS) + shed
            p = prev.get(obj.name) or {"shed": 0.0, "offered": 0.0}
            prev[obj.name] = {"shed": shed, "offered": offered}
            d_shed = shed - p["shed"]
            d_offered = offered - p["offered"]
            if d_offered <= 0:
                return {"burn": 0.0, "value": None, "window": 0}
            rate = d_shed / d_offered
            return {
                "burn": rate / max(obj.threshold, 1e-9),
                "value": round(rate, 6),
                "window": int(d_offered),
            }
        # Value objective: a registered source, else a same-named gauge.
        value: Optional[float] = None
        src = self._sources.get(obj.name)
        if src is not None:
            try:
                value = src()
            except Exception:
                value = None
        else:
            m = default_registry.metrics().get(obj.name)
            if isinstance(m, Gauge):
                series = m._snapshot_series()
                finite = [v for v in series.values() if v == v]
                value = max(finite) if finite else None
        if value is None:
            return {"burn": 0.0, "value": None, "window": 0}
        if obj.op == "<=":
            burn = value / max(obj.threshold, 1e-9)
        else:
            burn = obj.threshold / max(value, 1e-9)
        return {"burn": burn, "value": value, "window": 1}

    def tick(self) -> Dict[str, dict]:
        """One evaluation pass. Returns per-objective
        ``{"burn", "value", "window", "breached"}`` and publishes the
        ``slo.burn_rate`` gauge; breach/recovery edges emit ``slo``
        events and notify subscribers."""
        edges: List[dict] = []
        out: Dict[str, dict] = {}
        with self._lock:
            for obj in self.objectives:
                cell = self._eval_one(obj, self._prev)
                burn = cell["burn"]
                breached = burn > 1.0
                cell["breached"] = breached
                cell["threshold"] = obj.threshold
                out[obj.name] = cell
                gauge(
                    BURN_GAUGE,
                    "per-objective error-budget burn rate (>1 = budget "
                    "burning faster than the declared SLO allows)",
                ).set(burn, objective=obj.name)
                was = self._breached.get(obj.name, False)
                if breached and not was:
                    counter(
                        "slo.breaches", "SLO breach edges per objective"
                    ).inc(objective=obj.name)
                if breached != was:
                    self._breached[obj.name] = breached
                    edges.append(
                        {
                            "action": "breach" if breached else "recover",
                            "objective": obj.name,
                            "spec": obj.spec(),
                            "burn": round(burn, 6),
                            "value": cell["value"],
                            "window": cell["window"],
                        }
                    )
        # Emit + notify OUTSIDE the monitor lock: the sink and the
        # subscribers (scaler, drift) do their own locking.
        for rec in edges:
            emit("slo", **rec)
            for fn in list(self._subs):
                try:
                    fn(dict(rec))
                except Exception:  # a dead subscriber must not stop votes
                    pass
        return out

    # --- background loop ---

    def start(self, every_ms: Optional[float] = None) -> "SloMonitor":
        if self._thread is not None:
            return self
        period = (
            env_float(SLO_EVERY_ENV, 1000.0, minimum=1.0)
            if every_ms is None
            else float(every_ms)
        ) / 1e3
        self._stop.clear()

        def _loop():
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # pragma: no cover - keep evaluating
                    pass

        self._thread = threading.Thread(
            target=_loop, name="tpuml-slo", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)


# --- the process singleton ----------------------------------------------

_active_lock = threading.Lock()
_monitor: Optional[SloMonitor] = None  # guarded-by: _active_lock


def active() -> Optional[SloMonitor]:
    with _active_lock:
        return _monitor


def maybe_start_from_env() -> Optional[SloMonitor]:
    """Start THE process SloMonitor iff ``TPUML_SLO`` declares
    objectives (idempotent, called at package import)."""
    global _monitor
    with _active_lock:
        if _monitor is not None:
            return _monitor
    spec = env_str(SLO_ENV)
    if not spec:
        return None
    mon = SloMonitor(spec)
    if not mon.objectives:
        return None
    with _active_lock:
        if _monitor is None:
            _monitor = mon.start()
        return _monitor


def burn_rates() -> Dict[str, float]:
    """The current ``slo.burn_rate`` gauge series by objective — what
    the ElasticScaler polls as its scale-up vote."""
    m = default_registry.metrics().get(BURN_GAUGE)
    if not isinstance(m, Gauge):
        return {}
    out = {}
    for key, v in m._snapshot_series().items():
        labels = dict(key)
        name = labels.get("objective")
        if name is not None and v == v:
            out[name] = float(v)
    return out


def stop() -> None:
    """Stop and forget the singleton (test isolation)."""
    global _monitor
    with _active_lock:
        mon, _monitor = _monitor, None
    if mon is not None:
        mon.stop()
