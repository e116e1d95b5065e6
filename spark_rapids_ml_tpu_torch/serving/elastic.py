"""ElasticScaler — sizing the serving gang to the traffic it carries.

Port of the reference's ``serving/elastic.py``; its decisions are the
reference's on the same signals. The ROADMAP north star is diurnal
traffic: membership churn is the NORMAL case, not the failure case. The scaler is a small control loop
over signals the telemetry registry already publishes — no new
instrumentation, just a consumer:

  - **queue depth**: mean ``outstanding + reported depth`` per live
    member (the same weighted-least-loaded signal the router routes by);
  - **shed rate**: deltas of the ``serving.router.shed`` /
    ``serving.router.rejected`` counters — any shed inside a tick says
    the gang is at capacity NOW;
  - **p95 latency vs the measured deadline**: the
    ``serving.router.latency_ms`` histogram against a budget derived
    from the autotuner's measured program walls when one is active — capacity pressure visible before the first shed.

Decisions go through hysteresis (``TPUML_ELASTIC_HYSTERESIS``
consecutive agreeing ticks), a post-action cooldown, and hard
``TPUML_ELASTIC_MIN``/``MAX`` bounds, so a noisy minute cannot flap the
gang. Scale-up is :meth:`RoutingRuntime.add_member` (the zero-shed join
protocol); scale-down retires the least-loaded member through the
drain-then-detach path. Independently of the vote machinery, every tick
checks frame-loop liveness: a member whose reported
``gang.heartbeat.age_seconds`` exceeds ``TPUML_ELASTIC_STALL_S`` is
force-retired — stalled members don't get to wait out a cooldown.

``tick()`` is public and deterministic (one sample + decision per call)
so tests drive episodes without wall-clock coupling; ``start()`` runs
the same tick on a daemon thread every ``TPUML_ELASTIC_EVERY_MS``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from spark_rapids_ml_tpu_torch.observability import autotune as _autotune
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.observability.metrics import (
    default_registry,
    percentile_from_histogram,
)
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_int
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter, counter_value

MIN_ENV = "TPUML_ELASTIC_MIN"
MAX_ENV = "TPUML_ELASTIC_MAX"
EVERY_MS_ENV = "TPUML_ELASTIC_EVERY_MS"
HIGH_ENV = "TPUML_ELASTIC_HIGH"
LOW_ENV = "TPUML_ELASTIC_LOW"
HYSTERESIS_ENV = "TPUML_ELASTIC_HYSTERESIS"
COOLDOWN_MS_ENV = "TPUML_ELASTIC_COOLDOWN_MS"
STALL_S_ENV = "TPUML_ELASTIC_STALL_S"

#: p95 request latency budget as a multiple of the autotuner's measured
#: batch-window deadline: a request should clear in a few windows; more
#: says queues are building faster than the gang drains them.
DEADLINE_WINDOWS = 8.0


class ElasticScaler:
    """The control loop over one :class:`RoutingRuntime`."""

    def __init__(
        self,
        router,
        *,
        min_members: Optional[int] = None,
        max_members: Optional[int] = None,
        every_ms: Optional[float] = None,
        high: Optional[float] = None,
        low: Optional[float] = None,
        hysteresis: Optional[int] = None,
        cooldown_ms: Optional[float] = None,
        stall_after_s: Optional[float] = None,
        deadline_ms: Optional[float] = None,
    ):
        self.router = router
        self.min_members = (
            int(min_members) if min_members is not None
            else env_int(MIN_ENV, 1, minimum=1)
        )
        self.max_members = (
            int(max_members) if max_members is not None
            else env_int(MAX_ENV, 4, minimum=1)
        )
        if self.max_members < self.min_members:
            raise ValueError(
                f"elastic bounds inverted: min {self.min_members} > "
                f"max {self.max_members}"
            )
        self.every_ms = (
            float(every_ms) if every_ms is not None
            else env_float(EVERY_MS_ENV, 200.0, minimum=10.0)
        )
        self.high = (
            float(high) if high is not None
            else env_float(HIGH_ENV, 4.0, minimum=0.0)
        )
        self.low = (
            float(low) if low is not None
            else env_float(LOW_ENV, 0.5, minimum=0.0)
        )
        self.hysteresis = (
            int(hysteresis) if hysteresis is not None
            else env_int(HYSTERESIS_ENV, 3, minimum=1)
        )
        self.cooldown_ms = (
            float(cooldown_ms) if cooldown_ms is not None
            else env_float(COOLDOWN_MS_ENV, 1000.0, minimum=0.0)
        )
        self.stall_after_s = (
            float(stall_after_s) if stall_after_s is not None
            else env_float(STALL_S_ENV, 0.0, minimum=0.0)
        )
        self.deadline_ms = deadline_ms
        self._up_votes = 0
        self._down_votes = 0
        self._cooldown_until = 0.0
        self._last_shed = self._shed_total()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: list = []  # [(action, detail)] in decision order

    # --- signals --------------------------------------------------------

    @staticmethod
    def _shed_total() -> int:
        return int(
            counter_value("serving.router.shed")
            + counter_value("serving.router.rejected")
        )

    def _p95_ms(self) -> Optional[float]:
        hist = default_registry.metrics().get("serving.router.latency_ms")
        if hist is None:
            return None
        value = hist.value()
        if not value or value.get("count", 0) < 8:
            return None
        return percentile_from_histogram(value, 0.95)  # None when empty

    @staticmethod
    def _slo_burn() -> float:
        """Worst live SLO error-budget burn rate (0.0 when no monitor is
        active or nothing is burning). Burn > 1.0 on ANY objective is a
        capacity statement with the operator's own numbers in it, so it
        votes scale-up alongside depth/shed/deadline."""
        from spark_rapids_ml_tpu_torch.observability import slo as _slo

        return max(_slo.burn_rates().values(), default=0.0)

    def _deadline_budget_ms(self) -> Optional[float]:
        """Explicit budget wins; else derive one from the autotuner's
        measured batch-window deadline. None disables the signal."""
        if self.deadline_ms is not None:
            return float(self.deadline_ms)
        tuner = _autotune.active()
        if tuner is None:
            return None
        budgets = [
            tuner.recommend_delay_s(family, 0.0)
            for family in tuner.models()
        ]
        best = max(budgets, default=0.0)
        if best <= 0.0:
            return None
        return best * 1e3 * DEADLINE_WINDOWS

    def _load(self) -> tuple:
        """(live member count, mean per-member depth) from the router's
        own selection-set view."""
        snap = self.router.snapshot()
        live = [
            m for m in snap["members"]
            if not m["dead"] and not m["joining"] and not m["retiring"]
        ]
        if not live:
            return 0, 0.0
        depth = sum(m["depth"] + m["outstanding"] for m in live) / len(live)
        return len(live), depth

    # --- the decision ---------------------------------------------------

    def tick(self) -> Optional[str]:
        """One sample + decision. Returns the action taken
        (``"scale_up"`` / ``"scale_down"`` / ``"stall_retire"``) or None.
        Deterministic given the signals — tests call it directly."""
        if self.stall_after_s > 0:
            stalled = self.router.retire_stalled(self.stall_after_s)
            if stalled:
                # Liveness beats hysteresis: a stuck member is retired
                # the tick it is seen, and the vote state resets — the
                # gang just changed shape under us.
                self._up_votes = self._down_votes = 0
                self._cooldown_until = (
                    time.monotonic() + self.cooldown_ms / 1e3
                )
                bump_counter("serving.elastic.stall", len(stalled))
                emit(
                    "elastic", action="stall_retire", members=stalled,
                    max_age_s=self.stall_after_s,
                )
                self.decisions.append(("stall_retire", tuple(stalled)))
                return "stall_retire"

        live, depth = self._load()
        shed_now = self._shed_total()
        shed_delta = shed_now - self._last_shed
        self._last_shed = shed_now
        p95 = self._p95_ms()
        budget = self._deadline_budget_ms()
        over_deadline = (
            p95 is not None and budget is not None and p95 > budget
        )

        slo_burn = self._slo_burn()
        slo_breach = slo_burn > 1.0

        pressured = (
            depth > self.high or shed_delta > 0 or over_deadline
            or slo_breach
        )
        idle = (
            depth < self.low and shed_delta == 0
            and not over_deadline and not slo_breach
        )
        if pressured:
            self._up_votes += 1
            self._down_votes = 0
        elif idle:
            self._down_votes += 1
            self._up_votes = 0
        else:
            self._up_votes = self._down_votes = 0

        now = time.monotonic()
        if now < self._cooldown_until or live == 0:
            return None

        if self._up_votes >= self.hysteresis and live < self.max_members:
            self._up_votes = self._down_votes = 0
            self._cooldown_until = now + self.cooldown_ms / 1e3
            member = self.router.add_member()
            bump_counter("serving.elastic.up")
            emit(
                "elastic", action="scale_up", member=member,
                members=live + 1, depth=round(depth, 3),
                shed_delta=shed_delta, over_deadline=over_deadline,
                slo_burn=round(slo_burn, 4),
            )
            self.decisions.append(("scale_up", member))
            return "scale_up"

        if self._down_votes >= self.hysteresis and live > self.min_members:
            self._up_votes = self._down_votes = 0
            self._cooldown_until = now + self.cooldown_ms / 1e3
            victim = self._least_loaded()
            if victim is None:
                return None
            self.router.retire_member(victim)
            bump_counter("serving.elastic.down")
            emit(
                "elastic", action="scale_down", member=victim,
                members=live - 1, depth=round(depth, 3),
            )
            self.decisions.append(("scale_down", victim))
            return "scale_down"
        return None

    def _least_loaded(self) -> Optional[int]:
        snap = self.router.snapshot()
        live = [
            m for m in snap["members"]
            if not m["dead"] and not m["joining"] and not m["retiring"]
        ]
        if len(live) <= 1:
            return None
        return min(live, key=lambda m: (m["depth"] + m["outstanding"],
                                        m["member"]))["member"]

    # --- the loop -------------------------------------------------------

    def start(self) -> "ElasticScaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        emit(
            "elastic", action="start", min=self.min_members,
            max=self.max_members, every_ms=self.every_ms,
            hysteresis=self.hysteresis,
        )

        def _loop():
            while not self._stop.wait(self.every_ms / 1e3):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - the loop must survive
                    # a transient router hiccup (e.g. a member lost mid-
                    # snapshot); the next tick re-samples from scratch.
                    if self.router._closed:
                        return

        self._thread = threading.Thread(
            target=_loop, name="tpuml-elastic-scaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.every_ms / 1e3 * 4))
            self._thread = None
        emit("elastic", action="stop", decisions=len(self.decisions))

    def __enter__(self) -> "ElasticScaler":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
