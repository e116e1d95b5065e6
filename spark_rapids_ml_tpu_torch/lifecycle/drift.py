"""DriftMonitor — refits fire from observed traffic, not a timer.

Port of the reference's ``lifecycle/drift.py``: the same PSI over the
same bin edges, so both packages fire on the same windows.

Serving-side scores stream in through :meth:`DriftMonitor.observe`:
per-request logistic probabilities, KMeans assignment distances —
whatever scalar the family exposes per served row. Each observation
lands in two places: the metrics registry (a ``lifecycle.drift.score``
histogram labelled by model, so the distribution is visible in every
trace/report the observability tier already assembles) and the
monitor's live window.

:meth:`tick` is the trigger: it compares the live window against the
REFERENCE distribution — the traffic shape captured when the current
model took the alias (:meth:`rebaseline`, called by the controller
after every flip) — via the Population Stability Index over the
reference's own bucket edges. PSI above ``TPUML_DRIFT_THRESHOLD`` with
at least ``TPUML_DRIFT_MIN_COUNT`` live observations fires; the first
full window after a rebaseline BOOTSTRAPS the reference instead of
firing (there is nothing to drift *from* yet). The tick body runs
under the ``drift.tick`` fault site inside a named
:class:`~spark_rapids_ml_tpu_torch.robustness.retry.RetryPolicy`, so an
injected stall/tear in the trigger path retries like every other
lifecycle stage.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.observability.metrics import histogram
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.robustness.retry import RetryPolicy, default_policy
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_int

# Laplace-style COUNT smoothing (half an observation per bucket), not a
# probability epsilon: with an epsilon, a bucket that is empty in one
# window and holds 2-3 samples in the other contributes log(count/eps)
# ~ 14 nats of pure sampling noise — measured same-distribution PSI at
# 100-sample windows had a median of 0.5, twice the canonical 0.25
# threshold. Half-count smoothing puts the same setup's p99 under 0.45
# (0.16 at 300 samples) while a one-sigma mean shift stays above 0.5.
_PSI_SMOOTH = 0.5


def population_stability_index(
    reference: np.ndarray, live: np.ndarray
) -> float:
    """PSI between two bucket-count vectors over identical edges."""
    p = reference.astype(np.float64) + _PSI_SMOOTH
    q = live.astype(np.float64) + _PSI_SMOOTH
    p /= p.sum()
    q /= q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


class DriftMonitor:
    def __init__(
        self,
        name: str,
        *,
        threshold: Optional[float] = None,
        min_count: Optional[int] = None,
        bins: int = 10,
        policy: Optional[RetryPolicy] = None,
    ):
        self.name = name
        self.threshold = (
            env_float("TPUML_DRIFT_THRESHOLD", 0.25)
            if threshold is None else float(threshold)
        )
        self.min_count = (
            env_int("TPUML_DRIFT_MIN_COUNT", 50, minimum=1)
            if min_count is None else int(min_count)
        )
        if bins < 2:
            raise ValueError(f"bins must be >= 2, got {bins}")
        self.bins = int(bins)
        self._policy = policy or default_policy()
        self._window: List[float] = []
        self._edges: Optional[np.ndarray] = None  # (bins+1,) reference edges
        self._reference: Optional[np.ndarray] = None  # (bins+2,) counts w/ tails
        self._slo_votes = 0  # pending breach votes (consumed on evaluate)

    # --- ingestion ---

    def observe(self, value: float) -> None:
        v = float(value)
        histogram(
            "lifecycle.drift.score",
            "serving-side per-row score distribution feeding drift detection",
        ).observe(v, model=self.name)
        self._window.append(v)

    def observe_many(self, values: Sequence[float]) -> None:
        for v in np.asarray(values, dtype=np.float64).ravel():
            self.observe(float(v))

    # --- reference management ---

    def rebaseline(self) -> None:
        """Forget the reference; the next full window becomes the new
        one. The controller calls this after every alias flip — drift is
        always measured against the traffic shape the CURRENT model
        started with, never an ancestor's."""
        self._edges = None
        self._reference = None
        self._window.clear()

    def _bucketize(self, values: np.ndarray) -> np.ndarray:
        """Counts over the reference edges, with open-ended tail buckets
        on both sides (live traffic may leave the reference's range —
        that IS drift, and it must land somewhere countable)."""
        inner = np.histogram(values, bins=self._edges)[0]
        lo = np.count_nonzero(values < self._edges[0])
        hi = np.count_nonzero(values > self._edges[-1])
        return np.concatenate(([lo], inner, [hi]))

    # --- the SLO vote ---

    def on_slo_breach(self, record: Optional[dict] = None) -> None:
        """An SLO error-budget breach as a refit vote. Wired as a
        subscriber of an SLO monitor (the reference's
        ``observability/slo.py``, not ported yet: ROADMAP A.9, the
        observability item; recover records are ignored), it does NOT fire a
        refit by itself — model staleness is only one of the ways a
        gang burns budget. It lowers the next tick's window floor so
        the drift evidence already on hand gets evaluated NOW instead
        of waiting out ``min_count``: a drifted model under a burning
        SLO refits a window early, a healthy one exonerates itself."""
        if record is not None and record.get("action") not in (None, "breach"):
            return
        self._slo_votes += 1
        emit(
            "lifecycle", action="slo_vote", model=self.name,
            objective=(record or {}).get("objective"),
            burn=(record or {}).get("burn"), votes=self._slo_votes,
        )

    # --- trigger ---

    def tick(self) -> Optional[float]:
        """Evaluate the trigger. Returns the PSI when drift fired, else
        None (window too small, bootstrap tick, or stable traffic)."""
        return self._policy.run(self._tick_once, "drift.tick")

    def _tick_once(self) -> Optional[float]:
        fault_point("drift.tick")
        # A pending SLO vote drops the window floor (PSI needs SOME
        # mass, so never below 2): evaluate the evidence on hand early.
        need = (
            min(self.min_count, 2) if self._slo_votes else self.min_count
        )
        if len(self._window) < need:
            return None
        self._slo_votes = 0
        values = np.asarray(self._window, dtype=np.float64)
        if self._reference is None:
            lo, hi = float(values.min()), float(values.max())
            if hi <= lo:  # degenerate constant window: widen artificially
                lo, hi = lo - 0.5, hi + 0.5
            self._edges = np.linspace(lo, hi, self.bins + 1)
            self._reference = self._bucketize(values)
            self._window.clear()
            emit(
                "lifecycle", action="drift_baseline", model=self.name,
                count=int(values.size),
            )
            return None
        psi = population_stability_index(
            self._reference, self._bucketize(values)
        )
        if psi <= self.threshold:
            self._window.clear()
            return None
        self._window.clear()
        emit(
            "lifecycle", action="drift_fire", model=self.name,
            psi=round(psi, 6), threshold=self.threshold,
            count=int(values.size),
        )
        return psi
