"""Continuous-training lifecycle — the freshness half of the train→serve
loop. Port of the reference's ``lifecycle/`` package.

The pieces, each usable alone:

- :func:`partial_fit <spark_rapids_ml_tpu_torch.lifecycle.partial_fit.partial_fit>`
  — incremental refit: seed a segmented solver from the previous model's
  solution over NEW rows (KMeans centers, logistic L-BFGS weights, linear
  FISTA coefficients), or merge exact streaming moments for PCA (a
  tensor's rows through kernel K1's float64 route). Also reachable as
  ``Estimator.partial_fit``.
- :class:`CycleJournal <spark_rapids_ml_tpu_torch.lifecycle.journal.CycleJournal>`
  — the crash-safe record of one refit cycle, written with the
  checkpoint tier's atomic-write discipline: ``kill -9`` at any stage
  resumes the SAME cycle on restart, idempotently per stage.
- :class:`DriftMonitor <spark_rapids_ml_tpu_torch.lifecycle.drift.DriftMonitor>`
  — refits fire from observed traffic (score / assignment-distance
  distributions in the metrics registry), not a timer.
- :class:`LifecycleController
  <spark_rapids_ml_tpu_torch.lifecycle.controller.LifecycleController>` — the
  journaled state machine: ingest → refit → quality-gate → register →
  warm → alias flip → post-flip watch, each stage behind a named fault
  site + RetryPolicy, with automatic registry rollback when live traffic
  regresses after the flip.
"""

from spark_rapids_ml_tpu_torch.lifecycle.controller import (
    CycleOutcome,
    LifecycleController,
)
from spark_rapids_ml_tpu_torch.lifecycle.drift import DriftMonitor
from spark_rapids_ml_tpu_torch.lifecycle.journal import CycleJournal
from spark_rapids_ml_tpu_torch.lifecycle.partial_fit import partial_fit

__all__ = [
    "CycleJournal",
    "CycleOutcome",
    "DriftMonitor",
    "LifecycleController",
    "partial_fit",
]
