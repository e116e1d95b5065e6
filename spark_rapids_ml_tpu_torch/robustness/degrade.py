"""Degradation records — the part of the reference's
``robustness/degrade.py`` the fit memory guard needs: the
:class:`DegradationWarning` and :func:`record_degradation`, one warning,
one counter and one event per degradation. The reference's CPU fallback
(``TPUML_DEGRADE``) is not ported: a fit that fell back to the CPU would
hide the device.
"""

from __future__ import annotations

import warnings
from typing import Optional

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter


class DegradationWarning(UserWarning):
    """Structured record of a degradation: ``what`` was attempted, ``why``
    it could not run as asked, ``fallback`` that served it."""

    def __init__(self, what: str, why: str, fallback: str):
        self.what = what
        self.why = why
        self.fallback = fallback
        super().__init__(f"degraded {what}: {why}; continuing on {fallback}")


def record_degradation(
    what: str, why: str, fallback: str, fallback_label: Optional[str] = None
) -> None:
    """The warning + counter + event triple. ``fallback`` is the
    machine-readable event field (``"streaming"``); ``fallback_label`` the
    phrasing of the warning (defaults to ``fallback``)."""
    warnings.warn(DegradationWarning(what, why, fallback_label or fallback), stacklevel=4)
    bump_counter("degrade.events")
    emit("degrade", what=what, why=why, fallback=fallback)
