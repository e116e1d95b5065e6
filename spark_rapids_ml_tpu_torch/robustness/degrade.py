"""Degradation records — the part of the reference's
``robustness/degrade.py`` the port needs: the :class:`DegradationWarning`
and :func:`record_degradation`, one warning, one counter and one event
per degradation, and :func:`run_degradable` without its fallback. The
reference's CPU fallback (``TPUML_DEGRADE=cpu``) is not ported: a fit
that fell back to the CPU would hide the device, so that mode is refused.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, TypeVar

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

T = TypeVar("T")

DEGRADE_ENV = "TPUML_DEGRADE"


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


def degrade_mode() -> str:
    """``TPUML_DEGRADE``: ``"off"`` (the default) or ``"cpu"``, which the
    port refuses where the reference would fall back."""
    return env_choice(DEGRADE_ENV, ("off", "cpu"), "off")


def run_degradable(accel_fn: Callable[[], T], what: str) -> T:
    """The reference's ``run_degradable`` without its CPU fallback: run
    ``accel_fn`` and let its errors propagate (the reference's mode
    ``off``). ``TPUML_DEGRADE=cpu`` raises ``NotImplementedError`` naming
    ``what`` before anything runs."""
    if degrade_mode() == "cpu":
        raise NotImplementedError(
            f"TPUML_DEGRADE=cpu: the port does not degrade the {what} to a "
            "fallback run (it would hide the device); unset it or set it to off"
        )
    return accel_fn()
