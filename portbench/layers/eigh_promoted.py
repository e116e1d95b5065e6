"""Eigensolve (``ops/eigh.py::eigh_auto``): the share of its calls in the
traced fits that promoted themselves to the full ``eigh``
(``eigh.auto.promoted`` over ``eigh.auto.calls``), in percent: the share
of the subspace iterations' and the Rayleigh–Ritz step's work thrown
away."""

from portbench.lib.fit_counters import log, traced


def read(ctx):
    fits = traced(ctx)
    if fits is None:
        return None
    calls = sum(c.get("eigh.auto.calls", 0) for c in fits)
    if not calls:
        return None
    promoted = sum(c.get("eigh.auto.promoted", 0) for c in fits)
    log(f"eigh_promoted: {promoted} of {calls} eigh_auto calls promoted, {len(fits)} traced fits")
    return 100.0 * promoted / calls
