"""The port's own counts of a traced run's fits, for the
``program_counter`` readers: each traced fit's ``fit_report().counters``
(the counter deltas of that one fit), with the bases of the readers'
ratios written to standard error."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

#: The port's module that holds ``HostSync``; a port without it counts no
#: host sync, and the readers then report nothing rather than 0.
TRACING = "spark_rapids_ml_tpu_torch.utils.tracing"


def traced(ctx) -> Optional[List[Dict[str, float]]]:
    """One dict of counters per traced fit, or None: no traced fit, no
    device operation in the trace (on the CPU a sync site waits for
    nothing), or a port without ``HostSync``."""
    if ctx.trace is None or not ctx.trace.ops or not ctx.traced:
        return None
    if getattr(sys.modules.get(TRACING), "HostSync", None) is None:
        return None
    reports = [m.fit_report() for m in ctx.window.models[-ctx.traced:]]
    if any(r is None for r in reports):
        return None
    return [dict(r.counters) for r in reports]


def per_fit(ctx, prefix: str, metric: str) -> Optional[float]:
    """The counters under ``prefix`` summed over the traced fits, per fit."""
    fits = traced(ctx)
    if fits is None:
        return None
    total = sum(v for c in fits for k, v in c.items() if k.startswith(prefix))
    log(f"{metric}: {total} counted under {prefix}* over {len(fits)} traced fits")
    return total / len(fits)


def log(message: str) -> None:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
