"""KMeans seeding (``ops/kmeans.py::kmeans_plusplus_init``): the card's
idle time inside the seeding's device interval, per traced fit, in
milliseconds. For each of the port's ``kmeans seeding`` spans the
interval runs from the start of the first device operation launched in
the span to the end of the last; its idle time is the interval less the
union of every device operation in it."""

from portbench.lib.fit_counters import log
from portbench.lib.trace import Trace


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans_named("kmeans seeding")
    idle, seen = 0.0, 0
    for span in spans:
        ops = [op for op in ctx.trace.ops
               if op.launch_tid == span.tid and op.launch_ts is not None and span.start <= op.launch_ts <= span.end]
        if not ops:
            continue
        lo, hi = min(op.start for op in ops), max(op.end for op in ops)
        idle += (hi - lo) - Trace((lo, hi), None, ctx.trace.ops).busy_s()
        seen += 1
    if not seen:
        return None
    log(f"seeding_idle_ms: {idle:.6f} s idle in {seen} seeding intervals")
    return 1e3 * idle / seen
