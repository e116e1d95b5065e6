"""Device: the share of the traced slice's idle time that falls behind a
host sync, in percent. An idle gap counts when it starts (the card has
drained) inside one of the port's ``sync <site>`` spans, on any thread, or
no more than ``SLACK`` after the span's end; the rest of the idle time is
the host's work between launches. The port opens those spans only while a
profiler session is open."""

from portbench.lib.fit_counters import log
from portbench.lib.trace import _union

#: How long after a sync span's end a gap that starts still counts as
#: behind it: the host's and the card's clocks in a trace differ by a few
#: microseconds.
SLACK = 20e-6


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    syncs = [(s.start, s.end + SLACK) for s in tr.spans if s.name.startswith("sync ")]
    if not syncs:
        return None
    lo, hi = tr.window
    edge, idle, behind = lo, 0.0, 0.0
    for a, b in _union(tr.ops, tr.window) + [(hi, hi)]:
        if a > edge:
            idle += a - edge
            if any(s <= edge <= e for s, e in syncs):
                behind += a - edge
        edge = max(edge, b)
    if idle <= 0:
        return None
    log(f"sync_idle_share.fit: {behind:.6f} of {idle:.6f} idle s behind {len(syncs)} sync spans")
    return 100.0 * behind / idle
