"""Lloyd (K2 / K3, or the plain loop): the least time for the traced fits'
passes (``counts/lloyd.py``, one pass per iteration and one for the final
cost, by each fit's ``numIter``) over the device time of the operations
launched inside the port's spans whose names begin ``kmeans lloyd``, in
percent."""

from portbench.lib.peaks import least_seconds
from portbench.lib.trace import device_seconds


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.traced:
        return None
    ops = [op for op in ctx.trace.in_window() if any(s.startswith("kmeans lloyd") for s in op.spans)]
    if not ops:
        return None
    k = int(ctx.config["estimator"]["params"]["k"])
    passes = sum(int(a["iters"]) + 1 for a in ctx.traced_answers)
    bound = least_seconds(ctx.count("lloyd").work(ctx.rows, ctx.cols, k), ctx.peaks) * passes
    return 100.0 * bound / device_seconds(ops)
