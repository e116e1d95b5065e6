"""Covariance layer (``linalg/row_matrix.py`` → K1): the least time for
the layer's counted work (``counts/covariance.py``) over the device time
of the operations launched inside the port's ``compute cov`` span, per
traced fit, in percent."""

from portbench.lib.peaks import least_seconds
from portbench.lib.trace import device_seconds


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.traced:
        return None
    ops = [op for op in ctx.trace.in_window() if "compute cov" in op.spans]
    if not ops:
        return None
    bound = least_seconds(ctx.count("covariance").work(ctx.rows, ctx.cols), ctx.peaks) * ctx.traced
    return 100.0 * bound / device_seconds(ops)
