"""Gang merge (``linalg/row_matrix.py`` to ``parallel/collectives.py``):
the device time of the operations launched inside the port's ``gang
merge`` span on rank 0, per traced fit, in milliseconds: the shifts' and
the moments' all-reduces (NCCL's kernels, whose time holds the wire and
rank 0's wait for the slowest rank) and the rebase around them."""

from portbench.lib.trace import device_seconds


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    ops = [op for op in ctx.trace.in_window() if "gang merge" in op.spans]
    if not ops:
        return None
    return 1e3 * device_seconds(ops) / ctx.traced
