"""KMeans seeding (``ops/kmeans.py::kmeans_plusplus_init``): the device
time of the operations launched inside the port's ``kmeans fit`` span and
outside every span whose name begins ``kmeans lloyd``, per traced fit, in
milliseconds (the port has no seeding span of its own)."""

from portbench.lib.trace import device_seconds


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    ops = [op for op in ctx.trace.in_window()
           if "kmeans fit" in op.spans and not any(s.startswith("kmeans lloyd") for s in op.spans)]
    if not ops:
        return None
    return 1e3 * device_seconds(ops) / ctx.traced
