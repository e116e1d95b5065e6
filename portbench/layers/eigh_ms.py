"""Eigensolve (``ops/eigh.py``): the time the port's ``auto eigh`` span
adds to a fit, per traced fit, in milliseconds: from the later of the
span's start and the end of the last device operation launched before
it (the covariance, which the host does not wait for before the span
opens) to the span's end. The solver reads its decisions back to the
host inside the span, so the span ends when the solve has."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans_named("auto eigh")
    if not spans:
        return None
    total = 0.0
    for span in spans:
        before = [op.end for op in ctx.trace.ops
                  if op.launch_tid == span.tid and op.launch_ts is not None and op.launch_ts < span.start]
        total += span.end - max([span.start] + before)
    return 1e3 * total / len(spans)
