"""The whole fit: every host sync the port counts (``sync.*``, one
counter per ``HostSync`` site), per traced fit."""

from portbench.lib.fit_counters import per_fit


def read(ctx):
    return per_fit(ctx, "sync.", "syncs_per_fit")
