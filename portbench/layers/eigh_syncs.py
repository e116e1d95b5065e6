"""Eigensolve (``ops/eigh.py``): the host syncs the port counts under
``sync.eigh.*`` (its ``HostSync`` sites), per traced fit."""

from portbench.lib.fit_counters import per_fit


def read(ctx):
    return per_fit(ctx, "sync.eigh.", "eigh_syncs")
