"""KMeans seeding (``ops/kmeans.py::kmeans_plusplus_init``): the host
syncs the port counts under ``sync.kmeans.seeding.*`` (its ``HostSync``
sites), per traced fit."""

from portbench.lib.fit_counters import per_fit


def read(ctx):
    return per_fit(ctx, "sync.kmeans.seeding.", "seeding_syncs")
