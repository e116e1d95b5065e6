"""A tiny rehearsal of every cell and both kinds of run on the CPU: the
traffic mix drives the port's public estimators, the window closes, and
the plain reference finds the answers correct."""

import json

import pytest

from portbench.tests.rehearse import rehearse
from portbench.tests.test_portbench_spec import BENCH, CELLS


def _e2e(name):
    return [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_is_correct(name, trace):
    out = rehearse(name, trace=bool(trace))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert out.device["platform"] == "cpu" and out.device["memory_peak_bytes"] == 0
    assert all(c["value"] <= c["limit"] for c in out.checks.values())
    e2e = _e2e(name)
    if trace:
        assert {"busy_s", "window_s"} <= set(out.device) and out.breakdown is not None
        # No device on the CPU: only the host-side readers have something to read.
        assert set(out.metrics) <= {"eigh_ms", "idle_share.fit"}
    else:
        assert set(out.metrics) == set(e2e)
        assert all(m["value"] > 0 for m in out.metrics.values())
    json.dumps(out.metrics, allow_nan=False)
