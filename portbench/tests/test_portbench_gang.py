"""The gang cell, ``pca.fit.gang4``, on the CPU: whole tiny runs of its loop
over a gloo gang (``loops/gang_fit.py``; rank 0 is the run's process, the
others ``lib/gang_member.py``), each in a process of its own, since a
process joins one gang in its life.

A sound run reads ``correct``; a merge that leaves out one rank's moments
or counts one rank twice, and one rank's model altered by less than the
component limit, read not correct; a rank that raises ends the run with
the loop's exit code within seconds, and leaves no rank behind.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench.lib import spec

ROOT = Path(__file__).resolve().parents[2]

#: A tiny run of the cell in a fresh process: ``RANKS`` ranks of 3,000 x 64
#: rows, a fault (``FAULT``, code run in rank 0 before the run) and the
#: outcome as one JSON line.
RUN = """
import json, os, sys, time
import torch
import spark_rapids_ml_tpu_torch.linalg.row_matrix as row_matrix
import spark_rapids_ml_tpu_torch.parallel.distributed as distributed
from portbench.lib import cell as cell_run, spec

cell = spec.load_cell("pca.fit.gang4")
cell.config.update(rows=3000, cols=64, ranks={ranks})
cell.config["data"]["block_rows"] = 1000
{fault}
out = cell_run.execute(cell, 2**31 + 91, 0.3, {trace}, [torch.device("cpu")], [("start", time.perf_counter())],
                       log=lambda *a: None)
print(json.dumps({{"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
                  "metrics": sorted(out.metrics), "checks": out.checks}}))
"""

FAULTS = {
    # Rank 0's merge sums the others' moments but not its own.
    "merge leaves out a rank": """
orig = distributed.all_reduce_sum
distributed.all_reduce_sum = lambda t: orig(t) - t
""",
    # Rank 0's merge counts its own moments twice.
    "merge counts a rank twice": """
orig = distributed.all_reduce_sum
distributed.all_reduce_sum = lambda t: orig(t) + t
""",
    # Rank 0's components moved by 1e-6, far under the component limit.
    "one rank's model altered": """
orig = row_matrix.eigh_auto
def eigh(*args, **kw):
    w, v, promoted = orig(*args, **kw)
    v = v.clone()
    v[0, 0] += 1e-6
    return w, v, promoted
row_matrix.eigh_auto = eigh
""",
}

#: The member's failure: every merge of ranks 1 and up raises (the port's
#: fault site, armed from the environment the members inherit; rank 0's
#: plan was read when it imported the port, before this was set).
RAISES = """
os.environ["TPUML_FAULTS"] = "collective.psum=always:fatal"
"""

TIMEOUT = 240


def _run(fault: str = "", ranks: int = 2, trace: bool = False) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", RUN.format(ranks=ranks, fault=fault, trace=trace)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=TIMEOUT)


def _outcome(done: subprocess.CompletedProcess) -> dict:
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_the_gang_cell_resolves_with_a_loop_of_four_cards():
    cell = spec.load_cell("pca.fit.gang4")
    assert cell.chips == 4 and cell.loop().CHIPS == 4
    assert cell.config["ranks"] * cell.config["rows"] == cell.config["global_rows"] == 50_000_000
    names = {m["name"] for m in cell.per_layer}
    assert {"merge_ms", "covariance_roofline", "eigh_ms", "fit_mfu", "syncs_per_fit"} <= names
    assert "seeding_ms" not in names and [m["name"] for m in cell.end_to_end] == ["setup_s", "fit_s"]


def test_a_whole_tiny_gang_run_is_correct():
    out = _outcome(_run(ranks=4, trace=True))
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0, out
    assert sorted(out["checks"]) == ["ev_max_rel", "pc_max_abs", "ranks_differ", "shards_off"]
    assert out["checks"]["ranks_differ"]["value"] == 0 and out["checks"]["shards_off"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_gang_is_not_correct(fault):
    out = _outcome(_run(FAULTS[fault]))
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    if fault == "one rank's model altered":
        assert checks["ranks_differ"]["value"] > 0
        assert checks["pc_max_abs"]["value"] <= checks["pc_max_abs"]["limit"]
    else:
        assert (checks["pc_max_abs"]["value"] > checks["pc_max_abs"]["limit"]
                or checks["ev_max_rel"]["value"] > checks["ev_max_rel"]["limit"]), checks


def test_a_rank_that_raises_ends_the_run_within_seconds():
    t0 = time.perf_counter()
    done = _run(RAISES, ranks=4)
    took = time.perf_counter() - t0
    assert done.returncode == spec.load_module(ROOT / "portbench" / "loops" / "gang_fit.py", "loops").GANG_FAILED
    assert "gang failed" in done.stderr and "InjectedFault" in done.stderr, done.stderr[-3000:]
    assert took < 60, took
    assert not done.stdout.strip()
    assert not _members_alive()


def _members_alive() -> list:
    """This file's gang members still running (their arguments hold the
    runs' seed)."""
    alive = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().decode(errors="replace")
        except OSError:
            continue
        if "gang_member.py" in cmd and str(2**31 + 91) in cmd:
            alive.append(pid)
    return alive
