"""The gang fit loop: one caller fits back to back on a gang of ranks, one
process and one card each (``configs/<config>.json``'s ``ranks``).

The run's own process is rank 0 on the first card: it holds shard 0, is
the one profiled and the one whose peak memory is read. It starts ranks
1 and up as processes (``lib/gang_member.py``), rank r on card r, each
making its own rows from the seed, and joins the gang with them through
the port's ``parallel.distributed.initialize`` (NCCL, a card per rank;
gloo on the CPU) with a collective timeout. Each fit of the gang is one
line to every member, then rank 0's own fit: every rank fits once, a
fresh estimator on its resident rows. Set-up ends with one warm fit of
the gang, after which every rank moves the objects set-up made out of the
collector's reach (``gc.freeze``): they live as long as the run, and a
full collection that scans them in any one rank stalls the whole gang.
The window and the traced slice are those of ``loops/fit.py``, timed on
rank 0.

A failure in any rank ends every rank within seconds: a watcher thread
sees a member exit, rank 0's own fit may raise; either way the members
are killed, the failure is written out, and the run exits with
:data:`GANG_FAILED` before anything can wait in a collective for a rank
that is gone. At the end every member reports a digest of each model it
fitted and its rows' column sums, and each rank's slowest window fit and
longest full collection are written out; ``judge`` counts the ranks whose models
differ in any bit from rank 0's (``ranks_differ``) and the ranks whose
sums differ from the reference's replay of their rows (``shards_off``).
"""

from __future__ import annotations

import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, List

import numpy as np

from portbench.lib import spec
from portbench.lib.gang_member import GcPauses, digest, peak_host_kb, slow_fit
from portbench.lib.window import Window

CHIPS = 4
#: The run's exit code when a rank fails.
GANG_FAILED = 5
MEMBER = Path(__file__).resolve().parents[1] / "lib" / "gang_member.py"
context = spec.load_module(Path(__file__).with_name("fit.py"), "loops").context


def _say(message: str) -> None:
    print(f"portbench: {message}", file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Gang:
    """Ranks 1 and up, their pipes and the watcher that ends the run when
    one of them exits before it is told to."""

    def __init__(self, stage, mix: dict):
        from spark_rapids_ml_tpu_torch import device as port_device
        from spark_rapids_ml_tpu_torch.parallel import distributed

        config, device = stage.config, stage.devices[0]
        ranks = int(config["ranks"])
        cuda = device.type == "cuda"
        if cuda and len(stage.devices) < ranks:
            raise ValueError(f"a gang of {ranks} ranks takes a card each; given {len(stage.devices)}")
        port_device.set_platform(device.type)  # the gang's devices are the rows'
        backend = "nccl" if cuda else "gloo"
        address = f"127.0.0.1:{_free_port()}"
        timeout_s = int(mix["collective_timeout_s"])
        self.members: List[subprocess.Popen] = []
        self._closing = False
        for rank in range(1, ranks):
            args = {"config": config, "seed": stage.seed, "rank": rank, "address": address, "backend": backend,
                    "card": rank if cuda else None, "timeout_s": timeout_s}
            self.members.append(subprocess.Popen(
                [sys.executable, str(MEMBER), json.dumps(args)], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True, cwd=str(spec.ROOT)))
        threading.Thread(target=self._watch, name="portbench gang watcher", daemon=True).start()
        distributed.initialize(address, ranks, 0, local_device_ids=[device.index or 0] if cuda else None,
                               heartbeat_timeout_seconds=timeout_s, backend=backend)
        _say(f"gang of {ranks} ranks up over {backend}")

    def _watch(self) -> None:
        while not self._closing:
            for rank, p in enumerate(self.members, start=1):
                code = p.poll()
                if code is not None and not self._closing:
                    self.fail(f"rank {rank} exited with code {code}")
            time.sleep(0.1)

    def fail(self, why: str) -> None:
        """End every rank and the run: the members are killed, the failure
        written out, and this process exits with :data:`GANG_FAILED`."""
        for p in self.members:
            if p.poll() is None:
                p.kill()
        _say(f"gang failed, 1 failed: {why}; every rank ended")
        sys.stderr.flush()
        os._exit(GANG_FAILED)

    def fit(self, fit_once):
        """One fit of the whole gang: a line to every member, then rank 0's."""
        try:
            for p in self.members:
                p.stdin.write("fit\n")
                p.stdin.flush()
            return fit_once()
        except Exception as exc:  # any rank's failure ends the gang
            import traceback

            traceback.print_exc()
            self.fail(f"rank 0's fit raised {type(exc).__name__}: {exc}")

    def close(self) -> List[dict]:
        """Tell every member to end and collect its report."""
        self._closing = True
        reports = []
        for rank, p in enumerate(self.members, start=1):
            try:
                out, _ = p.communicate("end\n", timeout=120)
            except subprocess.TimeoutExpired:
                self.fail(f"rank {rank} did not report")
            lines = [ln for ln in out.splitlines() if ln.strip()]
            if p.returncode != 0 or not lines:
                self.fail(f"rank {rank} ended with code {p.returncode} and no report")
            reports.append(json.loads(lines[-1]))
        return reports


def run(stage, seconds: float, mix: dict, profiler: Any) -> Window:
    generator = spec.load_module(spec.BENCH_DIR / "data" / f"{stage.config['generator']}.py", "data")
    sums = generator.column_sums(stage.x).cpu().tolist()
    gang = Gang(stage, mix)
    stage.mark("gang up")
    digests = [digest(gang.fit(stage.fit_once))]
    gc.collect()
    gc.freeze()
    pauses = GcPauses()
    stage.mark("warm fit")
    start = time.perf_counter()
    win = Window(start, start)
    while True:
        win.attempted += 1
        t0 = time.perf_counter()
        model = gang.fit(stage.fit_once)
        done = time.perf_counter()
        win.calls.append((t0, done, done))
        win.models.append(model)
        win.end = done
        if win.end - start >= seconds:
            break
    if profiler is not None:
        with profiler:
            for _ in range(int(mix["trace_fits"])):
                win.models.append(gang.fit(stage.fit_once))
                win.traced += 1
        win.trace = profiler.result
    pauses.close()
    gc.unfreeze()
    digests += [digest(m) for m in win.models]
    reports = gang.close()
    for report in reports:
        if report["forbidden"]:
            gang.fail(f"rank {report['rank']} loaded {', '.join(report['forbidden'])}")
    _say("peak host memory (VmHWM) by rank, GB: " + ", ".join(
        f"{r['rank']} {r['peak_host_kb'] / 1e6:.3f}" for r in [{"rank": 0, "peak_host_kb": peak_host_kb()}] + reports))
    walls = [done - t0 for t0, _, done in win.calls]
    worst = max(range(len(walls)), key=walls.__getitem__)
    own = slow_fit(worst + 1, walls[worst], win.models[worst])
    _say("slowest fit by rank (gang fit number, 0 the warm fit; wall s; its longest host stages s): " + "; ".join(
        f"{rank} {r['fit']} {r['wall']} {r['stages']}" for rank, r in
        [(0, own)] + [(rep["rank"], rep["slowest"]) for rep in reports if rep.get("slowest")]))
    _say("full collections in the window by rank (count, longest s): " + "; ".join(
        f"{rank} {g['count']} {g['longest']}" for rank, g in
        [(0, pauses.report())] + [(rep["rank"], rep["gc"]) for rep in reports]))
    win.samples = [{"rank": 0, "digests": digests, "sums": sums}] + reports
    return win


def judge(samples: List[dict], x, ref: dict, reference) -> dict:
    """``ranks_differ``: the ranks whose models differ in any bit from
    rank 0's, fit by fit, or that fitted another number of times;
    ``shards_off``: the ranks whose rows' column sums differ from the
    reference's replay of them (or that reported none)."""
    by_rank = {int(s["rank"]): s for s in samples}
    want = by_rank[0]["digests"]
    replayed = ref["shard_sums"].double().cpu().numpy()
    ranks = replayed.shape[0]
    differ = sum(1 for r in range(1, ranks) if r not in by_rank or by_rank[r]["digests"] != want)
    off = sum(1 for r in range(ranks)
              if r not in by_rank or not np.array_equal(np.asarray(by_rank[r]["sums"], dtype=np.float64), replayed[r]))
    return {"ranks_differ": float(differ), "shards_off": float(off)}
