"""One gang member of a gang cell (rank 1 and up; the run's own process is
rank 0, ``loops/gang_fit.py``):

    python3 portbench/lib/gang_member.py '<json arguments>'

It makes its rank's rows on its card (``card``; the CPU for none) from
the seed, reports their
float64 column sums, joins the gang (``parallel.distributed.initialize``
of the port), then fits once for every ``fit`` line on its standard
input, each fit a fresh estimator on its resident rows, as rank 0 does.
After the first (warm) fit it moves set-up's objects out of the
collector's reach (``gc.freeze``), as rank 0 does. On ``end`` (or the end
of its input) it prints one JSON line: its rank, a digest of each fitted
model's bits in order, the column sums, its peak host memory, its slowest
fit, its full collections after the warm fit and any forbidden module it
loaded; then it exits at once.
Any exception ends the process with code 1 after its traceback; the
process also ends when its parent dies.
"""

from __future__ import annotations

import ctypes
import gc
import hashlib
import json
import os
import resource
import signal
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def digest(model) -> str:
    """The bits of a fitted PCA model's components and ratios, as host
    float64 (what ``reference/pca.read_fit`` reads)."""
    import numpy as np

    h = hashlib.sha256(np.ascontiguousarray(model.pc, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(model.explainedVariance, dtype=np.float64).tobytes())
    return h.hexdigest()[:32]


def slow_fit(index: int, wall: float, model) -> dict:
    """A fit's number in the gang (0 the warm fit), its wall and the four
    stages that took the most host time in it (the port's spans), where a
    stall of one rank shows against the others' wait."""
    stages = model.fit_report().stage_totals() if model.fit_report() is not None else {}
    top = sorted(stages.items(), key=lambda kv: -kv[1]["seconds"])[:4]
    return {"fit": index, "wall": round(wall, 4), "stages": {k: round(v["seconds"], 4) for k, v in top}}


class GcPauses:
    """The full (generation 2) collections of this process from now until
    :meth:`close`: how many, and the longest, in seconds."""

    def __init__(self):
        self.count, self.longest, self._t0 = 0, 0.0, None
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.count += 1
            self.longest = max(self.longest, time.perf_counter() - self._t0)
            self._t0 = None

    def close(self) -> None:
        if self._note in gc.callbacks:
            gc.callbacks.remove(self._note)

    def report(self) -> dict:
        return {"count": self.count, "longest": round(self.longest, 4)}


def peak_host_kb() -> int:
    """This process's peak resident host memory, in kB: ``VmHWM`` of
    ``/proc/self/status``, or where that file has none, the kernel's
    ``ru_maxrss``."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)


def _die_with_parent() -> None:
    """SIGKILL this process when its parent dies (Linux ``PR_SET_PDEATHSIG``)."""
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def main(args: dict) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib import spec, system
    from portbench.run import forbidden_modules
    from spark_rapids_ml_tpu_torch import device as port_device
    from spark_rapids_ml_tpu_torch.parallel import distributed

    config, seed, rank = args["config"], int(args["seed"]), int(args["rank"])
    card = args["card"]
    device = torch.device("cpu") if card is None else torch.device("cuda", int(card))
    port_device.set_platform(device.type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    generator = spec.load_module(spec.BENCH_DIR / "data" / f"{config['generator']}.py", "data")
    x = generator.make(config, config["data"], seed, device, rank=rank)
    sums = generator.column_sums(x).cpu().tolist()
    distributed.initialize(args["address"], int(config["ranks"]), rank,
                           local_device_ids=None if card is None else [int(card)],
                           heartbeat_timeout_seconds=int(args["timeout_s"]), backend=args["backend"])
    fit_once = system.fitter(config, seed, x)
    digests, slowest, pauses = [], None, None
    for line in sys.stdin:
        command = line.strip()
        if command == "end":
            break
        if command == "fit":
            t0 = time.perf_counter()
            model = fit_once()
            wall = time.perf_counter() - t0
            digests.append(digest(model))
            if len(digests) == 1:  # the warm fit
                gc.collect()
                gc.freeze()
                pauses = GcPauses()
            elif slowest is None or wall > slowest["wall"]:
                slowest = slow_fit(len(digests) - 1, wall, model)
    print(json.dumps({"rank": rank, "digests": digests, "sums": sums, "peak_host_kb": peak_host_kb(),
                      "slowest": slowest, "gc": pauses.report() if pauses else None,
                      "forbidden": forbidden_modules(list(sys.modules))}), flush=True)


if __name__ == "__main__":
    _die_with_parent()
    try:
        main(json.loads(sys.argv[1]))
    except Exception:  # a member's failure ends it; its parent ends the gang
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    # NCCL's teardown may wait on peers that have exited: end here.
    os._exit(0)
