#!/usr/bin/env python3
"""Compare the KMeans path of checkouts on one CUDA card, in turns.

    python3 chip_kmeans_ab.py PARENT . . PARENT

For each checkout directory given, in the order given, one process imports
that checkout's ``chip_smoke.py``, builds its kernels and runs its KMeans
phases: the kernel checks, the main path, the times and the profile, at
BASELINE.md config 3's shape (20M x 16 float32, k = 100 on K2 and k = 16
on K3) on blobs made on the card from the seed. The data are the same in
every run, so runs of two commits compare on one card; give them as
parent, change, change, parent to see the spread.

Prints one JSON line a run: the checkout, the card's ``nvidia-smi`` name
and power limit, the fit walls (``auto``, ``xla``, ``auto_k16``), the
predict wall, ``numIter`` of each fit, and K2's and K3's eager
``kernel_ms`` (with ``device_ms``, and K2's ``device_ms`` on the rows
sorted by label, where that checkout measures them). Any failed check of
a run fails the script. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys


def run_one(tree: str) -> dict:
    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_kmeans_ab needs a CUDA card")
    import chip_smoke as cs
    from spark_rapids_ml_tpu_torch import device as port_device

    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    torch.backends.cudnn.allow_tf32 = False
    with contextlib.redirect_stdout(io.StringIO()):
        info = cs.phase_device()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED)
        km = cs.kmeans_phases(gen, cs.peaks_for(info["name"]))
    times = km["times"]
    return {
        "tree": tree,
        "nvidia_smi": info["nvidia_smi"],
        "fit_wall_s": times["fit_wall_s"],
        "predict_wall_s": times["predict_wall_s"],
        "num_iter": km["main_path"]["num_iter"],
        **{f"{key}_{what}": times[name].get(what)
           for key, name in (("k2", "assign_stats_fused"), ("k3", "assign_stats_packed"))
           for what in ("kernel_ms", "device_ms")},
        "k2_sorted_device_ms": times["assign_stats_fused"].get("sorted_by_label", {}).get("device_ms"),
    }


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-2000:] + out.stderr[-4000:])
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
