"""The upper readings of a gang configuration's limits, at its own size:

    python3 portbench/control/gang_readings.py --config <name> --seeds <s1,...>

on a host with a card per rank. For each seed it makes rank 0's rows on
card 0 (the reference replays the other ranks on theirs), fits the
float64 reference of all the ranks' rows, and judges against it, as a run
judges its window: the control, the reference in the program's place at
the precision below the configuration's (float32 with TF32 products);
beside it the witness, the same in float32 with IEEE products; and the
dropped-rank fault, the float64 fit of all ranks but the last, which is
what a merge that leaves one rank's moments out computes. One JSON line
per seed, each reading with its ``correct``. The lower readings are the
program's, from the benchmark's own runs (their ``checks``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(config_name: str, seeds, device, emit=print) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib import cell, spec

    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == config_name)
    config = spec.load_json(spec.ROOT / entry["file"])
    generator = spec.load_module(spec.BENCH_DIR / "data" / f"{config['generator']}.py", "data")
    reference = spec.load_module(spec.BENCH_DIR / "reference" / f"{config['family']}.py", "reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = int(config["ranks"])

    def judged(answer: dict, ref: dict) -> dict:
        checks = cell.judge(reference.judge_fit([answer], ref), config["limits"])
        return dict({k: c["value"] for k, c in checks.items()}, correct=cell.within(checks))

    for seed in seeds:
        t0 = time.perf_counter()
        x = generator.make(config, config["data"], seed, device)
        ref = reference.as_answer(reference.fit(x, config, seed))
        line = {"config": config_name, "seed": seed}
        for label, kwargs in (("control_tf32", {"precision": "tf32"}), ("witness_ieee_f32", {"precision": "float32"}),
                              ("fault_rank_dropped", {"ranks": range(ranks - 1)})):
            line[label] = judged(reference.as_answer(reference.fit(x, config, seed, **kwargs)), ref)
        line["seconds"] = round(time.perf_counter() - t0, 3)
        emit(json.dumps(line))
        del x
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gang_readings: no CUDA card", file=sys.stderr)
        return 3
    readings(args.config, [int(v) for v in args.seeds.split(",") if v], torch.device("cuda", 0),
             emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
