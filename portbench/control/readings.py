"""Readings that set the comparison's limits, at a configuration's own size.

    python3 portbench/control/readings.py --config <name> --seeds <s1,...> \
        [--control-seeds <...>] [--fault-seeds <...>]

For each seed it makes the configuration's rows on the card, fits the
port's estimator once and judges the fit against the float64 reference,
exactly as a run of the benchmark judges its window (the lower
readings). For each control seed it puts the reference in the program's
place (``control/stand_in.py``) at the precision below the
configuration's, float32 with TF32 products (the upper readings), and
beside it, as a witness, in float32 with IEEE products. For each fault
seed it fits the program on the first half of the rows and judges that
fit as one of all of them (the half-rows fault). Every reading is judged
against the configuration's limits as a run would be, and printed with
its ``correct``: one JSON line per seed. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(config_name: str, seeds, control_seeds, device, bench_dir=None, emit=print,
             fault_seeds=()) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.control import stand_in
    from portbench.lib import cell, spec, system

    bench_dir = Path(bench_dir) if bench_dir is not None else spec.BENCH_DIR
    bench = spec.load_json(bench_dir.parent / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == config_name)
    config = spec.load_json(bench_dir.parent / entry["file"])
    generator = spec.load_module(bench_dir / "data" / f"{config['generator']}.py", "data")
    reference = spec.load_module(bench_dir / "reference" / f"{config['family']}.py", "reference")
    torch.backends.cuda.matmul.allow_tf32 = False

    def judged(answer, ref) -> dict:
        checks = cell.judge(reference.judge_fit([reference.read_fit(answer)], ref), config["limits"])
        return dict({k: c["value"] for k, c in checks.items()}, correct=cell.within(checks))

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t0 = time.perf_counter()
        x = generator.make(config, config["data"], seed, device)
        line = {"config": config_name, "seed": seed}
        ref = None
        if seed in seeds:
            model = system.fitter(config, seed, x)()
            answer = reference.read_fit(model)
            del model
            ref = reference.as_answer(reference.fit(x, config, seed))
            line["program"] = judged(answer, ref)
        ref = ref if ref is not None else reference.as_answer(reference.fit(x, config, seed))
        if seed in fault_seeds:
            half = system.fitter(config, seed, x[: int(x.shape[0]) // 2])()
            line["fault_half_rows"] = judged(half, ref)
            del half
        if seed in control_seeds:
            for label, precision in (("control_tf32", "tf32"), ("witness_ieee_f32", "float32")):
                line[label] = judged(stand_in.fitter(config, seed, x, precision, bench_dir)(), ref)
        line["seconds"] = round(time.perf_counter() - t0, 3)
        emit(json.dumps(line))
        del x
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    parse = lambda s: [int(v) for v in s.split(",") if v]
    readings(args.config, parse(args.seeds), parse(args.control_seeds), torch.device("cuda", 0),
             emit=lambda s: print(s, flush=True), fault_seeds=parse(args.fault_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
