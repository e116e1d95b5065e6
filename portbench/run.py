"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It reads the cell from ``BENCHMARK.json``, makes the cell's
rows on the card from ``--seed``, warms the cell's own shapes (set-up),
drives the cell's traffic at the port (``spark_rapids_ml_tpu_torch``) for
``--seconds``, and compares what the window produced with the plain
reference in ``portbench/reference/``. With ``--trace 1`` it also profiles
a slice of the run and reports the cell's per-layer metrics instead of
its end-to-end ones.

The last lines on standard error are the numbers compared, each beside
its limit; the last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (the compared numbers again). It exits
with a code other than 0, and prints no result, when there is no CUDA
card (or fewer than the cell asks for), when a part of the cell cannot
be found, or when JAX or the JAX package was loaded in the process.
"""

import time

LAUNCHED_AT = time.perf_counter()

import argparse  # noqa: E402  (the clock above starts before any import)
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that may not be loaded in a run, compared whole:
#: ``spark_rapids_ml_tpu_torch`` (the port) is not ``spark_rapids_ml_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_ml_tpu")


def forbidden_modules(names) -> list:
    """The forbidden top-level names among the module names ``names``."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def scrub_environment(root: Path = ROOT) -> None:
    """The port's own knobs off (its profiler, cost ledger and autotuner
    above all: one profiler session at a time), and every kernel cache at
    a fixed path inside the checkout. The port builds its kernels into
    ``build/torch_kernels/`` of the checkout by itself."""
    for key in [k for k in os.environ if k.startswith("TPUML_")]:
        del os.environ[key]
    cache = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _finite(value):
    return value if not isinstance(value, float) or math.isfinite(value) else None


def result_line(outcome) -> str:
    """The contract's JSON object, ``checks`` last."""
    doc = {"correct": bool(outcome.correct), "attempted": int(outcome.attempted),
           "failed": int(outcome.failed), "metrics": outcome.metrics, "device": outcome.device}
    if outcome.breakdown is not None:
        doc["breakdown"] = outcome.breakdown
    doc["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]} for k, c in outcome.checks.items()}
    return json.dumps(doc, allow_nan=False)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    scrub_environment()
    sys.path.insert(0, str(ROOT))
    from portbench.lib import spec

    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as exc:
        _say(f"portbench: {exc}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _say(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import spark_rapids_ml_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as exc:
        _say(f"portbench: the port is not in this checkout: {exc}")
        return 3
    from portbench.lib import cell as cell_run

    marks = [("start", LAUNCHED_AT), ("imports", time.perf_counter())]
    _say(f"portbench: {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
         f"torch {torch.__version__} CUDA {torch.version.cuda}")
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    outcome = cell_run.execute(cell, args.seed, args.seconds, bool(args.trace), devices, marks, log=_say)
    found = forbidden_modules(list(sys.modules))
    if found:
        _say(f"portbench: forbidden modules loaded in the run: {', '.join(found)}")
        return 4
    for name, check in outcome.checks.items():
        _say(f"check {name}: {check['value']!r} limit {check['limit']!r}")
    print(result_line(outcome), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # The port may leave daemon threads behind; the result is out, so end
    # here rather than wait on them.
    os._exit(code)
