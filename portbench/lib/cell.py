"""One run of one cell: set-up, the window, the traced slice, the
comparison with the plain reference, and the result line's contents.

The order is the contract's: the program's set-up and window, driven by
the loop the cell's traffic names (``loops/<loop>.py``); the peak of
device memory read; the program's state freed; then the reference, which
works the fitted model out again from the same rows and judges the
program's answers (every fit of the window, and what else the loop kept).
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Dict, List, Optional

import torch

from portbench.lib import peaks, spec, system
from portbench.lib.trace import Profiler, breakdown


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: Dict[str, Any]
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None


def smi() -> Optional[str]:
    """The card's name, SM clock, power draw and limit, temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().replace("\n", " | ")


def _counter(path: str) -> Any:
    """A program counter ``module:attribute`` (a copy of a dict of them)."""
    module, attr = path.split(":")
    value = getattr(sys.modules.get(module), attr, None)
    return dict(value) if isinstance(value, dict) else value


def _reader(bench_dir: Path, kind: str, name: str) -> ModuleType:
    return spec.load_module(bench_dir / kind / f"{name}.py", kind)


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number the configuration
    gives no limit is refused rather than passed."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise spec.SpecError(f"no limit in the configuration for {', '.join(missing)}")
    return {name: {"value": values[name], "limit": limits[name]} for name in values}


def within(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def _sync(devices: List[torch.device]) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, devices: List[torch.device],
            marks: List[tuple], log=print) -> Outcome:
    """Run ``cell`` once on ``devices`` (the first holds the rows).
    ``marks`` holds ``(label, perf_counter)`` pairs from the process's
    start (``"start"``) on; set-up's later steps are added to it."""
    config, mix, device = cell.config, cell.traffic, devices[0]
    loop = cell.loop()
    launched_at = marks[0][1]

    def mark(label: str, sync: bool = True) -> None:
        if sync:
            _sync(devices)
        marks.append((label, time.perf_counter()))

    system.estimator_class(config)
    mark("the port's modules", sync=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
    mark("device context")
    x = cell.generator().make(config, config["data"], seed, device)
    mark("data")
    reference = cell.reference()
    profiler = Profiler(device) if trace else None
    counters = config.get("launch_counters", [])
    stage = SimpleNamespace(config=config, seed=seed, x=x, devices=devices, mark=mark,
                            fit_once=system.fitter(config, seed, x))
    win = loop.run(stage, seconds, mix, profiler)
    setup_s = win.start - launched_at
    log("portbench: set-up split s: " + ", ".join(
        f"{label} {t - prev:.3f}" for (_, prev), (label, t) in zip(marks, marks[1:])))
    log(f"portbench: after the window: {smi()}")
    log("portbench: launches in the run, set-up's included: " + ", ".join(
        f"{c} {_counter(c)}" for c in counters))
    walls = [done - t0 for t0, _, done in win.calls]
    if walls:
        ranked = sorted(walls)
        log(f"portbench: {len(walls)} window calls, walls s: min {ranked[0]:.4f} median "
            f"{ranked[len(ranked) // 2]:.4f} max {ranked[-1]:.4f}; in order {[round(w, 4) for w in walls][:60]}")
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"), default=0)
    answers = [reference.read_fit(m) for m in win.models]
    ctx = SimpleNamespace(
        config=config, rows=int(config["rows"]), cols=int(config["cols"]),
        peaks=peaks.for_device(torch.cuda.get_device_name(device)) if device.type == "cuda" else None,
        trace=win.trace, traced=win.traced, answers=answers, window=win, setup_s=setup_s,
        count=lambda name: spec.count(cell.bench_dir, name), **loop.context(win, answers))
    kind = "layers" if trace else "end_to_end"
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = _reader(cell.bench_dir, kind, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": len(devices), "memory_peak_bytes": int(peak)}
    brk = None
    if trace and win.trace is not None:
        tr = win.trace
        named: Dict[str, int] = {}
        for sp in tr.spans:
            named[sp.name] = named.get(sp.name, 0) + 1
        log(f"portbench: trace: {len(tr.ops)} device ops ({sum(op.launch_tid is not None for op in tr.ops)} "
            f"with their launch), {len(tr.in_window())} launched in the slice, {win.traced} traced calls or fits; "
            f"spans {sorted(named.items(), key=lambda kv: -kv[1])[:12]}")
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        brk = breakdown(tr)
    samples, attempted, failed, completed = win.samples, win.attempted, win.failed, len(win.calls)
    del win, stage, ctx
    gc.collect()
    _sync(devices)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference.fit(x, config, seed)
    values = reference.judge_fit(answers, reference.as_answer(ref)) if answers else {}
    if samples:
        values.update(loop.judge(samples, x, ref, reference))
    log(f"portbench: reference and comparison took {time.perf_counter() - t0:.3f} s")
    checks = judge(values, config["limits"])
    correct = completed > 0 and failed == 0 and within(checks)
    return Outcome(correct, attempted, failed, metrics, dev, checks, brk)
