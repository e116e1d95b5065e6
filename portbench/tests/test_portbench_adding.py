"""A later change adds a cell, a configuration, an end-to-end and a
per-layer metric, a traffic mix and a new kind of loop, one that judges
the outputs it keeps under a limit of its own, as new files and new
entries only: on a copy of the benchmark, no existing file of
``portbench/`` changes and the new cells run end to end, correct."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NEW_CELLS = """
import json, sys
from portbench.tests.rehearse import rehearse
for name, trace in (("pca_wide.fit", True), ("pca_wide.transform", False)):
    out = rehearse(name, trace=trace, seconds=0.3)
    print(json.dumps({"cell": name, "correct": out.correct, "attempted": out.attempted,
                      "metrics": sorted(out.metrics), "checks": sorted(out.checks)}))
"""

#: A kind of traffic the benchmark does not have: set-up fits once, then
#: one caller projects consecutive views of the rows, and the outputs it
#: keeps are judged against the reference's components.
TRANSFORM_LOOP = """
import time

import torch

from portbench.lib.window import Window, note_failure

CHIPS = 1


def run(stage, seconds, mix, profiler):
    model, rows = stage.fit_once(), int(mix["batch_rows"])
    model.transform(stage.x[:rows])
    stage.mark("warm call")
    win = Window(time.perf_counter(), time.perf_counter())
    while win.end - win.start < seconds:
        r0 = (win.attempted * rows) % (int(stage.x.shape[0]) - rows + 1)
        win.attempted += 1
        t0 = time.perf_counter()
        try:
            out = model.transform(stage.x[r0:r0 + rows])
            done = time.perf_counter()
            win.calls.append((t0, done, done))
            if len(win.samples) < int(mix["samples"]):
                win.samples.append((r0, rows, out))
        except Exception:
            note_failure("transform")
            win.failed += 1
        win.end = time.perf_counter()
    return win


def context(win, answers):
    rows = sum(n for _, n, _ in win.samples[:1]) * len(win.calls)
    return {"rows_per_s": rows / (win.end - win.start) if win.calls else None}


def judge(samples, x, ref, reference):
    gap = 0.0
    for r0, n, out in samples:
        want = x[r0:r0 + n].double() @ ref["pc"].double()
        got = out.double()
        got = got * torch.where(torch.sum(got * want, dim=0) < 0, -1.0, 1.0)
        gap = max(gap, float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want))))
    return {"proj_rel": gap}
"""


def _digests(folder: Path) -> dict:
    return {p.relative_to(folder).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_configuration_and_metric_need_only_new_files(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "spark_rapids_ml_tpu_torch", tmp_path / "spark_rapids_ml_tpu_torch")
    before = _digests(bench)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())

    config = json.loads((bench / "configs" / "pca_12p5m_d1024.json").read_text())
    config.update(name="pca_wide_d2048", cols=2048)
    config["limits"]["proj_rel"] = 1e-5
    (bench / "configs" / "pca_wide_d2048.json").write_text(json.dumps(config))
    (bench / "counts" / "pca_wide_d2048.py").write_text(
        "def fit_flops(ctx):\n    return ctx.count('covariance').work(ctx.rows, ctx.cols)['flops']\n")
    (bench / "layers" / "fit_wall_ms.py").write_text(
        "def read(ctx):\n    return None if ctx.fit_s is None else 1e3 * ctx.fit_s\n")
    doc["configs"].append({"name": "pca_wide_d2048", "source": "https://example.org/wide",
                           "file": "portbench/configs/pca_wide_d2048.json", "reduced": ["rows"],
                           "why": "a wider covariance"})
    (bench / "loops" / "transform_closed1.py").write_text(TRANSFORM_LOOP)
    (bench / "traffic" / "transform_closed1.json").write_text(
        json.dumps({"loop": "transform_closed1", "batch_rows": 3000, "samples": 3}))
    (bench / "end_to_end" / "rows_per_s.py").write_text("def read(ctx):\n    return ctx.rows_per_s\n")
    doc["workloads"].append({"name": "pca_wide.fit", "config": "pca_wide_d2048", "traffic": "fit_closed1",
                             "chips": 1, "why": "a wider covariance"})
    doc["workloads"].append({"name": "pca_wide.transform", "config": "pca_wide_d2048",
                             "traffic": "transform_closed1", "chips": 1, "why": "one caller projecting rows"})
    for m in doc["end_to_end"]:
        if m["name"] == "fit_s":
            m["workloads"].append("pca_wide.fit")
    doc["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s", "better": "higher", "bound": 0.05,
                              "source": "host_clock", "workloads": ["pca_wide.transform"]})
    doc["per_layer"].append({"name": "fit_wall_ms", "unit": "ms", "better": "lower", "source": "host_clock",
                             "layer": "the whole fit", "moves": "fit_s", "workloads": ["pca_wide.fit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    rehearse_py = bench / "tests" / "rehearse.py"
    text = rehearse_py.read_text()
    assert '"pca": (' in text  # the tiny shapes are keyed by family, so the new config rides them
    done = subprocess.run([sys.executable, "-c", NEW_CELLS], cwd=tmp_path, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert done.returncode == 0, done.stderr[-3000:]
    fit, transform = (json.loads(line) for line in done.stdout.strip().splitlines()[-2:])
    assert fit["correct"] and "fit_wall_ms" in fit["metrics"]
    assert transform["correct"] and transform["attempted"] > 0
    assert transform["metrics"] == ["rows_per_s", "setup_s"] and transform["checks"] == ["proj_rel"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/pca_wide_d2048.json", "counts/pca_wide_d2048.py",
                                        "layers/fit_wall_ms.py", "loops/transform_closed1.py",
                                        "traffic/transform_closed1.json", "end_to_end/rows_per_s.py"}
