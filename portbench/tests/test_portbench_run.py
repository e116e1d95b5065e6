"""The command's edges: the result line, the refusals, the import check
by whole top-level names, and what the benchmark's files may import."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"


def _run(args, cwd=ROOT, **env):
    full = dict(os.environ, CUDA_VISIBLE_DEVICES="", **env)
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["spark_rapids_ml_tpu_torch", "spark_rapids_ml_tpu_torch.ops.eigh",
                                  "numpy", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["spark_rapids_ml_tpu.ops.eigh"]) == ["spark_rapids_ml_tpu"]
    assert run.forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_result_line_keys_and_order():
    out = SimpleNamespace(correct=True, attempted=3, failed=0,
                          metrics={"fit_s": {"value": 0.4, "unit": "s"}},
                          device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                                  "memory_peak_bytes": 1},
                          breakdown={"device_ops": [["k", 0.1]], "idle_gaps": []},
                          checks={"pc_max_abs": {"value": float("inf"), "limit": 1e-3}})
    doc = json.loads(run.result_line(out))
    assert list(doc) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert doc["checks"]["pc_max_abs"] == {"value": None, "limit": 1e-3}


def test_a_run_without_a_card_fails_and_prints_no_result():
    done = _run(["--workload", "pca.fit", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"])
    assert done.returncode != 0 and done.stdout == ""
    assert "needs 1 CUDA card" in done.stderr


def test_an_unknown_workload_is_refused():
    done = _run(["--workload", "pca.nothing", "--seed", "1", "--seconds", "1"])
    assert done.returncode == 2 and done.stdout == "" and "unknown workload" in done.stderr


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    done = _run(["--workload", "kmeans.fit", "--seed", "3", "--seconds", "1"], cwd=tmp_path)
    assert done.returncode != 0 and done.stdout == ""


def test_the_environment_is_scrubbed(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUML_PROFILE_DIR", "/nowhere")
    monkeypatch.setenv("TPUML_COST_LEDGER", "1")
    monkeypatch.setenv("TPUML_AUTOTUNE", "on")
    run.scrub_environment(tmp_path)
    assert not [k for k in os.environ if k.startswith("TPUML_")]
    assert os.environ["TRITON_CACHE_DIR"].startswith(str(tmp_path))
    assert os.environ["TORCH_EXTENSIONS_DIR"].startswith(str(tmp_path))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH_DIR).as_posix() for p in BENCH_DIR.rglob("*.py")))
def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package(path):
    assert run.forbidden_modules(list(_imports(BENCH_DIR / path))) == []


@pytest.mark.parametrize("path", sorted(p.name for p in (BENCH_DIR / "reference").glob("*.py")))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(BENCH_DIR / "reference" / path)}
    assert tops <= {"__future__", "math", "typing", "contextlib", "numpy", "torch", "portbench"}
    assert not {n for n in _imports(BENCH_DIR / "reference" / path)
                if n.startswith("portbench.") and not n.startswith("portbench.reference")}


def test_configurations_name_only_the_port():
    for path in (BENCH_DIR / "configs").glob("*.json"):
        cls = json.loads(path.read_text())["estimator"]["class"]
        assert cls.split(".")[0] == "spark_rapids_ml_tpu_torch"
