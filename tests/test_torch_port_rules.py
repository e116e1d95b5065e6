"""Rules the PyTorch port keeps, checked on the CPU.

- No module of ``spark_rapids_ml_tpu_torch`` imports JAX or the JAX
  package: a fresh interpreter that imports all of them has neither in
  ``sys.modules``, and no import statement in the package names them.
- Entry points run on the card unless the caller asks for the CPU: with
  the platform at ``"cuda"`` and no card, a fit raises instead of quietly
  computing on the CPU. ``gpuId`` resolves as the reference's
  ``RowMatrix._device`` does.
- ``chip_smoke.py`` fails, printing no result, without a card, and in a
  directory that holds nothing else of the repo.
- A CUDA kernel builds with ``nvcc`` or not at all, and a wrapper given a
  CUDA tensor launches its kernel or raises: it never falls back to its
  plain version (no ``try`` in ``ops/kernels``).
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.ops.kernels import _build
from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kk
from spark_rapids_ml_tpu_torch.ops.kernels import umap as k4

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "spark_rapids_ml_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "spark_rapids_ml_tpu")


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_every_port_module_imports_without_jax():
    names = list(_modules())
    for name in ("ops.kernels.covariance", "ops.kernels.kmeans", "ops.kmeans", "models.kmeans",
                 "core.ingest", "clustering", "ops.knn", "ops.umap", "ops.kernels.umap",
                 "models.umap", "manifold", "interop", "utils.testing", "ops.randomized",
                 "ops.covariance", "core.serving", "core.data", "ops.linear", "ops.lbfgs",
                 "ops.logistic", "ops.metrics", "models.linear_regression",
                 "models.logistic_regression", "regression", "classification", "evaluation",
                 "utils.envknobs", "robustness.retry", "robustness.degrade", "robustness.faults",
                 "robustness.checkpoint", "observability.events",
                 "core.membudget", "native", "ops.dbscan", "models.dbscan", "ops.trees",
                 "models.random_forest", "serving", "serving.signature", "pipeline_fusion",
                 "pipeline_fusion.fuser", "pipeline", "tuning", "observability.metrics",
                 "serving.admission", "serving.batcher", "serving.registry", "serving.server",
                 "parallel", "parallel.mesh", "parallel.collectives", "parallel.distributed",
                 "parallel.distributed_cov", "core.moments", "lifecycle", "lifecycle.partial_fit",
                 "lifecycle.journal", "lifecycle.drift", "lifecycle.controller",
                 "observability", "observability.report", "observability.profiling",
                 "observability.heartbeat", "observability.slo", "observability.flightrec",
                 "observability.trace", "utils.tracing"):
        assert f"spark_rapids_ml_tpu_torch.{name}" in names
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_import_statement_names_jax():
    offenders = []
    for path in [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py", REPO / "chip_kmeans_ab.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert offenders == []


def test_cuda_platform_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_device.set_platform("cuda")
    x = np.random.default_rng(0).standard_normal((20, 4))
    with pytest.raises(RuntimeError, match="is_available"):
        PCA().setK(2).fit(x)
    with pytest.raises(RuntimeError, match="is_available"):
        PCA().setK(2).setCovarianceBackend("pallas").fit([x[:10], x[10:]])
    port_device.set_platform("cpu")
    try:
        assert PCA().setK(2).fit(x).pc.shape == (4, 2)
    finally:
        port_device.set_platform("cuda")
    with pytest.raises(ValueError, match="platform"):
        port_device.set_platform("tpu")


def test_gpu_id_resolves_like_the_reference(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    port_device.set_platform("cuda")
    assert port_device.resolve_device(-1) == torch.device("cuda", 0)
    assert port_device.resolve_device(1) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="gpuId=2"):
        port_device.resolve_device(2)
    port_device.set_platform("cpu")
    try:
        assert port_device.resolve_device(1) == torch.device("cpu")
    finally:
        port_device.set_platform("cuda")


def test_a_tensor_computes_where_it_lives():
    port_device.set_platform("cuda")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((30, 5)))
    model = PCA().setK(2).fit(x)  # a CPU tensor needs no card, whatever the platform
    assert model._pc_raw.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    env = _clean_env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_kernel_build_needs_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit at its default prefix")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.find_nvcc()


@pytest.mark.parametrize("name", ["centered_gram", "kmeans_assign_stats", "kmeans_assign_packed", "umap_tail"])
def test_kernel_library_is_keyed_by_its_source(name):
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
    assert path == _build.library_path(name)
    assert (_build.CSRC_DIR / f"{name}.cu").is_file()


def test_kernel_wrappers_have_no_fallback():
    for path in (PACKAGE / "ops" / "kernels").glob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path.name


@pytest.mark.parametrize("kind", ["wrapper", "source"])
def test_kernels_read_no_knob(kind):
    """A kernel's design is fixed in its source and wrapper: neither reads
    the environment (only the build's toolkit lookup in ``_build`` does)."""
    if kind == "wrapper":
        paths = [p for p in (PACKAGE / "ops" / "kernels").glob("*.py") if p.name != "_build.py"]
    else:
        paths = [*(PACKAGE / "csrc").glob("*.cu"), *(PACKAGE / "csrc").glob("*.cuh")]
    assert paths
    for path in paths:
        text = path.read_text()
        assert "environ" not in text and "getenv" not in text, path.name


def test_a_cuda_tensor_never_reaches_the_plain_version(monkeypatch, tmp_path):
    """No fallback: on a CUDA tensor the wrapper goes to the kernel build,
    which raises without nvcc; it never computes the plain version."""

    class _CudaLike:
        def __init__(self, shape):
            self.shape = torch.Size(shape)
            self.dtype = torch.float32
            self.device = torch.device("cuda")

        def dim(self):
            return len(self.shape)

        def is_contiguous(self):
            return True

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit at its default prefix")
    monkeypatch.setattr(kk, "assign_stats_plain", lambda *a, **k: pytest.fail("plain version reached"))
    for assign in (kk.assign_stats_fused, kk.assign_stats_packed):
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            assign(_CudaLike((10, 4)), _CudaLike((3, 4)))
    monkeypatch.setattr(k4, "tail_accumulate_plain", lambda *a, **k: pytest.fail("plain version reached"))
    perm, offsets = _CudaLike((12,)), _CudaLike((5,))
    perm.dtype = offsets.dtype = torch.int32
    plan = k4.TailPlan(perm, offsets, _CudaLike((12,)), 4, 2)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        k4.tail_accumulate(_CudaLike((12, 2)), plan)
