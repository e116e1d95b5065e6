"""The port's Spark layer below the adapter, after the reference's
``tests/test_spark_layer.py`` and the contract suite's ``TestExecutorMath``.

- The discovery script ``spark/discovery/get_gpus_resources.sh``: the
  addresses of ``CUDA_VISIBLE_DEVICES``, else of ``nvidia-smi`` (a fake
  one on ``PATH`` here), else an empty list; never a Python fallback.
- Resource resolution: the explicit ordinal, then the Spark task resource
  ``"gpu"``, then 0; the task's card at its position in
  ``CUDA_VISIBLE_DEVICES`` as the device index; ``pin_process_to_chip``
  sets ``CUDA_VISIBLE_DEVICES`` and raises, leaving it as it was, once
  CUDA is initialized.
- The adapter's import gate without pyspark.
- ``bringup_executor`` from a Spark task resource, in a process of its
  own (gloo, a world of one).
- ``TestExecutorMath``: the numpy forwards against the port's core models
  (1e-6), every function bitwise the reference's ``executor_math`` on the
  same inputs, and the module importable with neither jax nor torch.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import spark_rapids_ml_tpu_torch
from spark_rapids_ml_tpu.spark import executor_math as jem
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.spark import executor_math as tem
from spark_rapids_ml_tpu_torch.spark import (
    pin_process_to_chip,
    resolve_device_index,
    resolve_device_ordinal,
    task_gpu_address,
)

REPO = Path(__file__).resolve().parents[1]
SCRIPT = os.path.join(os.path.dirname(spark_rapids_ml_tpu_torch.__file__), "spark", "discovery",
                      "get_gpus_resources.sh")


@pytest.fixture
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _discover(env):
    out = subprocess.run(["/bin/bash", SCRIPT], capture_output=True, text=True, env=env, timeout=30)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


class TestDiscoveryScript:
    def test_cuda_visible_devices_are_the_addresses(self):
        got = _discover({"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "0,1,2,3"})
        assert got == {"name": "gpu", "addresses": ["0", "1", "2", "3"]}

    def test_nvidia_smi_indices_without_the_variable(self, tmp_path):
        fake = tmp_path / "nvidia-smi"
        fake.write_text('#!/bin/sh\n[ "$1" = "--query-gpu=index" ] || exit 3\nprintf "0\\n 1\\n2\\n"\n')
        fake.chmod(0o755)
        got = _discover({"PATH": f"{tmp_path}:/usr/bin:/bin"})
        assert got == {"name": "gpu", "addresses": ["0", "1", "2"]}

    def test_the_variable_outranks_nvidia_smi(self, tmp_path):
        fake = tmp_path / "nvidia-smi"
        fake.write_text("#!/bin/sh\necho 0\necho 1\n")
        fake.chmod(0o755)
        got = _discover({"PATH": f"{tmp_path}:/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "1"})
        assert got["addresses"] == ["1"]

    def test_empty_without_either(self):
        assert _discover({"PATH": "/nonexistent"}) == {"name": "gpu", "addresses": []}

    def test_the_script_falls_back_to_no_interpreter(self):
        text = open(SCRIPT).read()
        assert "python" not in text and "torch" not in text

    def test_the_script_is_executable_and_ships_as_package_data(self):
        assert os.access(SCRIPT, os.X_OK)
        pyproject = (REPO / "pyproject.toml").read_text()
        assert '"spark/discovery/*.sh"' in pyproject


def _fake_pyspark(address):
    """A ``pyspark`` module whose task context holds one ``gpu`` address."""
    ctx = SimpleNamespace(resources=lambda: {"gpu": SimpleNamespace(addresses=[address])})
    return SimpleNamespace(TaskContext=SimpleNamespace(get=staticmethod(lambda: ctx)))


class TestResources:
    def test_explicit_ordinal_wins(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pyspark", _fake_pyspark("5"))
        assert resolve_device_ordinal(3) == 3

    def test_the_task_resource_comes_next(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pyspark", _fake_pyspark("5"))
        assert task_gpu_address() == "5"
        assert resolve_device_ordinal(-1) == 5

    def test_a_tpu_resource_is_not_a_gpu(self, monkeypatch):
        ctx = SimpleNamespace(resources=lambda: {"tpu": SimpleNamespace(addresses=["2"])})
        monkeypatch.setitem(sys.modules, "pyspark",
                            SimpleNamespace(TaskContext=SimpleNamespace(get=staticmethod(lambda: ctx))))
        assert task_gpu_address() is None
        assert resolve_device_ordinal(-1) == 0

    def test_defaults_to_zero_outside_spark(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pyspark", None)
        assert task_gpu_address() is None
        assert resolve_device_ordinal(-1) == 0

    def test_a_pinned_task_sees_its_card_at_index_zero(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pyspark", _fake_pyspark("1"))
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
        assert resolve_device_ordinal(-1) == 1  # the host card, which pinning names
        assert resolve_device_index(-1) == 0  # the index this process sees it at

    @pytest.mark.parametrize("visible, want", [("0,1,2,3", 2), ("3,2", 1), (None, 2), ("0,1", 2)])
    def test_the_task_card_is_its_position_in_the_visible_list(self, monkeypatch, visible, want):
        monkeypatch.setitem(sys.modules, "pyspark", _fake_pyspark("2"))
        if visible is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        assert resolve_device_index(-1) == want

    def test_an_explicit_gpu_id_is_already_a_visible_index(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pyspark", _fake_pyspark("5"))
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")
        assert resolve_device_index(0) == 0
        assert resolve_device_index(-1) == 0
        monkeypatch.setitem(sys.modules, "pyspark", None)
        assert resolve_device_index(-1) == 0

    def test_pin_sets_the_visible_card_unconditionally(self, monkeypatch):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
        pin_process_to_chip(2)
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "2"

    def test_pin_after_cuda_initialized_raises_naming_the_ordinal(self, monkeypatch):
        import torch

        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        with pytest.raises(RuntimeError, match="card 1"):
            pin_process_to_chip(1)
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1"


class TestAdapterGate:
    def test_import_error_without_pyspark(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pyspark", None)
        name = "spark_rapids_ml_tpu_torch.spark.adapter"
        was = sys.modules.pop(name, None)
        try:
            adapter = importlib.import_module(name)
            assert not adapter.HAS_PYSPARK
            with pytest.raises(ImportError, match="pyspark"):
                _ = adapter.TpuPCA
        finally:
            sys.modules.pop(name, None)
            if was is not None:
                sys.modules[name] = was


_BRINGUP = r"""
import json, os, sys, types
ctx = types.SimpleNamespace(resources=lambda: {"gpu": types.SimpleNamespace(addresses=["3"])})
sys.modules["pyspark"] = types.SimpleNamespace(TaskContext=types.SimpleNamespace(get=lambda: ctx))
import torch.distributed as dist
from spark_rapids_ml_tpu_torch import device
from spark_rapids_ml_tpu_torch.parallel import distributed as tdist
device.set_platform("cpu")
tdist.bringup_executor("127.0.0.1:" + sys.argv[1], 1, 0)
print(json.dumps({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "world": dist.get_world_size(),
                  "initialized": dist.is_initialized()}))
dist.destroy_process_group()
"""


def test_bringup_executor_pins_the_task_resources_card_and_joins():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    r = subprocess.run([sys.executable, "-c", _BRINGUP, str(port)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"visible": "3", "world": 1, "initialized": True}


class TestExecutorMath:
    """The port twin of the contract suite's class: the numpy-only
    executor forwards against the port's core models."""

    def test_logistic_forward_matches_core(self, rng, cpu_platform):
        from spark_rapids_ml_tpu_torch.classification import LogisticRegression

        x = rng.normal(size=(200, 4))
        y = (x[:, 0] - x[:, 2] > 0).astype(float)
        core = LogisticRegression().setMaxIter(40).fit((x, y))
        raw, probs, pred = tem.logistic_forward(
            np.asarray(core.weights, dtype=np.float64), np.asarray(core.intercepts, dtype=np.float64),
            core.getThreshold(), x)
        np.testing.assert_allclose(probs, core.predictProbability(x), atol=1e-6)
        np.testing.assert_allclose(raw, core.predictRaw(x), atol=1e-6)
        np.testing.assert_array_equal(pred, np.asarray(core.predict(x)).astype(float))
        np.testing.assert_allclose(raw[:, 0], -raw[:, 1], atol=1e-12)

    def test_forest_forward_matches_core(self, rng, cpu_platform):
        from spark_rapids_ml_tpu_torch.classification import RandomForestClassifier
        from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
        from spark_rapids_ml_tpu_torch.models.random_forest import _forest_depth

        x = rng.normal(size=(200, 5))
        y = ((x[:, 0] > 0) & (x[:, 1] > 0)).astype(float)
        core = RandomForestClassifier().setNumTrees(8).setMaxDepth(4).setSeed(3).fit((x, y))
        f = core._forest
        raw, probs, pred = tem.forest_forward(to_host(f.feature), to_host(f.threshold, np.float64),
                                              to_host(f.is_leaf), to_host(f.leaf_value, np.float64),
                                              _forest_depth(f), x)
        np.testing.assert_allclose(probs, core.predictProbability(x), atol=1e-6)
        np.testing.assert_allclose(raw, core.predictRaw(x), atol=1e-5)
        np.testing.assert_array_equal(pred, np.asarray(core.predict(x)).astype(float))

    def test_executor_math_imports_neither_jax_nor_torch(self):
        code = (
            "import sys; sys.path.insert(0, %r); "
            "sys.modules['jax'] = None; sys.modules['torch'] = None; "
            "import spark_rapids_ml_tpu_torch.spark.executor_math as m; "
            "import numpy as np; "
            "r, p, y = m.logistic_forward(np.ones((3, 1)), np.zeros(1), 0.5, np.ones((2, 3))); "
            "print('NO_JAX_NO_TORCH_OK', p.shape)"
        ) % str(REPO)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr[-1500:]
        assert "NO_JAX_NO_TORCH_OK" in out.stdout

    def test_the_port_module_has_the_references_functions(self):
        assert tem.__all__ == jem.__all__


def _forest_arrays(rng, T=4, depth=3, d=5, c=3):
    n_total = 2 ** (depth + 1) - 1
    feature = rng.integers(-1, d, size=(T, n_total)).astype(np.int32)
    threshold = rng.normal(size=(T, n_total)).astype(np.float32)
    is_leaf = feature < 0
    leaf_value = rng.random((T, n_total, c)).astype(np.float32)
    return feature, threshold, is_leaf, leaf_value


def _cases(rng):
    x = rng.normal(size=(64, 5))
    feature, threshold, is_leaf, leaf_value = _forest_arrays(rng)
    edges = np.sort(rng.normal(size=(5, 7)), axis=1)
    binned = np.stack([np.searchsorted(edges[f], x[:, f]) for f in range(5)], axis=1)
    idx = jem.forest_route(feature, threshold, x, 2)
    w = rng.poisson(1.0, size=(4, 64)).astype(np.float64)
    rs = rng.random((64, 3))
    queries, items = rng.normal(size=(9, 5)), rng.normal(size=(30, 5))
    a = jem.knn_shard_topk(queries, items[:12], 0, 4)
    b = jem.knn_shard_topk(queries, items[12:], 12, 4)
    return {
        "logistic_forward": (rng.normal(size=(5, 1)), rng.normal(size=1), 0.5, x),
        "logistic_forward/multinomial": (rng.normal(size=(5, 3)), rng.normal(size=3), 0.5, x),
        "forest_forward": (feature, threshold, is_leaf, leaf_value, 3, x),
        "forest_forward_reg": (feature, threshold, is_leaf, leaf_value[..., :1], 3, x),
        "forest_apply_leaves": (feature, threshold, is_leaf, 3, x),
        "logistic_loss_grad": (rng.normal(size=(5, 3)), rng.normal(size=3), x, rng.integers(0, 3, 64), False),
        "bin_columns": (x, edges),
        "forest_route": (feature, threshold, x, 3),
        "level_histogram_partial": (idx, w, binned, rs, 3, 4, 8),
        "node_totals_partial": (idx, w, rs, 3, 4),
        "draw_tree_weights": (np.random.default_rng(5), 4, 64, 0.8, True),
        "soft_threshold": (rng.normal(size=20), 0.3),
        "gram_matvec_partial": (x, rng.normal(size=5)),
        "knn_shard_topk": (queries, items, 7, 5, "cosine"),
        "knn_merge_candidates": (a, b, 4),
    }


@pytest.mark.parametrize("name", sorted(_cases(np.random.default_rng(0))))
def test_every_executor_function_is_bitwise_the_references(name):
    args_ours = _cases(np.random.default_rng(11))[name]
    args_theirs = _cases(np.random.default_rng(11))[name]
    fn = name.split("/")[0]
    ours, theirs = getattr(tem, fn)(*args_ours), getattr(jem, fn)(*args_theirs)
    flat_o = ours if isinstance(ours, tuple) else (ours,)
    flat_t = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(flat_o) == len(flat_t)
    for o, t in zip(flat_o, flat_t):
        o, t = np.asarray(o), np.asarray(t)
        assert o.dtype == t.dtype and o.shape == t.shape and o.tobytes() == t.tobytes(), name
