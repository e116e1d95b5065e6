"""The ``TPUML_CHECKPOINT_*`` knobs in the port.

The port segments and checkpoints a fit where the reference does, when
``TPUML_CHECKPOINT_DIR`` is set and ``TPUML_CHECKPOINT_EVERY`` is positive
(``robustness/checkpoint.py::FitCheckpointer.for_fit``): KMeans' Lloyd
(any backend but an explicit ``fused``, on one device or a mesh), the
linear FISTA (in memory or streamed), the logistic L-BFGS and, with
``TPUML_CHECKPOINT_UMAP=1`` as well, the single-device UMAP layout. Those
fits run segmented, write snapshots and equal the knobs-off fit bitwise;
every other fit, and every fit with the knobs unset or disabled, runs as
before and writes nothing. The knobs are registered with the reference's
kinds, defaults and choices. (The resume itself is held in
``tests/test_torch_checkpoint.py``.)
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.utils import envknobs as jax_knobs
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.manifold import UMAP
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.utils import envknobs
from spark_rapids_ml_tpu_torch.utils.tracing import clear_counters, counter_value

KNOBS = ("TPUML_CHECKPOINT_EVERY", "TPUML_CHECKPOINT_DIR", "TPUML_CHECKPOINT_KEEP", "TPUML_CHECKPOINT_UMAP")

_RNG = np.random.default_rng(55)
X = _RNG.normal(size=(120, 5)) + np.repeat(np.eye(3, 5) * 6.0, 40, axis=0)
Y_LIN = X @ _RNG.normal(size=5) + 0.1 * _RNG.normal(size=120)
Y_BIN = (X[:, 0] - X[:, 1] > 0.5).astype(np.float64)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    port_device.set_platform("cpu")
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    yield
    port_device.set_platform("cuda")


def _arm(monkeypatch, tmp_path, every="2", umap=None):
    monkeypatch.setenv("TPUML_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("TPUML_CHECKPOINT_EVERY", every)
    if umap is not None:
        monkeypatch.setenv("TPUML_CHECKPOINT_UMAP", umap)


def _kmeans():
    return KMeans().setK(3).setSeed(1).setMaxIter(10).fit(X).clusterCenters()


def _linear_fista():
    return LinearRegression().setRegParam(0.1).setElasticNetParam(0.5).fit((X, Y_LIN)).coefficients


def _linear_fista_streamed():
    blocks = [X[:60], X[60:]]
    return LinearRegression().setRegParam(0.1).setElasticNetParam(0.5).fit(
        (lambda: iter(blocks), Y_LIN)).coefficients


def _logistic_lbfgs():
    return LogisticRegression().setRegParam(0.01).setMaxIter(10).fit((X, Y_BIN)).weights


def _umap():
    return UMAP().setNNeighbors(5).setNEpochs(5).setSeed(0).fit(X).embedding


CHECKPOINTED = {
    "kmeans.lloyd": _kmeans,
    "linreg.fista": _linear_fista,
    "linreg.fista_streamed": _linear_fista_streamed,
    "logistic.lbfgs": _logistic_lbfgs,
    "umap.layout": _umap,
}


@pytest.mark.parametrize("name", KNOBS)
def test_the_checkpoint_knobs_are_the_reference_registry(name):
    ours, theirs = envknobs.KNOBS[name], jax_knobs.KNOBS[name]
    assert (ours.kind, ours.default, tuple(ours.choices)) == (theirs.kind, theirs.default, tuple(theirs.choices))


def _segmented(fit, monkeypatch, tmp_path, umap="1"):
    """``fit()`` with the knobs off, then with them on: the knobs-on fit's
    segment count and result. A completed fit leaves no snapshot."""
    want = fit()
    clear_counters("checkpoint")
    _arm(monkeypatch, tmp_path, every="1", umap=umap)
    got = fit()
    assert counter_value("checkpoint.completed") == 1 and not list(tmp_path.rglob("ckpt-*.npz"))
    return counter_value("checkpoint.segments"), got, want


@pytest.mark.parametrize("family", list(CHECKPOINTED))
def test_a_fit_the_reference_would_checkpoint_raises(family, monkeypatch, tmp_path):
    """Where the reference checkpoints a fit the port now does too: the
    same knobs drive a segmented fit equal to the knobs-off fit (the name
    is kept from when the port refused these fits)."""
    segments, got, want = _segmented(CHECKPOINTED[family], monkeypatch, tmp_path)
    assert segments >= 2 and counter_value("checkpoint.write") == segments
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", list(CHECKPOINTED))
def test_with_the_knobs_unset_or_disabled_a_fit_runs_as_before(family, monkeypatch, tmp_path):
    default = CHECKPOINTED[family]()
    for every, base in (("0", str(tmp_path)), ("3", "")):
        monkeypatch.setenv("TPUML_CHECKPOINT_EVERY", every)
        monkeypatch.setenv("TPUML_CHECKPOINT_DIR", base)
        monkeypatch.setenv("TPUML_CHECKPOINT_UMAP", "1")
        np.testing.assert_array_equal(CHECKPOINTED[family](), default)


def test_the_fits_the_reference_never_checkpoints_run(monkeypatch, tmp_path):
    clear_counters("checkpoint")
    _arm(monkeypatch, tmp_path)
    KMeans().setK(3).setSeed(1).setBackend("fused").fit(X.astype(np.float32))
    LinearRegression().setRegParam(0.1).fit((X, Y_LIN))  # the exact normal-equation solve
    LogisticRegression().setRegParam(0.01).setElasticNetParam(0.5).setMaxIter(5).fit((X, Y_BIN))
    UMAP().setNNeighbors(5).setNEpochs(3).fit(X)  # UMAP opts in with TPUML_CHECKPOINT_UMAP
    monkeypatch.setenv("TPUML_CHECKPOINT_UMAP", "1")
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    UMAP(mesh=mesh).setNNeighbors(5).setNEpochs(3).fit(X)  # the mesh layout never checkpoints
    assert counter_value("checkpoint.segments") == 0 and not list(tmp_path.rglob("ckpt-*.npz"))
    # A mesh Lloyd does checkpoint: segmented, equal to its knobs-off fit.
    monkeypatch.setenv("TPUML_CHECKPOINT_EVERY", "0")
    want = KMeans(mesh=mesh).setK(3).setSeed(1).fit(X).clusterCenters()
    monkeypatch.setenv("TPUML_CHECKPOINT_EVERY", "2")
    got = KMeans(mesh=mesh).setK(3).setSeed(1).fit(X).clusterCenters()
    assert counter_value("checkpoint.segments") >= 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,value", [("TPUML_CHECKPOINT_EVERY", "-1"), ("TPUML_CHECKPOINT_EVERY", "two"),
                                        ("TPUML_CHECKPOINT_KEEP", "0")])
def test_malformed_values_name_the_knob(name, value, monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path)
    monkeypatch.setenv(name, value)
    with pytest.raises(envknobs.EnvKnobError, match=name):
        _kmeans()
