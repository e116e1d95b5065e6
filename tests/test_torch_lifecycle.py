"""The continuous-training lifecycle in the port, held against the JAX
package's ``lifecycle/`` on the same numpy inputs, on the CPU.

Mirrors ``tests/test_lifecycle.py`` and adds the cross-package checks:

- **Zero state**: port ``partial_fit(data)`` with no previous model is
  bitwise the port's ``fit`` for KMeans, logistic and linear (elastic net).
- **Warm seeding**: from the same pinned centres or weights (a JAX model
  carried across by ``interop``) both packages run the same
  ``checkpoint.solver_iters``; KMeans centres (float64) and linear
  coefficients agree within 1e-10, logistic within 1e-8 with equal
  ``numIter``; a warm seed runs strictly fewer iterations than a cold one.
- **PCA merge**: split-and-merge moments equal single-shot within 1e-12;
  the port equals JAX ``partial_fit`` within 1e-10 (sign-invariant); the
  reference's errors hold word for word; moments carried across by
  ``interop.shifted_moments_from_numpy`` continue identically in both.
- **Device moments** (``ShiftedMoments.add_block`` on a tensor): the CPU
  tensor route equals the numpy route within 1e-12, through K1's wrapper
  (its plain version on the CPU) with ``mean`` = the shift, in float64.
- **Pickling**: every family's estimator and model round-trips through
  plain ``pickle`` and predicts bitwise (warm starts and PCA moments too).
- **The controller**: flips, warm second cycles, gate rejection, ``watch``
  rollback, transient faults at every site, fatal faults resumed with no
  duplicate version, and the directory requirement; outcomes and scores
  equal the JAX controller's (linear: scores within 1e-10; KMeans, whose
  port fit of host rows is float32, within 1e-5 relative).
- **Drift**: bootstrap, stable, fire, small window, rebaseline, tick
  faults; the PSI equals the JAX monitor's on the same windows.
- **Knobs**: the controller and the monitor read ``TPUML_LIFECYCLE_*`` and
  ``TPUML_DRIFT_*`` as the reference does.
"""

import json
import pickle
import threading

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.lifecycle import DriftMonitor as JaxDriftMonitor
from spark_rapids_ml_tpu.lifecycle import LifecycleController as JaxLifecycleController
from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.models.linear_regression import LinearRegressionModel as JaxLinearRegressionModel
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.robustness.faults import disarm as jax_disarm
from spark_rapids_ml_tpu.serving.server import ServingRuntime as JaxServingRuntime
from spark_rapids_ml_tpu.utils import tracing as jax_tracing
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.classification import (
    LogisticRegression,
    RandomForestClassifier,
)
from spark_rapids_ml_tpu_torch.clustering import DBSCAN, KMeans
from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.interop import (
    kmeans_model_from_numpy,
    linear_regression_model_from_numpy,
    logistic_regression_model_from_numpy,
    pca_model_from_numpy,
    shifted_moments_from_numpy,
)
from spark_rapids_ml_tpu_torch.lifecycle import DriftMonitor, LifecycleController
from spark_rapids_ml_tpu_torch.lifecycle.journal import CycleJournal
from spark_rapids_ml_tpu_torch.manifold import UMAP
from spark_rapids_ml_tpu_torch.neighbors import ApproximateNearestNeighbors, NearestNeighbors
from spark_rapids_ml_tpu_torch.observability import events
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1
from spark_rapids_ml_tpu_torch.pipeline import Pipeline
from spark_rapids_ml_tpu_torch.regression import LinearRegression, RandomForestRegressor
from spark_rapids_ml_tpu_torch.robustness import InjectedFault, inject
from spark_rapids_ml_tpu_torch.robustness.faults import disarm
from spark_rapids_ml_tpu_torch.serving.server import ServingRuntime
from spark_rapids_ml_tpu_torch.utils import tracing as port_tracing
from spark_rapids_ml_tpu_torch.utils.tracing import clear_counters, counter_value


@pytest.fixture(autouse=True)
def _cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    disarm()
    jax_disarm()


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for name in ("TPUML_LIFECYCLE_DIR", "TPUML_LIFECYCLE_HOLDOUT", "TPUML_LIFECYCLE_GATE_MARGIN",
                 "TPUML_LIFECYCLE_REGRESS_TOL", "TPUML_LIFECYCLE_EVERY", "TPUML_DRIFT_THRESHOLD",
                 "TPUML_DRIFT_MIN_COUNT", "TPUML_CHECKPOINT_DIR", "TPUML_CHECKPOINT_EVERY", "TPUML_FAULTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUML_RETRY_BASE_DELAY", "0")


@pytest.fixture
def clusters(rng):
    x = rng.normal(size=(240, 6))
    x[:120] += 4.0
    return x


@pytest.fixture
def labeled(rng):
    x = rng.normal(size=(240, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0.2).astype(float)
    return x, y


@pytest.fixture
def regression(rng):
    x = rng.normal(size=(200, 6))
    y = x @ rng.normal(size=6) + 0.1 * rng.normal(size=200)
    return x, y


def _km_score(model, x, y):
    centers = np.asarray(model.clusterCenters())
    d = np.linalg.norm(x[:, None, :] - centers[None], axis=2).min(axis=1)
    return -float(d.mean())


def _mse_score(model, x, y):
    pred = np.asarray(model.predict(x), dtype=np.float64)
    return -float(np.mean((pred - y) ** 2))


def _runtime():
    return ServingRuntime(start=False)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture
def event_log(tmp_path):
    path = tmp_path / "events.jsonl"
    events.configure(str(path))
    try:
        yield path
    finally:
        events.configure(None)


# --- zero state: partial_fit(model=None) is the port's fit, bitwise ------------


class TestZeroStateBitIdentity:
    def test_kmeans(self, clusters):
        cold = KMeans(uid="zs-km").setK(3).setSeed(7).fit(clusters)
        pf = KMeans(uid="zs-km").setK(3).setSeed(7).partial_fit(clusters)
        assert np.array_equal(cold.clusterCenters(), pf.clusterCenters())
        assert cold.trainingCost == pf.trainingCost and cold.numIter == pf.numIter

    def test_kmeans_float64_tensor(self, clusters):
        x = torch.from_numpy(clusters)
        cold = KMeans(uid="zs-km64").setK(3).setSeed(7).fit(x)
        pf = KMeans(uid="zs-km64").setK(3).setSeed(7).partial_fit(x)
        assert np.array_equal(cold.clusterCenters(), pf.clusterCenters())

    def test_logistic(self, labeled):
        cold = LogisticRegression(uid="zs-lr").setMaxIter(50).fit(labeled)
        pf = LogisticRegression(uid="zs-lr").setMaxIter(50).partial_fit(labeled)
        assert np.array_equal(cold.coefficients, pf.coefficients)
        assert np.array_equal(cold.intercepts, pf.intercepts)
        assert cold.numIter == pf.numIter

    def test_linear(self, regression):
        def est():
            return LinearRegression(uid="zs-ln").setRegParam(0.05).setElasticNetParam(0.5)

        cold = est().fit(regression)
        pf = est().partial_fit(regression)
        assert np.array_equal(cold.coefficients, pf.coefficients)
        assert cold.intercept == pf.intercept

    def test_estimator_is_not_mutated(self, clusters):
        est = KMeans(uid="zs-nm").setK(3).setSeed(7)
        prev = est.partial_fit(clusters)
        est.partial_fit(clusters, model=prev)
        assert est._initial_centers is None and not hasattr(est, "_force_segment_every")

    @pytest.mark.parametrize("family", ["forest", "dbscan", "umap"])
    def test_unsupported_family_raises_the_reference_error(self, clusters, family):
        from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRF
        from spark_rapids_ml_tpu.clustering import DBSCAN as JaxDBSCAN
        from spark_rapids_ml_tpu.manifold import UMAP as JaxUMAP

        ours, theirs = {"forest": (RandomForestClassifier, JaxRF), "dbscan": (DBSCAN, JaxDBSCAN),
                        "umap": (UMAP, JaxUMAP)}[family]
        with pytest.raises(TypeError, match="partial_fit supports") as got:
            ours().partial_fit(clusters)
        with pytest.raises(TypeError) as want:
            theirs().partial_fit(clusters)
        assert str(got.value) == str(want.value)


# --- warm seeding: the same iterations as the reference, fewer than cold ------


def _solver_iters(fn, module):
    before = module.counter_value("checkpoint.solver_iters")
    out = fn()
    return out, module.counter_value("checkpoint.solver_iters") - before


class TestWarmSeedAgainstReference:
    def test_kmeans(self, clusters):
        start = JaxKMeans(uid="ws-km-j").setK(3).setSeed(7).setMaxIter(2).fit(clusters)
        c0 = np.asarray(start.clusterCenters())
        jax_prev, port_prev = JaxKMeansModel("prev", c0), kmeans_model_from_numpy(c0, uid="prev")
        want, want_iters = _solver_iters(
            lambda: JaxKMeans(uid="ws-km").setK(3).setSeed(7).setMaxIter(40).setTol(1e-8)
            .partial_fit(clusters, model=jax_prev), jax_tracing)
        got, got_iters = _solver_iters(
            lambda: KMeans(uid="ws-km").setK(3).setSeed(7).setMaxIter(40).setTol(1e-8)
            .partial_fit(torch.from_numpy(clusters), model=port_prev), port_tracing)
        assert got_iters == want_iters > 0
        np.testing.assert_allclose(got.clusterCenters(), np.asarray(want.clusterCenters()), rtol=0, atol=1e-10)
        assert got.numIter == want.numIter

    def test_linear(self, regression):
        x, y = regression

        def jest():
            return JaxLinearRegression(uid="ws-ln").setRegParam(0.02).setElasticNetParam(0.5)

        coef0 = np.linalg.lstsq(x, y, rcond=None)[0] + 0.3
        start = JaxLinearRegressionModel("prev", coef0, 0.1)
        port_prev = linear_regression_model_from_numpy(coef0, 0.1, uid="prev")
        want, want_iters = _solver_iters(lambda: jest().partial_fit((x, y), model=start), jax_tracing)
        got, got_iters = _solver_iters(
            lambda: LinearRegression(uid="ws-ln").setRegParam(0.02).setElasticNetParam(0.5)
            .partial_fit((x, y), model=port_prev), port_tracing)
        assert got_iters == want_iters > 0
        np.testing.assert_allclose(got.coefficients, np.asarray(want.coefficients), rtol=0, atol=1e-10)
        assert abs(got.intercept - float(want.intercept)) <= 1e-10

    def test_logistic(self, labeled):
        start = JaxLogisticRegression(uid="ws-lr").setMaxIter(3).fit(labeled)
        port_prev = logistic_regression_model_from_numpy(start.weights, start.intercepts, 2, uid="prev")
        want, want_iters = _solver_iters(
            lambda: JaxLogisticRegression(uid="ws-lr").setMaxIter(80).partial_fit(labeled, model=start),
            jax_tracing)
        got, got_iters = _solver_iters(
            lambda: LogisticRegression(uid="ws-lr").setMaxIter(80).partial_fit(labeled, model=port_prev),
            port_tracing)
        assert got_iters == want_iters > 0
        assert got.numIter == want.numIter
        np.testing.assert_allclose(got.weights, np.asarray(want.weights), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got.intercepts, np.asarray(want.intercepts), rtol=0, atol=1e-8)

    def test_segment_length_knob(self, clusters, monkeypatch):
        """``TPUML_LIFECYCLE_EVERY`` sets the forced segment length: the
        fit is the same, the segments are counted in both packages alike."""
        monkeypatch.setenv("TPUML_LIFECYCLE_EVERY", "2")
        c0 = clusters[[0, 130, 200]]
        segs = []
        for module, est, prev in (
            (jax_tracing, JaxKMeans(uid="ev").setK(3).setMaxIter(40), JaxKMeansModel("p", c0)),
            (port_tracing, KMeans(uid="ev").setK(3).setMaxIter(40), kmeans_model_from_numpy(c0)),
        ):
            data = clusters if module is jax_tracing else torch.from_numpy(clusters)
            _, n = _solver_iters(lambda: est.partial_fit(data, model=prev), module)
            before = module.counter_value("checkpoint.segments")
            est.partial_fit(data, model=prev)
            segs.append((n, module.counter_value("checkpoint.segments") - before))
        assert segs[0] == segs[1] and segs[1][1] == -(-segs[1][0] // 2)


class TestWarmSeedIterations:
    def test_kmeans_warm_fewer_iters(self, clusters):
        est = KMeans(uid="ws-km").setK(3).setSeed(7).setMaxIter(40)
        prev = est.partial_fit(clusters)
        _, cold = _solver_iters(lambda: est.partial_fit(clusters), port_tracing)
        _, warm = _solver_iters(lambda: est.partial_fit(clusters, model=prev), port_tracing)
        assert 0 < warm < cold

    def test_logistic_warm_fewer_iters(self, labeled):
        est = LogisticRegression(uid="ws-lr").setMaxIter(80)
        prev = est.partial_fit(labeled)
        _, cold = _solver_iters(lambda: est.partial_fit(labeled), port_tracing)
        _, warm = _solver_iters(lambda: est.partial_fit(labeled, model=prev), port_tracing)
        assert 0 < warm < cold

    def test_linear_warm_fewer_iters(self, rng):
        x = rng.normal(size=(200, 6))
        y = x @ rng.normal(size=6) + 0.05 * rng.normal(size=200)
        est = LinearRegression(uid="ws-ln").setRegParam(0.02).setElasticNetParam(0.5)
        prev = est.partial_fit((x, y))
        _, cold = _solver_iters(lambda: est.partial_fit((x, y)), port_tracing)
        _, warm = _solver_iters(lambda: est.partial_fit((x, y), model=prev), port_tracing)
        assert 0 < warm < cold

    def test_warm_result_matches_cold_solution(self, clusters):
        est = KMeans(uid="ws-eq").setK(3).setSeed(7).setMaxIter(100)
        prev = est.partial_fit(clusters)
        cold = est.partial_fit(clusters)
        warm = est.partial_fit(clusters, model=prev)
        np.testing.assert_allclose(np.sort(warm.clusterCenters(), axis=0),
                                   np.sort(cold.clusterCenters(), axis=0), atol=1e-5)


# --- PCA: exact streaming-moment accumulation ----------------------------------


def _aligned(a, b):
    """``a`` with each column's sign matched to ``b``'s."""
    return a * np.where(np.sum(a * b, axis=0) < 0, -1.0, 1.0)[None, :]


def _moments_close(a, b, rtol=1e-12):
    assert a.n_rows == b.n_rows and a.n_cols == b.n_cols
    ca, ma = a.finalize()
    cb, mb = b.finalize()
    scale = np.abs(cb).max()
    assert np.abs(ca - cb).max() <= rtol * scale
    assert np.abs(ma - mb).max() <= rtol * max(np.abs(mb).max(), 1.0)


class TestPCAStreamingMerge:
    def test_split_merge_matches_single_shot(self, rng):
        x = rng.normal(size=(300, 8))
        x[:150] += 2.0
        est = PCA(uid="sm-pca").setK(3)
        m1 = est.partial_fit(x[:100])
        m2 = est.partial_fit(x[100:], model=m1)
        one = est.partial_fit(x)
        _moments_close(m2._moments, one._moments)
        np.testing.assert_allclose(m2.pc, one.pc, atol=1e-9)
        np.testing.assert_allclose(m2.explainedVariance, one.explainedVariance, atol=1e-12)
        assert m2._moments.n_rows == 300

    def test_matches_reference_partial_fit(self, rng):
        x = rng.normal(size=(300, 8)) * np.linspace(0.5, 3.0, 8)
        splits = (0, 90, 210, 300)
        ours = theirs = None
        est, jest = PCA(uid="rf-pca").setK(4), JaxPCA(uid="rf-pca").setK(4)
        for a, b in zip(splits, splits[1:]):
            ours = est.partial_fit(x[a:b], model=ours)
            theirs = jest.partial_fit(x[a:b], model=theirs)
        np.testing.assert_allclose(_aligned(ours.pc, np.asarray(theirs.pc)), np.asarray(theirs.pc),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(ours.explainedVariance, np.asarray(theirs.explainedVariance),
                                   rtol=0, atol=1e-10)
        for field in ("shift", "sum", "gram"):
            assert np.array_equal(getattr(ours._moments, field), getattr(theirs._moments, field)), field

    def test_uncentered_matches_reference(self, rng):
        x = rng.normal(size=(120, 5)) + 3.0
        ours = PCA(uid="uc").setK(2).setMeanCentering(False).partial_fit(x)
        theirs = JaxPCA(uid="uc").setK(2).setMeanCentering(False).partial_fit(x)
        np.testing.assert_allclose(_aligned(ours.pc, np.asarray(theirs.pc)), np.asarray(theirs.pc), atol=1e-10)

    def test_streams_and_tensors_fold_like_rows(self, rng):
        x = rng.normal(size=(200, 6))
        est = PCA(uid="st").setK(2)
        one = est.partial_fit(x)
        blocks = [x[:70], x[70:70], x[70:]]
        for source in (lambda: iter(blocks), lambda: iter([torch.from_numpy(b) for b in blocks]),
                       torch.from_numpy(x)):
            got = est.partial_fit(source)
            _moments_close(got._moments, one._moments)
            np.testing.assert_allclose(_aligned(got.pc, one.pc), one.pc, atol=1e-10)

    def test_parity_with_fit(self, rng):
        x = rng.normal(size=(300, 8))
        est = PCA(uid="pp-pca").setK(3)
        m1 = est.partial_fit(x[:130])
        m2 = est.partial_fit(x[130:], model=m1)
        full = est.fit(x)
        np.testing.assert_allclose(np.abs(m2.pc), np.abs(full.pc), atol=1e-4)
        np.testing.assert_allclose(m2.explainedVariance, full.explainedVariance, atol=1e-6)

    def test_previous_model_not_mutated(self, rng):
        x = rng.normal(size=(120, 5))
        est = PCA(uid="im-pca").setK(2)
        m1 = est.partial_fit(x[:60])
        before = pickle.dumps(m1._moments)
        est.partial_fit(x[60:], model=m1)
        assert pickle.dumps(m1._moments) == before

    @pytest.mark.parametrize("case", ["plain_fit_model", "width_change", "empty_batch", "empty_stream",
                                      "bad_k"])
    def test_errors_match_the_reference(self, rng, case):
        x = rng.normal(size=(60, 5))
        results = []
        for est_cls in (PCA, JaxPCA):
            est = est_cls(uid="er").setK(2)
            if case == "plain_fit_model":
                call = lambda: est.partial_fit(x, model=est.fit(x))  # noqa: E731
            elif case == "width_change":
                prev = est.partial_fit(x)
                call = lambda: est.partial_fit(rng.normal(size=(60, 7)), model=prev)  # noqa: E731
            elif case == "empty_batch":
                call = lambda: est.partial_fit(np.zeros((0, 5)))  # noqa: E731
            elif case == "empty_stream":
                call = lambda: est.partial_fit(lambda: iter([np.zeros((0, 5))]))  # noqa: E731
            else:
                call = lambda: est_cls(uid="er").setK(9).partial_fit(x)  # noqa: E731
            with pytest.raises(ValueError) as err:
                call()
            results.append(str(err.value))
        assert results[0] == results[1]

    def test_moments_carried_from_the_reference_continue_identically(self, rng):
        """A PCA refit started in the JAX package continues in the port."""
        x = rng.normal(size=(240, 6)) * np.arange(1.0, 7.0)
        jest = JaxPCA(uid="carry").setK(3)
        first = jest.partial_fit(x[:100])
        m = first._moments
        carried = pca_model_from_numpy(
            first.pc, first.explainedVariance, uid=first.uid,
            moments=shifted_moments_from_numpy(m.n_rows, m.shift, m.sum, m.gram))
        theirs = jest.partial_fit(x[100:], model=first)
        ours = PCA(uid="carry").setK(3).partial_fit(x[100:], model=carried)
        for field in ("shift", "sum", "gram"):
            assert np.array_equal(getattr(ours._moments, field), getattr(theirs._moments, field)), field
        assert ours._moments.n_rows == theirs._moments.n_rows == 240
        np.testing.assert_allclose(_aligned(ours.pc, np.asarray(theirs.pc)), np.asarray(theirs.pc), atol=1e-12)
        assert carried._moments.n_rows == 100  # the carried model stays a rollback target

    def test_interop_refuses_a_mismatched_width(self, rng):
        x = rng.normal(size=(20, 4))
        mom = ShiftedMoments(5).add_block(rng.normal(size=(10, 5)))
        with pytest.raises(ValueError, match="columns"):
            pca_model_from_numpy(x[:, :2], np.ones(2), moments=mom)


# --- the device route of ShiftedMoments.add_block (CPU tensors here) -----------


class TestTensorMoments:
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_tensor_route_equals_numpy_route(self, rng, dtype):
        x = rng.normal(size=(1000, 12)) * np.linspace(0.1, 5.0, 12) + 7.0
        blocks = (x[:1], x[1:400], x[400:400], x[400:])
        host, dev = ShiftedMoments(12), ShiftedMoments(12)
        for b in blocks:
            t = torch.from_numpy(b).to(dtype)
            host.add_block(t.numpy().astype(np.float64))
            dev.add_block(t)
        assert dev.n_rows == host.n_rows == 1000
        assert np.array_equal(dev.shift, host.shift)  # the first row, exactly, in float64
        np.testing.assert_allclose(dev.sum, host.sum, rtol=1e-12, atol=1e-12 * np.abs(host.sum).max())
        np.testing.assert_allclose(dev.gram, host.gram, rtol=0, atol=1e-12 * np.abs(host.gram).max())
        assert isinstance(dev.gram, np.ndarray) and dev.gram.dtype == np.float64
        assert pickle.loads(pickle.dumps(dev)).gram.tobytes() == dev.gram.tobytes()

    def test_tensor_route_goes_through_k1_in_float64(self, rng, monkeypatch):
        calls = []
        real = k1.centered_gram_cuda

        def spy(x, mean):
            calls.append((x.dtype, tuple(x.shape), mean.clone()))
            return real(x, mean)

        monkeypatch.setattr(k1, "centered_gram_cuda", spy)
        x = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32))
        mom = ShiftedMoments(4).add_block(x[:20]).add_block(x[20:])
        assert [(c[0], c[1]) for c in calls] == [(torch.float64, (20, 4)), (torch.float64, (30, 4))]
        for _, _, mean in calls:
            assert np.array_equal(mean.numpy(), mom.shift)
        ShiftedMoments(4).add_block(x.numpy())
        assert len(calls) == 2  # host rows keep the numpy route

    def test_tensor_block_errors(self):
        mom = ShiftedMoments(3)
        with pytest.raises(ValueError, match=r"block must be \(rows, 3\), got \(4, 2\)"):
            mom.add_block(torch.zeros(4, 2))
        assert mom.add_block(torch.zeros(0, 3)).n_rows == 0 and mom.shift is None

    def test_a_non_cpu_tensor_has_no_host_fallback(self):
        """A tensor off the CPU never folds through the numpy route: one K1
        cannot take raises (here a meta tensor; on the card a CUDA block
        with no K1 build), and the moments are left as they were."""
        mom = ShiftedMoments(3)
        with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
            mom.add_block(torch.zeros(4, 3, device="meta"))
        assert mom.n_rows == 0 and mom.shift is None and not mom.gram.any()

    def test_pca_partial_fit_of_a_tensor_matches_the_reference(self, rng):
        x = rng.normal(size=(300, 7)) * np.linspace(1.0, 4.0, 7)
        ours = PCA(uid="tp").setK(3).partial_fit(torch.from_numpy(x))
        theirs = JaxPCA(uid="tp").setK(3).partial_fit(x)
        np.testing.assert_allclose(_aligned(ours.pc, np.asarray(theirs.pc)), np.asarray(theirs.pc), atol=1e-10)
        np.testing.assert_allclose(ours.explainedVariance, np.asarray(theirs.explainedVariance), atol=1e-10)


# --- plain pickle round trips (no cloudpickle on the codec path) ---------------


def _pickle_cases(rng):
    x = rng.normal(size=(120, 4))
    y = (x[:, 0] > 0).astype(float)
    x32 = x.astype(np.float32)
    return {
        "kmeans": (KMeans().setK(3).setSeed(1), x, lambda m: m.predict(x)),
        "kmeans_warm": (KMeans().setK(3).setInitialModel(x[:3]), x, lambda m: m.clusterCenters()),
        "pca": (PCA().setK(2), x, lambda m: m.transform(x)),
        "linear": (LinearRegression().setRegParam(0.1), (x, x @ np.arange(4.0)), lambda m: m.predict(x)),
        "logistic": (LogisticRegression().setMaxIter(10), (x, y), lambda m: m.predictProbability(x)),
        "forest_classifier": (RandomForestClassifier().setNumTrees(3).setMaxDepth(3).setSeed(0), (x, y),
                              lambda m: m.predictProbability(x)),
        "forest_regressor": (RandomForestRegressor().setNumTrees(3).setMaxDepth(3).setSeed(0), (x, y),
                             lambda m: m.predict(x)),
        "dbscan": (DBSCAN().setEps(0.8).setMinSamples(3), x, lambda m: m.transform(x)),
        "umap": (UMAP().setNNeighbors(5).setNEpochs(10).setSeed(0), x32, lambda m: m.transform(x32)),
        "nearest_neighbors": (NearestNeighbors().setK(3), x, lambda m: m.kneighbors(x)),
        "ann": (ApproximateNearestNeighbors().setK(3).setAlgorithm("brute"), x, lambda m: m.kneighbors(x)),
        "pipeline": (Pipeline(stages=[PCA().setK(2), LogisticRegression().setMaxIter(5)]), (x, y),
                     lambda m: m.transform(x)),
    }


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _param_names(p):
    return {q.name: v for q, v in p.extractParamMap().items()}


@pytest.mark.parametrize("family", ["kmeans", "kmeans_warm", "pca", "linear", "logistic", "forest_classifier",
                                    "forest_regressor", "dbscan", "umap", "nearest_neighbors", "ann",
                                    "pipeline"])
def test_plain_pickle_round_trips_predict_bitwise(rng, family):
    est, data, predict = _pickle_cases(rng)[family]
    est2 = pickle.loads(pickle.dumps(est))
    assert est2.uid == est.uid and _param_names(est2) == _param_names(est)
    model = est.fit(data)
    model2 = pickle.loads(pickle.dumps(model))
    assert type(model2) is type(model) and model2.uid == model.uid
    assert _param_names(model2) == _param_names(model)
    assert _same(predict(model), predict(model2))
    # the unpickled estimator fits the same model, and its params still set
    assert _same(predict(est2.fit(data)), predict(model))


def test_pickled_params_are_bound_to_their_instance(rng):
    est = pickle.loads(pickle.dumps(KMeans(uid="bound").setK(4).setMaxIter(7)))
    assert est.k is est.getParam("k") and est.k.parent == "bound"
    assert est.getK() == 4 and est.getMaxIter() == 7 and est.isSet(est.k) and not est.isSet(est.tol)
    with pytest.raises(TypeError):
        est.setK("four")  # the type converters are bound again
    copied = est.copy()
    assert copied.getK() == 4 and copied.uid != est.uid


def test_pickle_carries_warm_starts_and_moments(rng):
    x = rng.normal(size=(90, 3))
    prev = LogisticRegression().setMaxIter(3).fit((x, (x[:, 0] > 0).astype(float)))
    est = pickle.loads(pickle.dumps(LogisticRegression().setMaxIter(5).setInitialModel(prev)))
    assert [a.tobytes() for a in est._initial_weights] == [np.asarray(prev.weights).tobytes(),
                                                          np.asarray(prev.intercepts).tobytes()]
    lin = pickle.loads(pickle.dumps(LinearRegression().setElasticNetParam(0.5).setInitialModel(np.ones(3))))
    assert lin._initial_coef.tobytes() == np.ones(3).tobytes()
    pca = PCA(uid="mom").setK(2).partial_fit(x)
    back = pickle.loads(pickle.dumps(pca))
    for field in ("shift", "sum", "gram"):
        assert getattr(back._moments, field).tobytes() == getattr(pca._moments, field).tobytes()
    nxt = PCA(uid="mom").setK(2).partial_fit(x[:30], model=back)
    want = PCA(uid="mom").setK(2).partial_fit(x[:30], model=pca)
    assert nxt.pc.tobytes() == want.pc.tobytes()


def test_kmeans_model_getstate_still_materializes(rng):
    """The family's own ``__getstate__`` (lazy cost and iterations) runs
    under the by-value pickling."""
    x = torch.from_numpy(rng.normal(size=(60, 3)))
    m = KMeans().setK(2).setSeed(0).fit(x)
    state = m.__getstate__()
    assert isinstance(state["_cost_raw"], float) and isinstance(state["_iter_raw"], int)
    assert isinstance(state["_centers_raw"], np.ndarray)
    assert set(state["_paramMap"]) <= set(m._params) and "_params" not in state


# --- the controller -------------------------------------------------------------


#: (spec, the stages journaled when it kills the cycle). A count ``N``
#: fails the first N hits of a site, so the reference's
#: ``refit.ingest=2:fatal`` and ``refit.swap=2:fatal`` / ``=3:fatal``
#: (``tests/test_lifecycle.py``) kill at the site's first hit, the ingest
#: and the register; ``N@K`` reaches the refit, the warm and the flip.
FATAL_SPECS = [
    ("refit.ingest=1:fatal", []),
    ("refit.ingest=1@1:fatal", ["ingest"]),
    ("refit.quality_gate=1:fatal", ["ingest", "refit"]),
    ("refit.swap=1:fatal", ["ingest", "refit", "quality_gate"]),
    ("refit.swap=1@1:fatal", ["ingest", "refit", "quality_gate", "register"]),
    ("refit.swap=1@2:fatal", ["ingest", "refit", "quality_gate", "register", "warm"]),
    ("refit.ingest=2:fatal", []),
    ("refit.swap=2:fatal", ["ingest", "refit", "quality_gate"]),
    ("refit.swap=3:fatal", ["ingest", "refit", "quality_gate"]),
]


def _controller(est, tmp_path, rt=None, **kw):
    return LifecycleController(est, rt or _runtime(), "km", score_fn=_km_score, directory=str(tmp_path), **kw)


class TestController:
    def test_first_cycle_registers_and_flips(self, clusters, tmp_path):
        ctrl = _controller(KMeans(uid="ct-km").setK(2).setSeed(3), tmp_path)
        out = ctrl.run_cycle(clusters)
        assert out.action == "flipped" and out.version == 1 and out.cycle == 0
        assert ctrl.runtime.registry.aliases("km") == {"prod": 1}
        assert (tmp_path / "incumbent.pkl").exists() and (tmp_path / "last_flip.json").exists()

    def test_second_cycle_warm_seeds_and_flips(self, clusters, tmp_path):
        ctrl = _controller(KMeans(uid="ct2-km").setK(2).setSeed(3), tmp_path)
        first = ctrl.run_cycle(clusters)
        warm_before = counter_value("checkpoint.solver_iters")
        out = ctrl.run_cycle(clusters + 2.0)
        assert counter_value("checkpoint.solver_iters") > warm_before
        assert out.action == "flipped" and out.version == 2 and out.cycle == 1
        assert out.incumbent_score is not None and out.incumbent_score < out.candidate_score
        assert first.incumbent_score is None
        assert ctrl.runtime.registry.aliases("km") == {"prod": 2}
        assert (tmp_path / "incumbent_prev.pkl").exists()

    def test_incumbent_survives_a_restart(self, clusters, tmp_path):
        ctrl = _controller(KMeans(uid="rs-km").setK(2).setSeed(3), tmp_path)
        ctrl.run_cycle(clusters)
        again = _controller(KMeans(uid="rs-km").setK(2).setSeed(3), tmp_path)
        assert again.model.clusterCenters().tobytes() == ctrl.model.clusterCenters().tobytes()

    def test_gate_rejection_keeps_incumbent(self, clusters, tmp_path, event_log):
        ctrl = _controller(KMeans(uid="gr-km").setK(2).setSeed(3), tmp_path)
        ctrl.run_cycle(clusters)
        ctrl.gate_margin = 1e9
        clear_counters("lifecycle")
        out = ctrl.run_cycle(clusters)
        assert out.action == "rejected" and out.version is None
        assert ctrl.runtime.registry.aliases("km") == {"prod": 1}
        assert ctrl.runtime.registry.versions("km") == [1]
        assert counter_value("lifecycle.gate.rejected") == 1
        recs = _events(event_log)
        assert any(r["event"] == "lifecycle" and r["action"] == "gate_reject" for r in recs)
        assert all(events.SCHEMA[r["event"]] <= set(r) for r in recs if r["event"] in events.SCHEMA)

    def test_watch_triggers_auto_rollback(self, clusters, tmp_path, event_log):
        ctrl = _controller(KMeans(uid="ar-km").setK(2).setSeed(3), tmp_path, regress_tol=0.1)
        first = ctrl.run_cycle(clusters)
        v1_centers = ctrl.model.clusterCenters()
        out = ctrl.run_cycle(clusters + 2.0)
        assert out.version == 2
        assert ctrl.watch(out.candidate_score) is None
        clear_counters("lifecycle")
        assert ctrl.watch(out.candidate_score - 10.0) == 1
        assert ctrl.runtime.registry.aliases("km") == {"prod": 1}
        assert ctrl.model.clusterCenters().tobytes() == v1_centers.tobytes()
        assert counter_value("lifecycle.auto_rollback") == 1
        assert ctrl.watch(-1e9) is None  # one rollback per flip
        assert first.version == 1
        recs = _events(event_log)
        assert any(r["event"] == "lifecycle" and r["action"] == "auto_rollback" for r in recs)
        assert any(r["event"] == "registry_rollback" for r in recs)

    def test_transient_faults_at_every_site_retry_through(self, clusters, tmp_path):
        ctrl = _controller(KMeans(uid="tf-km").setK(2).setSeed(3), tmp_path)
        clear_counters("retry")
        with inject("refit.ingest=1;refit.quality_gate=1;refit.swap=1") as plan:
            out = ctrl.run_cycle(clusters)
        assert out.action == "flipped" and out.version == 1
        assert sorted(site for site, _ in plan.fired) == ["refit.ingest", "refit.quality_gate", "refit.swap"]
        for site in ("refit.ingest", "refit.quality_gate", "refit.swap"):
            assert counter_value(f"retry.{site}.attempts") >= 2, site

    @pytest.mark.parametrize("spec,journaled", FATAL_SPECS)
    def test_fatal_fault_then_resume_same_cycle_no_duplicates(self, clusters, tmp_path, spec, journaled):
        rt = _runtime()
        est = KMeans(uid="ff-km").setK(2).setSeed(3)
        ctrl = _controller(est, tmp_path, rt)
        with inject(spec):
            with pytest.raises(InjectedFault):
                ctrl.run_cycle(clusters)
        stages = json.loads((tmp_path / "cycle.json").read_text())["stages"] if journaled else {}
        assert sorted(stages) == sorted(journaled)
        clear_counters("lifecycle")
        out = _controller(est, tmp_path, rt).run_cycle(clusters)
        assert out.action == "flipped" and out.cycle == 0
        assert rt.registry.versions("km") == [1]
        assert rt.registry.aliases("km") == {"prod": 1}
        assert counter_value("lifecycle.journal.resumed") == (1 if journaled else 0)
        # the fenced register re-enters through the registry, not a replay
        assert counter_value("lifecycle.stage.replayed") == len(set(journaled) - {"register"})

    def test_requires_directory(self, clusters):
        with pytest.raises(ValueError, match="TPUML_LIFECYCLE_DIR") as got:
            LifecycleController(KMeans().setK(2), _runtime(), "km", score_fn=_km_score)
        with pytest.raises(ValueError) as want:
            JaxLifecycleController(JaxKMeans().setK(2), JaxServingRuntime(start=False), "km", score_fn=_km_score)
        assert str(got.value) == str(want.value)

    def test_directory_from_the_knob(self, clusters, tmp_path, monkeypatch):
        monkeypatch.setenv("TPUML_LIFECYCLE_DIR", str(tmp_path / "life"))
        ctrl = LifecycleController(KMeans(uid="kd").setK(2).setSeed(3), _runtime(), "km", score_fn=_km_score)
        assert ctrl.run_cycle(clusters).action == "flipped"
        assert (tmp_path / "life" / "cycle.json").exists()

    @pytest.mark.parametrize("bad", [(np.zeros((1, 3)), "n>=2"), (np.zeros(4), "n>=2")])
    def test_bad_batches_raise_the_reference_error(self, tmp_path, bad):
        x, _ = bad
        msgs = []
        for ctrl_cls, est, rt, sub in ((LifecycleController, KMeans().setK(2), _runtime(), "p"),
                                       (JaxLifecycleController, JaxKMeans().setK(2), JaxServingRuntime(start=False),
                                        "j")):
            ctrl = ctrl_cls(est, rt, "km", score_fn=_km_score, directory=str(tmp_path / sub))
            with pytest.raises(ValueError) as err:
                ctrl.run_cycle(x)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

    def test_tensor_batches_ingest_as_host_float64(self, clusters, tmp_path):
        ctrl = _controller(KMeans(uid="tb").setK(2).setSeed(3), tmp_path)
        out = ctrl.run_cycle(torch.from_numpy(clusters).float())
        data = np.load(tmp_path / "cycle_0_data.npz")
        assert out.action == "flipped" and data["x_train"].dtype == np.float64
        assert data["x_train"].shape[0] + data["x_hold"].shape[0] == clusters.shape[0]


class TestControllerAgainstReference:
    def _pair(self, tmp_path, make_port, make_jax, score_fn, model=None, jax_model=None, **kw):
        port = LifecycleController(make_port(), _runtime(), "m", score_fn=score_fn,
                                   directory=str(tmp_path / "port"), model=model, **kw)
        ref = JaxLifecycleController(make_jax(), JaxServingRuntime(start=False), "m", score_fn=score_fn,
                                     directory=str(tmp_path / "jax"), model=jax_model, **kw)
        return port, ref

    def test_linear_outcomes_and_scores(self, tmp_path, regression):
        x, y = regression
        coef0 = np.linalg.lstsq(x, y, rcond=None)[0] * 0.5
        start = JaxLinearRegressionModel("inc", coef0, 0.2)
        carried = linear_regression_model_from_numpy(coef0, 0.2, uid="inc")
        port, ref = self._pair(
            tmp_path, lambda: LinearRegression(uid="cl").setRegParam(0.02).setElasticNetParam(0.5),
            lambda: JaxLinearRegression(uid="cl").setRegParam(0.02).setElasticNetParam(0.5),
            _mse_score, model=carried, jax_model=start)
        rng = np.random.default_rng(5)
        for batch in ((x, y), (x + 0.5, y + rng.normal(size=y.shape)), (x, y)):
            a, b = port.run_cycle(*batch), ref.run_cycle(*batch)
            assert (a.cycle, a.action, a.version) == (b.cycle, b.action, b.version)
            assert abs(a.candidate_score - b.candidate_score) <= 1e-10
            assert abs(a.incumbent_score - b.incumbent_score) <= 1e-10
        np.testing.assert_allclose(port.model.coefficients, np.asarray(ref.model.coefficients), atol=1e-10)
        assert port.watch(a.candidate_score - 1e6) == ref.watch(b.candidate_score - 1e6)

    def test_kmeans_outcomes_and_scores(self, tmp_path, clusters):
        c0 = clusters[[0, 200]]
        port, ref = self._pair(tmp_path, lambda: KMeans(uid="ck").setK(2).setSeed(3),
                               lambda: JaxKMeans(uid="ck").setK(2).setSeed(3), _km_score,
                               model=kmeans_model_from_numpy(c0), jax_model=JaxKMeansModel("p", c0))
        for batch in (clusters, clusters + 2.0):
            a, b = port.run_cycle(batch), ref.run_cycle(batch)
            assert (a.cycle, a.action, a.version) == (b.cycle, b.action, b.version)
            assert abs(a.candidate_score - b.candidate_score) <= 1e-5 * abs(b.candidate_score)
            assert abs(a.incumbent_score - b.incumbent_score) <= 1e-5 * abs(b.incumbent_score)
        ref_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ref_files

    def test_ingest_split_and_journal_equal_the_reference(self, tmp_path, clusters):
        port, ref = self._pair(tmp_path, lambda: KMeans(uid="js").setK(2).setSeed(3),
                               lambda: JaxKMeans(uid="js").setK(2).setSeed(3), _km_score)
        port.run_cycle(clusters)
        ref.run_cycle(clusters)
        a, b = np.load(tmp_path / "port" / "cycle_0_data.npz"), np.load(tmp_path / "jax" / "cycle_0_data.npz")
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].tobytes() == b[f].tobytes(), f
        ja = json.loads((tmp_path / "port" / "cycle.json").read_text())
        jb = json.loads((tmp_path / "jax" / "cycle.json").read_text())
        assert set(ja) == set(jb) and set(ja["stages"]) == set(jb["stages"])
        for k in ("schema", "identity", "cycle", "fence", "finished"):
            assert ja[k] == jb[k], k
        assert ja["stages"]["ingest"]["n_train"] == jb["stages"]["ingest"]["n_train"]
        assert ja["stages"]["register"] == jb["stages"]["register"]
        assert ja["stages"]["flip"] == jb["stages"]["flip"]
        assert set(ja["stages"]["quality_gate"]) == set(jb["stages"]["quality_gate"])


@pytest.mark.parametrize("name,value", [
    ("TPUML_LIFECYCLE_HOLDOUT", "0.3"), ("TPUML_LIFECYCLE_HOLDOUT", "1.5"), ("TPUML_LIFECYCLE_HOLDOUT", "-1"),
    ("TPUML_LIFECYCLE_HOLDOUT", "x"), ("TPUML_LIFECYCLE_GATE_MARGIN", "-0.5"), ("TPUML_LIFECYCLE_GATE_MARGIN", "z"),
    ("TPUML_LIFECYCLE_REGRESS_TOL", "0.05"), ("TPUML_LIFECYCLE_REGRESS_TOL", "-1"),
    ("TPUML_DRIFT_THRESHOLD", "0.1"), ("TPUML_DRIFT_THRESHOLD", "q"), ("TPUML_DRIFT_MIN_COUNT", "7"),
    ("TPUML_DRIFT_MIN_COUNT", "0"), ("TPUML_DRIFT_MIN_COUNT", "1.5"), ("TPUML_LIFECYCLE_EVERY", "3"),
    ("TPUML_LIFECYCLE_EVERY", "0"), (None, None),
])
def test_knobs_read_like_the_reference(tmp_path, monkeypatch, name, value):
    from spark_rapids_ml_tpu.utils import envknobs as jknobs
    from spark_rapids_ml_tpu_torch.utils import envknobs as tknobs

    if name is not None:
        monkeypatch.setenv(name, value)

    def read(ctrl_cls, est, rt, mon_cls, knobs, sub):
        try:
            c = ctrl_cls(est, rt, "m", score_fn=_km_score, directory=str(tmp_path / sub))
            m = mon_cls("m")
            every = knobs.env_int("TPUML_LIFECYCLE_EVERY", 8, minimum=1)
            return ("value", c.holdout_frac, c.gate_margin, c.regress_tol, m.threshold, m.min_count, every)
        except Exception as exc:  # the outcome is compared, whatever it is
            return (type(exc).__name__, str(exc))

    ours = read(LifecycleController, KMeans(), _runtime(), DriftMonitor, tknobs, "p")
    theirs = read(JaxLifecycleController, JaxKMeans(), JaxServingRuntime(start=False), JaxDriftMonitor, jknobs, "j")
    assert ours == theirs


# --- drift monitor ----------------------------------------------------------------


class TestDriftMonitor:
    def test_bootstrap_then_stable_then_fire(self, rng, event_log):
        dm = DriftMonitor("dm", threshold=0.25, min_count=300)
        dm.observe_many(rng.normal(size=400))
        assert dm.tick() is None
        dm.observe_many(rng.normal(size=400))
        assert dm.tick() is None
        dm.observe_many(rng.normal(size=400) + 3.0)
        psi = dm.tick()
        assert psi is not None and psi > 0.25
        recs = _events(event_log)
        assert any(r["event"] == "lifecycle" and r["action"] == "drift_fire" for r in recs)
        assert any(r["event"] == "lifecycle" and r["action"] == "drift_baseline" for r in recs)

    def test_psi_equals_the_reference_on_the_same_windows(self, rng):
        ours, theirs = DriftMonitor("eq", threshold=0.05, min_count=50), JaxDriftMonitor(
            "eq", threshold=0.05, min_count=50)
        got, want = [], []
        for shift in (0.0, 0.0, 0.2, 0.5, 1.0, 3.0, 0.0):
            w = rng.normal(size=120) + shift
            ours.observe_many(w)
            theirs.observe_many(w)
            got.append(ours.tick())
            want.append(theirs.tick())
        assert got == want and any(v is not None for v in got)

    def test_slo_vote_lowers_the_window_floor_as_in_the_reference(self, rng):
        outs = []
        for cls in (DriftMonitor, JaxDriftMonitor):
            dm = cls("slo", threshold=0.25, min_count=300)
            r = np.random.default_rng(1)
            dm.observe_many(r.normal(size=400))
            dm.tick()
            dm.observe_many(r.normal(size=20) + 4.0)
            first = dm.tick()
            dm.on_slo_breach({"action": "recover"})
            second = dm.tick()
            dm.on_slo_breach({"action": "breach", "objective": "p99", "burn": 2.0})
            outs.append((first, second, dm.tick()))
        assert outs[0] == outs[1] and outs[0][0] is None and outs[0][2] is not None

    def test_small_window_never_fires(self, rng):
        dm = DriftMonitor("dm-sm", threshold=0.25, min_count=300)
        dm.observe_many(rng.normal(size=299) + 50.0)
        assert dm.tick() is None

    def test_constant_window_bootstraps(self):
        dm = DriftMonitor("dm-c", threshold=0.25, min_count=10)
        dm.observe_many(np.full(20, 3.0))
        assert dm.tick() is None
        dm.observe_many(np.full(20, 3.0))
        assert dm.tick() is None

    def test_bins_must_be_at_least_two(self):
        with pytest.raises(ValueError, match="bins must be >= 2"):
            DriftMonitor("b", bins=1)

    def test_rebaseline_forgets_reference(self, rng):
        dm = DriftMonitor("dm-rb", threshold=0.25, min_count=100)
        dm.observe_many(rng.normal(size=200))
        dm.tick()
        dm.rebaseline()
        dm.observe_many(rng.normal(size=200) + 5.0)
        assert dm.tick() is None
        dm.observe_many(rng.normal(size=200) + 5.0)
        assert dm.tick() is None

    def test_observations_land_in_the_histogram(self, rng):
        from spark_rapids_ml_tpu_torch.observability.metrics import histogram

        h = histogram("lifecycle.drift.score")
        before = h.value(model="dm-h")["count"]
        DriftMonitor("dm-h").observe_many(rng.normal(size=17))
        assert h.value(model="dm-h")["count"] == before + 17

    def test_tick_transient_fault_retries(self, rng):
        dm = DriftMonitor("dm-ft", threshold=0.25, min_count=100)
        dm.observe_many(rng.normal(size=200))
        clear_counters("retry")
        with inject("drift.tick=1"):
            assert dm.tick() is None
        assert counter_value("retry.drift.tick.attempts") >= 2

    def test_tick_fatal_fault_keeps_the_window(self, rng):
        dm = DriftMonitor("dm-ff", threshold=0.25, min_count=100)
        dm.observe_many(rng.normal(size=200))
        with inject("drift.tick=1:fatal"):
            with pytest.raises(InjectedFault):
                dm.tick()
        assert dm.tick() is None and dm._reference is not None

    def test_tick_stall_wakes_on_disarm(self, rng):
        dm = DriftMonitor("dm-st", threshold=0.25, min_count=10)
        dm.observe_many(rng.normal(size=20))
        done = threading.Event()
        with inject("drift.tick=always:stall"):
            t = threading.Thread(target=lambda: (dm.tick(), done.set()))
            t.start()
            assert not done.wait(0.3), "stalled tick returned while armed"
        assert done.wait(5.0), "stalled tick never woke after disarm"
        t.join()


# --- journal unit surface (the process-death matrix is in
# test_torch_lifecycle_journal.py) ----------------------------------------------


class TestJournalUnit:
    ID = {"name": "m", "estimator": "KMeans"}

    def test_fresh_then_resume(self, tmp_path):
        j = CycleJournal.resume_or_start(str(tmp_path), self.ID, 4)
        j.mark("ingest", {"data": "p"})
        j2 = CycleJournal.resume_or_start(str(tmp_path), self.ID, 99)
        assert j2.cycle == 4 and j2.done("ingest")
        assert j2.payload("ingest") == {"data": "p"}

    def test_finished_journal_starts_fresh(self, tmp_path):
        j = CycleJournal.resume_or_start(str(tmp_path), self.ID, 0)
        j.mark("ingest", {})
        j.finish()
        j2 = CycleJournal.resume_or_start(str(tmp_path), self.ID, 1)
        assert j2.cycle == 1 and not j2.done("ingest")

    def test_double_mark_raises(self, tmp_path):
        j = CycleJournal.resume_or_start(str(tmp_path), self.ID, 0)
        j.mark("ingest", {})
        with pytest.raises(RuntimeError, match="already journaled"):
            j.mark("ingest", {})

    def test_unknown_stage_rejected(self, tmp_path):
        j = CycleJournal.resume_or_start(str(tmp_path), self.ID, 0)
        with pytest.raises(ValueError, match="unknown stage"):
            j.mark("deploy", {})

    def test_fence_round_trips(self, tmp_path):
        j = CycleJournal.resume_or_start(str(tmp_path), self.ID, 0)
        assert j.fence() is None
        j.set_fence(3)
        assert CycleJournal.resume_or_start(str(tmp_path), self.ID, 9).fence() == 3
