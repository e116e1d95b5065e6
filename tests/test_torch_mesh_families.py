"""The port's mesh fits against the JAX package's mesh fits of the same rows.

Data: n = 203 rows (no mesh shape divides it) and d = 7 features (a model
axis of 2 pads them to 8), made from a numpy seed; the JAX side runs on
its 8-device virtual CPU mesh, the port on ``make_mesh(shape,
devices=[cpu] * 8)``. Tolerances, in float64:

  - PCA (covariance, ``topk``, the sketch, ``auto``'s wide routing, the
    streamed mesh covariance and the block reader): components 1e-8 up to
    sign, explained-variance ratios 1e-10; the ``dd`` and ``pallas``
    refusals word for word;
  - KMeans from pinned initial centres: centres 1e-8, cost 1e-8 relative,
    equal ``numIter``; the port's mesh fit equals its own single-device
    fit for one seed (k-means++ and random seeding) up to summation order;
  - LinearRegression with and without weights: 1e-7;
  - LogisticRegression binomial and multinomial: 1e-5 with equal
    ``numIter``, and the port's mesh fit makes as many objective
    evaluations as its single-device fit.
"""

import functools

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogistic
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.core.data import HostArrayBlockReader as JaxReader
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinear
from spark_rapids_ml_tpu.utils.testing import assert_components_close
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.core.data import DataFrame, HostArrayBlockReader
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.utils.testing import assert_close
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

CPU = torch.device("cpu")
MESHES = [(4, 2), (8, 1)]
N, D = 203, 7
_RNG = np.random.default_rng(2026)
X = _RNG.normal(size=(N, D)) * np.linspace(1.0, 3.0, D) + 1.5
X[:70] += 6.0
COEF = _RNG.normal(size=D)
Y = X @ COEF + 0.3 + 0.05 * _RNG.normal(size=N)
W = _RNG.uniform(0.2, 2.0, size=N)
Y_BIN = (X[:, 0] - X[:, 2] + 0.5 * _RNG.normal(size=N) > 0.5).astype(np.float64)
Y_MULTI = np.digitize(X[:, 1] + 0.3 * _RNG.normal(size=N), [1.0, 2.5]).astype(np.float64)
INIT = X[[0, 80, 140, 200]] + 0.01


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def port_mesh(shape):
    return make_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def jax_mesh(shape):
    return jax_make_mesh(shape)


# --- PCA ------------------------------------------------------------------

PCA_CASES = {
    "covariance_full": dict(eigenSolver="full"),
    "covariance_topk": dict(eigenSolver="topk", eigenIters=40),
    "covariance_auto": dict(eigenSolver="auto"),
    "no_centering": dict(eigenSolver="full", meanCentering=False),
    "cpu_svd": dict(eigenSolver="full", useCuSolverSVD=False),
}


def _configure(est, **params):
    for name, value in params.items():
        getattr(est, "set" + name[0].upper() + name[1:])(value)
    return est


def _pca_close(model, want):
    assert_components_close(model.pc, np.asarray(want.pc), 1e-8)
    assert_close("ratios", model.explainedVariance, np.asarray(want.explainedVariance), rtol=0, atol=1e-10)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", list(PCA_CASES))
def test_pca_mesh_fit_matches_jax(case, shape):
    params = PCA_CASES[case]
    model = _configure(PCA(mesh=port_mesh(shape)).setK(3), **params).fit([X[:60], X[60:]])
    want = _configure(JaxPCA(mesh=jax_mesh(shape)).setK(3), **params).fit([X[:60], X[60:]])
    _pca_close(model, want)


@pytest.mark.parametrize("shape", MESHES)
def test_pca_mesh_fit_of_a_tensor_matches_jax(shape):
    x = X[:200]  # a tensor's rows must divide the data axis
    model = PCA(mesh=port_mesh(shape)).setK(3).setEigenSolver("full").fit(torch.from_numpy(x))
    want = JaxPCA(mesh=jax_mesh(shape)).setK(3).setEigenSolver("full").fit(
        __import__("jax").numpy.asarray(x))
    _pca_close(model, want)
    with pytest.raises(ValueError, match="rows divisible by the data axis"):
        PCA(mesh=port_mesh(shape)).setK(3).fit(torch.from_numpy(X))


def test_pca_sketch_on_a_mesh_matches_jax():
    model = PCA(mesh=port_mesh((8, 1))).setK(3).setSolver("randomized").fit(X)
    want = JaxPCA(mesh=jax_mesh((8, 1))).setK(3).setSolver("randomized").fit(X)
    _pca_close(model, want)


def test_pca_sketch_refuses_a_padded_model_axis_like_jax():
    with pytest.raises(ValueError) as ours:
        PCA(mesh=port_mesh((4, 2))).setK(3).setSolver("randomized").fit(X)
    with pytest.raises(ValueError) as theirs:
        JaxPCA(mesh=jax_mesh((4, 2))).setK(3).setSolver("randomized").fit(X)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape,sketch", [((8, 1), True), ((4, 2), False)])
def test_pca_auto_wide_routing_matches_jax(monkeypatch, shape, sketch):
    # A low wide-feature threshold makes d = 7 "wide": a model axis that
    # would pad the features keeps the covariance.
    monkeypatch.setattr(PCA, "_RANDOMIZED_AUTO_DIM", 6)
    monkeypatch.setattr(JaxPCA, "_RANDOMIZED_AUTO_DIM", 6)
    before = counter_value("pca.sketch")
    model = PCA(mesh=port_mesh(shape)).setK(3).fit(X)
    want = JaxPCA(mesh=jax_mesh(shape)).setK(3).fit(X)
    assert (counter_value("pca.sketch") > before) is sketch
    _pca_close(model, want)


STREAMS = {
    "factory": (lambda: (lambda: iter([X[:50], X[50:51], X[51:]])),
                lambda: (lambda: iter([X[:50], X[50:51], X[51:]]))),
    "reader": (lambda: HostArrayBlockReader(X, block_rows=64), lambda: JaxReader(X, block_rows=64)),
}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("stream", list(STREAMS))
def test_pca_streamed_mesh_covariance_matches_jax(stream, shape):
    ours, theirs = STREAMS[stream]
    model = PCA(mesh=port_mesh(shape)).setK(3).setEigenSolver("full").fit(ours())
    want = JaxPCA(mesh=jax_mesh(shape)).setK(3).setEigenSolver("full").fit(theirs())
    _pca_close(model, want)


REFUSALS = {
    "dd": lambda cls, mesh: cls(mesh=mesh).setK(3).setPrecision("dd").fit(X),
    "pallas": lambda cls, mesh: cls(mesh=mesh).setK(3).setCovarianceBackend("pallas").fit(X),
    "streaming_sketch": lambda cls, mesh: cls(mesh=mesh).setK(3).setSolver("randomized").fit(
        lambda: iter([X])),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pca_mesh_refusals_match_jax(case):
    with pytest.raises(ValueError) as ours:
        REFUSALS[case](PCA, port_mesh((4, 2)))
    with pytest.raises(ValueError) as theirs:
        REFUSALS[case](JaxPCA, jax_mesh((4, 2)))
    assert str(ours.value) == str(theirs.value)


def test_row_matrix_refuses_pallas_and_dd_on_a_mesh():
    from spark_rapids_ml_tpu.linalg.row_matrix import RowMatrix as JaxRowMatrix
    from spark_rapids_ml_tpu_torch.linalg.row_matrix import RowMatrix

    for kwargs in (dict(backend="pallas"), dict(precision="dd")):
        with pytest.raises(ValueError) as ours:
            RowMatrix([X], mesh=port_mesh((8, 1)), **kwargs)
        with pytest.raises(ValueError) as theirs:
            JaxRowMatrix([X], mesh=jax_mesh((8, 1)), **kwargs)
        assert str(ours.value) == str(theirs.value)
    assert RowMatrix.resolve("auto", mesh=port_mesh((8, 1))) == "highest"


# --- KMeans ---------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("cosine", [False, True])
def test_kmeans_mesh_fit_matches_jax(shape, cosine):
    measure = "cosine" if cosine else "euclidean"
    model = (KMeans(mesh=port_mesh(shape)).setK(4).setDistanceMeasure(measure).setMaxIter(30)
             .setInitialModel(INIT).fit(torch.from_numpy(X)))
    want = (JaxKMeans(mesh=jax_mesh(shape)).setK(4).setDistanceMeasure(measure).setMaxIter(30)
            .setInitialModel(INIT).fit(X))
    assert_close("centers", model.clusterCenters(), np.asarray(want.clusterCenters()), rtol=0, atol=1e-8)
    assert_close("cost", model.trainingCost, want.trainingCost, rtol=1e-8)
    assert model.numIter == want.numIter


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("init_mode", ["k-means||", "random"])
def test_kmeans_mesh_fit_equals_the_single_device_fit(shape, init_mode):
    x = torch.from_numpy(X)
    model = KMeans(mesh=port_mesh(shape)).setK(5).setSeed(11).setInitMode(init_mode).fit(x)
    single = KMeans().setK(5).setSeed(11).setInitMode(init_mode).fit(x)
    assert_close("centers", model.clusterCenters(), single.clusterCenters(), rtol=0, atol=1e-12)
    assert model.numIter == single.numIter


def test_kmeans_mesh_refuses_a_stream_and_the_fused_route():
    with pytest.raises(ValueError, match="single-device"):
        KMeans(mesh=port_mesh((8, 1))).setK(2).fit(lambda: iter([X]))
    with pytest.raises(ValueError, match="a mesh"):
        KMeans(mesh=port_mesh((8, 1))).setK(2).setBackend("fused").fit(X)


# --- LinearRegression -----------------------------------------------------

LINEAR_CASES = {
    "ridge": dict(regParam=0.1),
    "ols": dict(regParam=0.0),
    "no_intercept": dict(regParam=0.05, fitIntercept=False),
    "elastic_net": dict(regParam=0.05, elasticNetParam=0.5),
}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", list(LINEAR_CASES))
def test_linear_mesh_fit_matches_jax(case, shape):
    params = LINEAR_CASES[case]
    model = _configure(LinearRegression(mesh=port_mesh(shape)), **params).fit((X, Y))
    want = _configure(JaxLinear(mesh=jax_mesh(shape)), **params).fit((X, Y))
    assert_close("coef", model.coefficients, np.asarray(want.coefficients), rtol=0, atol=1e-7)
    assert_close("intercept", model.intercept, want.intercept, rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", MESHES)
def test_weighted_linear_mesh_fit_matches_jax(shape):
    df = DataFrame({"features": list(X), "label": list(Y), "w": list(W)})
    jdf = JaxDataFrame({"features": list(X), "label": list(Y), "w": list(W)})
    model = LinearRegression(mesh=port_mesh(shape)).setWeightCol("w").setRegParam(0.1).fit(df)
    want = JaxLinear(mesh=jax_mesh(shape)).setWeightCol("w").setRegParam(0.1).fit(jdf)
    assert_close("coef", model.coefficients, np.asarray(want.coefficients), rtol=0, atol=1e-7)
    assert_close("intercept", model.intercept, want.intercept, rtol=0, atol=1e-7)


# --- LogisticRegression -----------------------------------------------------

LOGISTIC_CASES = {
    "binomial": (Y_BIN, dict(regParam=0.01)),
    "multinomial": (Y_MULTI, dict(regParam=0.01)),
    "multinomial_unregularized": (Y_MULTI, dict(regParam=0.0, maxIter=50)),
}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", list(LOGISTIC_CASES))
def test_logistic_mesh_fit_matches_jax(case, shape):
    y, params = LOGISTIC_CASES[case]
    evals = counter_value("logistic.lbfgs.evaluations")
    model = _configure(LogisticRegression(mesh=port_mesh(shape)), **params).fit((X, y))
    evals = counter_value("logistic.lbfgs.evaluations") - evals
    want = _configure(JaxLogistic(mesh=jax_mesh(shape)), **params).fit((X, y))
    assert_close("weights", model.weights, np.asarray(want.weights), rtol=0, atol=1e-5)
    assert_close("intercepts", model.intercepts, np.asarray(want.intercepts), rtol=0, atol=1e-5)
    assert model.numIter == want.numIter
    single_evals = counter_value("logistic.lbfgs.evaluations")
    single = _configure(LogisticRegression(), **params).fit((X, y))
    assert counter_value("logistic.lbfgs.evaluations") - single_evals == evals
    assert single.numIter == model.numIter


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("fused", [True, False])
def test_logistic_mesh_fit_equals_the_single_device_fit(shape, fused):
    df = DataFrame({"features": list(X), "label": list(Y_BIN), "w": list(W)})
    for est in (lambda m: LogisticRegression(mesh=m, fused=fused).setRegParam(0.02).setWeightCol("w"),
                lambda m: LogisticRegression(mesh=m, fused=fused).setRegParam(0.05).setElasticNetParam(0.5)):
        model = est(port_mesh(shape)).fit(df)
        single = est(None).fit(df)
        assert_close("weights", model.weights, single.weights, rtol=0, atol=1e-10)
        assert model.numIter == single.numIter


def test_logistic_mesh_refuses_a_stream():
    with pytest.raises(ValueError, match="single-device"):
        LogisticRegression(mesh=port_mesh((8, 1))).fit((lambda: iter([X]), Y_BIN))
