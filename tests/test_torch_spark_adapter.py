"""The port's pyspark adapter (``spark_rapids_ml_tpu_torch/spark/adapter.py``)
against the contract stub and the reference's adapter.

The reference's contract suite (``tests/spark_contract_suite.py``) runs
here against the PORT's adapter: every ``Test*`` class of the suite is
taken into this module's namespace, as ``tests/test_spark_adapter.py``
does, and the ``spark_env`` fixture below hands it the port's module.
The classes that name a reference module as the code under test run as
port twins instead (:data:`PORT_TWINS`, each with its reason).

Then parity: the same DataFrame through the reference's ``Tpu*`` class
and the port's, in one process under the stub:

- PCA components at 1e-9 (sign-invariant), explained variance at 1e-10;
- KMeans centres bitwise (the executors' and driver's numpy arithmetic
  and the seeding are the reference's);
- linear coefficients and intercept at 1e-10;
- logistic through the gang path: L2 coefficients at 1e-10 with equal
  ``numIter`` (float64 rows); the elastic net to FISTA's tol, 1e-5 (each
  package draws its own power-iteration start vector);
- forests (no bootstrap): equal predictions on the training rows, gains
  at 1e-6 (regression: 1e-5 relative), thresholds at 1e-6 where the same
  feature was chosen (an exactly tied split may go either way);
- neighbours: indices exact, distances at 1e-10 (kNN, float64) or 1e-5
  (ANN, float32); DBSCAN labels exact;
- UMAP: trustworthiness within 0.03 of the reference's (the random draws
  differ by design), and the adapter's layout bitwise the port's own
  ``UMAP`` fit of the collected rows.

And the cross-loads: a model saved by either adapter loads in the other
and transforms the same DataFrame identically.

Every case runs on the CPU (``device.set_platform("cpu")``), at the
suite's sizes (a few hundred rows, 2–4 partitions).
"""

import importlib
import os
import sys

import numpy as np
import pytest

import spark_contract_suite as _suite
from spark_rapids_ml_tpu_torch import device as port_device

#: Suite classes whose code under test is a reference module named in
#: the test body, with the port twin that runs instead.
PORT_TWINS = {
    "TestExecutorMath": (
        "imports spark_rapids_ml_tpu.spark.executor_math and the reference's core "
        "models; twin: tests/test_torch_spark_layer.py::TestExecutorMath"
    ),
    "TestBarrierGangRecovery": (
        "imports spark_rapids_ml_tpu.spark.barrier; twin: "
        "tests/test_torch_spark_barrier.py::TestBarrierGangRecovery"
    ),
    "TestGangFitPublicAPI": (
        "imports spark_rapids_ml_tpu.spark.barrier and the reference's estimators "
        "and trace tools; twin: tests/test_torch_spark_barrier.py::TestGangFitPublicAPI"
    ),
}

for _name in dir(_suite):
    if _name.startswith("Test") and _name not in PORT_TWINS:
        globals()[_name] = getattr(_suite, _name)

_STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pyspark_stub")
ADAPTERS = ("spark_rapids_ml_tpu.spark.adapter", "spark_rapids_ml_tpu_torch.spark.adapter")

pytestmark = pytest.mark.spark


def install_stub():
    """Put the pyspark stub first on ``sys.path`` and (re)import both
    adapters against it. Returns the undo callable, which restores
    ``sys.modules`` and ``sys.path`` as they were (the reference's
    ``tests/test_spark_adapter.py`` fixture, for both adapters)."""
    had_real = "pyspark" in sys.modules
    saved = {name: mod for name, mod in sys.modules.items() if name.startswith("pyspark")}
    for name in list(saved):
        del sys.modules[name]
    sys.path.insert(0, _STUB)
    was = {name: sys.modules.pop(name, None) for name in ADAPTERS}

    def undo():
        sys.path.remove(_STUB)
        for name in [n for n in sys.modules if n.startswith("pyspark")]:
            del sys.modules[name]
        sys.modules.update(saved)
        for name, mod in was.items():
            if mod is not None and not had_real:
                sys.modules[name] = mod
            else:
                sys.modules.pop(name, None)

    return undo


@pytest.fixture(scope="module")
def stub():
    """Both adapters imported against the stub, the CPU platform, and a
    SparkSession: ``(port_adapter, reference_adapter, spark)``."""
    undo = install_stub()
    port_device.set_platform("cpu")
    try:
        ours = importlib.import_module(ADAPTERS[1])
        theirs = importlib.import_module(ADAPTERS[0])
        assert ours.HAS_PYSPARK and theirs.HAS_PYSPARK, "stub failed to import as pyspark"
        from pyspark.sql import SparkSession

        yield ours, theirs, SparkSession.builder.master("local[2]").getOrCreate()
    finally:
        port_device.set_platform("cuda")
        undo()


@pytest.fixture(scope="module")
def spark_env(stub):
    """The suite's fixture: ``(adapter_module, SparkSession)`` with the
    PORT's adapter."""
    ours, _, spark = stub
    return ours, spark


def test_every_suite_class_runs_here_or_has_a_port_twin():
    import test_torch_spark_barrier as barrier_twins
    import test_torch_spark_layer as layer_twins

    suite = {n for n in dir(_suite) if n.startswith("Test")}
    here = {n for n in globals() if n.startswith("Test")}
    assert suite - here == set(PORT_TWINS)
    twins = {"TestExecutorMath": layer_twins, "TestBarrierGangRecovery": barrier_twins,
             "TestGangFitPublicAPI": barrier_twins}
    for name, module in twins.items():
        assert hasattr(module, name), name


# --- parity: the same DataFrame through both adapters ----------------------


def _df(spark, x, y=None, n_parts=3):
    return _suite._vector_df(spark, x, extra=None if y is None else {"label": list(y)}, n_parts=n_parts)


def _both(stub, build, df):
    ours, theirs, _ = stub
    return build(ours).fit(df), build(theirs).fit(df)


def _column(model, df, name):
    return np.stack([np.asarray(getattr(r, name).toArray() if hasattr(getattr(r, name), "toArray")
                                else getattr(r, name)) for r in model.transform(df).collect()])


def _sign_align(a, b):
    signs = np.sign(np.sum(a * b, axis=0))
    return a * np.where(signs == 0, 1.0, signs)


def _same_splits(a, b, gain_rtol=0.0):
    """Gains equal to 1e-6 at every node (plus ``gain_rtol``); thresholds
    to 1e-6 where both forests split on the same feature (a feature
    differs only where two splits tie)."""
    from spark_rapids_ml_tpu_torch.core.lazy_state import to_host

    fa, fb = to_host(a.feature), to_host(b.feature)
    np.testing.assert_allclose(to_host(a.node_gain), to_host(b.node_gain), atol=1e-6, rtol=gain_rtol)
    same = fa == fb
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(to_host(a.threshold)[same], to_host(b.threshold)[same], atol=1e-6, rtol=0)


class TestParity:
    def test_pca(self, stub, rng):
        _, _, spark = stub
        x = rng.normal(size=(300, 6)) * np.linspace(1, 3, 6) + 5.0
        df = _df(spark, x)
        ours, theirs = _both(stub, lambda a: a.TpuPCA(k=3, inputCol="features", outputCol="pca"), df)
        pc_o, pc_t = np.asarray(ours.pc.toArray()), np.asarray(theirs.pc.toArray())
        np.testing.assert_allclose(_sign_align(pc_o, pc_t), pc_t, atol=1e-9, rtol=0)
        np.testing.assert_allclose(np.asarray(ours.explainedVariance.toArray()),
                                   np.asarray(theirs.explainedVariance.toArray()), atol=1e-10, rtol=0)
        host = stub[0].TpuPCA(k=3, inputCol="features").setUseCuSolverSVD(False).fit(df)
        np.testing.assert_allclose(_sign_align(np.asarray(host.pc.toArray()), pc_o), pc_o, atol=1e-9, rtol=0)
        np.testing.assert_allclose(_column(ours, df, "pca"), x @ pc_o, atol=1e-9)

    def test_pca_ordinal_beyond_the_visible_cards_raises(self, stub, rng, monkeypatch):
        import torch

        ours, _, spark = stub
        df = _df(spark, rng.normal(size=(20, 3)))
        monkeypatch.setattr(port_device, "_platform", "cuda")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="gpuId=3 but only 1 CUDA device"):
            ours.TpuPCA(k=2, inputCol="features").setGpuId(3).fit(df)

    @pytest.mark.parametrize("visible, want", [("1", 0), ("0,1", 1), ("3,1", 1), (None, 1)])
    def test_an_executor_resolves_its_task_card_at_the_index_it_sees(self, stub, monkeypatch, visible, want):
        """Inside a UDF the task resource names a host card; once the
        executor is pinned to it (or its cards are isolated) the process
        sees that card at its position in ``CUDA_VISIBLE_DEVICES``."""
        import pyspark
        import torch
        from types import SimpleNamespace

        ours, _, _ = stub
        ctx = SimpleNamespace(resources=lambda: {"gpu": SimpleNamespace(addresses=["1"])})
        monkeypatch.setattr(pyspark.TaskContext, "get", staticmethod(lambda: ctx))
        if visible is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        monkeypatch.setattr(port_device, "_platform", "cuda")
        monkeypatch.setattr(port_device, "use_ieee_fp32_matmul", lambda: None)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1 if visible == "1" else 2)
        assert ours._driver_device() == torch.device("cuda", want)

    def test_kmeans_centres_are_bitwise(self, stub, rng):
        _, _, spark = stub
        x = np.concatenate([c + rng.normal(scale=0.5, size=(70, 3)) for c in ([0, 0, 0], [6, 0, 2], [0, 7, 1])])
        df = _df(spark, x)
        ours, theirs = _both(stub, lambda a: a.TpuKMeans(k=3).setSeed(4).setMaxIter(15), df)
        assert np.stack(ours.clusterCenters()).tobytes() == np.stack(theirs.clusterCenters()).tobytes()
        np.testing.assert_array_equal(_column(ours, df, "prediction"), _column(theirs, df, "prediction"))

    @pytest.mark.parametrize("reg", [0.0, 0.3])
    def test_linear(self, stub, rng, reg):
        _, _, spark = stub
        x = rng.normal(size=(300, 5)) + 3.0
        y = x @ np.arange(1.0, 6.0) + 0.5 + 0.1 * rng.normal(size=300)
        df = _df(spark, x, y)
        ours, theirs = _both(stub, lambda a: a.TpuLinearRegression().setRegParam(reg), df)
        np.testing.assert_allclose(np.asarray(ours.coefficients.toArray()),
                                   np.asarray(theirs.coefficients.toArray()), atol=1e-10, rtol=0)
        assert ours.intercept == pytest.approx(theirs.intercept, abs=1e-10)

    @pytest.mark.parametrize("enet", [0.0, 0.5])
    def test_logistic_through_the_gang(self, stub, rng, enet):
        _, _, spark = stub
        x = rng.normal(size=(300, 4))
        y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=300) > 0).astype(float)
        df = _df(spark, x, y)
        ours, theirs = _both(stub, lambda a: a.TpuLogisticRegression().setMaxIter(80).setRegParam(0.05)
                             .setElasticNetParam(enet), df)
        # L2 is L-BFGS from zero on both sides. The elastic net is FISTA
        # with a step from a power iteration whose start vector each
        # package draws from its own generator: to FISTA's tol, as in
        # tests/test_torch_logistic.py's estimator case.
        tol = 1e-10 if enet == 0.0 else 1e-5
        np.testing.assert_allclose(np.asarray(ours.coefficients.toArray()),
                                   np.asarray(theirs.coefficients.toArray()), atol=tol, rtol=0)
        assert ours.intercept == pytest.approx(theirs.intercept, abs=tol)
        if enet == 0.0:
            assert ours._core.numIter == theirs._core.numIter

    @pytest.mark.parametrize("classification", [True, False])
    def test_forests(self, stub, rng, classification):
        """The two adapters share the executors' numpy histograms; the
        driver's float32 split search differs in rounding (ROADMAP C's
        XLA fma note). Two splits whose gains are equal in exact
        arithmetic (the same rows on each side) are then broken either
        way: the gains agree to 1e-6 at every node (regression: 1e-5
        relative), the thresholds to 1e-6 at the
        nodes that chose the same feature, and the predictions on the
        training rows are equal. Every row weighs 1 (no bootstrap), so an
        exactly tied split sends every training row the same way."""
        ours_mod, theirs_mod, spark = stub
        x = rng.normal(size=(240, 4))
        y = (((x[:, 0] > 0.3) | (x[:, 1] < -0.5)).astype(float) if classification
             else 2.0 * x[:, 0] - x[:, 1] + 0.1 * rng.normal(size=240))
        df = _df(spark, x, y)
        cls = "TpuRandomForestClassifier" if classification else "TpuRandomForestRegressor"
        ours, theirs = _both(stub, lambda a: getattr(a, cls)().setNumTrees(5).setMaxDepth(4).setSeed(2)
                             .setBootstrap(False).setFeatureSubsetStrategy("all"), df)
        np.testing.assert_array_equal(_column(ours, df, "prediction"), _column(theirs, df, "prediction"))
        # A variance gain is a float32 difference of E[y²]-sized terms, so
        # the two split searches' roundings part at ~1e-6 of those terms.
        _same_splits(ours._core._forest, theirs._core._forest, gain_rtol=0 if classification else 1e-5)

    @pytest.mark.parametrize("classification", [True, False])
    def test_forest_is_the_ports_direct_fit(self, stub, rng, classification):
        """With nothing drawn on the executors (no bootstrap, rate 1) the
        adapter's forest is the port's own fit of the same rows, the
        feature-subset draws included, to the same rule as above: the
        adapter sums its histograms in float64 on the executors, the core
        in float32 on the device."""
        from spark_rapids_ml_tpu_torch.classification import RandomForestClassifier
        from spark_rapids_ml_tpu_torch.regression import RandomForestRegressor

        ours_mod, _, spark = stub
        x = rng.normal(size=(200, 6))
        y = ((x[:, 0] + x[:, 3] > 0).astype(float) if classification else x[:, 0] - 2.0 * x[:, 4])
        df = _df(spark, x, y)
        name, core_cls = (("TpuRandomForestClassifier", RandomForestClassifier) if classification
                          else ("TpuRandomForestRegressor", RandomForestRegressor))
        ours = (getattr(ours_mod, name)().setNumTrees(6).setMaxDepth(4).setSeed(9).setBootstrap(False)
                .fit(df))
        core = core_cls().setNumTrees(6).setMaxDepth(4).setSeed(9).setBootstrap(False).fit((x, y))
        tol = 0 if classification else 1e-5
        np.testing.assert_allclose(_column(ours, df, "prediction"), np.asarray(core.predict(x)), atol=tol, rtol=0)
        _same_splits(ours._core._forest, core._forest)

    @pytest.mark.parametrize("mode", ["collected", "sharded"])
    def test_nearest_neighbours(self, stub, rng, mode):
        _, _, spark = stub
        items = rng.normal(size=(240, 6))
        df, qdf = _df(spark, items), _df(spark, rng.normal(size=(30, 6)))
        ours, theirs = _both(stub, lambda a: a.TpuNearestNeighbors(k=5).setIndexMode(mode), df)
        ro, rt = ours.kneighbors(qdf).collect(), theirs.kneighbors(qdf).collect()
        np.testing.assert_array_equal(np.stack([r.indices for r in ro]), np.stack([r.indices for r in rt]))
        np.testing.assert_allclose(np.stack([r.distances for r in ro]), np.stack([r.distances for r in rt]),
                                   atol=1e-10, rtol=0)

    @pytest.mark.parametrize("algo,params", [("brute", {}), ("ivfflat", {"nlist": 6, "nprobe": 6})])
    def test_approximate_neighbours(self, stub, rng, algo, params):
        _, _, spark = stub
        items = rng.normal(size=(300, 8))
        df = _df(spark, items)
        ours, theirs = _both(stub, lambda a: a.TpuApproximateNearestNeighbors(k=4).setAlgorithm(algo)
                             .setAlgoParams(params), df)
        ro, rt = ours.kneighbors(df).collect(), theirs.kneighbors(df).collect()
        np.testing.assert_array_equal(np.stack([r.indices for r in ro]), np.stack([r.indices for r in rt]))
        # Both packages' ANN routes compute in float32.
        np.testing.assert_allclose(np.stack([r.distances for r in ro]), np.stack([r.distances for r in rt]),
                                   atol=1e-5, rtol=0)

    def test_dbscan_labels_are_exact(self, stub, rng):
        _, _, spark = stub
        x = np.concatenate([rng.normal(scale=0.2, size=(50, 3)) + c for c in ([0, 0, 0], [4, 4, 0])]
                           + [rng.uniform(-2, 6, size=(10, 3))])
        df = _df(spark, x)
        ours, theirs = _both(stub, lambda a: a.TpuDBSCAN().setEps(0.7).setMinSamples(4), df)
        np.testing.assert_array_equal(ours.labels_, theirs.labels_)
        np.testing.assert_array_equal(_column(ours, df, "prediction"), _column(theirs, df, "prediction"))

    def test_umap(self, stub, rng):
        import torch

        from spark_rapids_ml_tpu_torch.manifold import UMAP
        from spark_rapids_ml_tpu_torch.utils.testing import trustworthiness

        _, _, spark = stub
        x = np.concatenate([rng.normal(size=(40, 6)) + off for off in (0.0, 8.0)])
        df = _df(spark, x)
        ours, theirs = _both(stub, lambda a: a.TpuUMAP().setNNeighbors(8).setNEpochs(60).setSeed(0), df)
        t_o, t_t = trustworthiness(x, ours.embedding, 5), trustworthiness(x, np.asarray(theirs.embedding), 5)
        assert abs(t_o - t_t) <= 0.03, (t_o, t_t)
        direct = UMAP().setNNeighbors(8).setNEpochs(60).setSeed(0).setBuildAlgo("brute").fit(torch.from_numpy(x))
        assert np.asarray(ours.embedding).tobytes() == np.asarray(direct.embedding).tobytes()
        np.testing.assert_array_equal(_column(ours, df, "embedding"), np.asarray(ours.embedding, dtype=np.float64))


# --- models saved by either adapter load in the other ------------------------


def _fit_model(adapter, name, spark, rng):
    x = rng.normal(size=(160, 4)) + np.repeat(np.eye(2, 4) * 4.0, 80, axis=0)
    y_cls = (x[:, 0] > 2.0).astype(float)
    y_reg = x @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.1
    builds = {
        "TpuPCAModel": (lambda: adapter.TpuPCA(k=2, inputCol="features", outputCol="out"), None),
        "TpuKMeansModel": (lambda: adapter.TpuKMeans(k=2).setSeed(1), None),
        "TpuLinearRegressionModel": (lambda: adapter.TpuLinearRegression().setRegParam(0.1), y_reg),
        "TpuLogisticRegressionModel": (lambda: adapter.TpuLogisticRegression().setMaxIter(30), y_cls),
        "TpuRandomForestClassificationModel": (
            lambda: adapter.TpuRandomForestClassifier().setNumTrees(4).setMaxDepth(3), y_cls),
        "TpuRandomForestRegressionModel": (
            lambda: adapter.TpuRandomForestRegressor().setNumTrees(4).setMaxDepth(3), y_reg),
        "TpuDBSCANModel": (lambda: adapter.TpuDBSCAN().setEps(1.5).setMinSamples(4), None),
        "TpuUMAPModel": (lambda: adapter.TpuUMAP().setNNeighbors(6).setNEpochs(20).setSeed(0), None),
    }
    build, y = builds[name]
    df = _df(spark, x, y)
    return build().fit(df), df


_OUTPUT = {"TpuPCAModel": "out", "TpuUMAPModel": "embedding"}
MODELS = ["TpuPCAModel", "TpuKMeansModel", "TpuLinearRegressionModel", "TpuLogisticRegressionModel",
          "TpuRandomForestClassificationModel", "TpuRandomForestRegressionModel", "TpuDBSCANModel",
          "TpuUMAPModel"]


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("name", MODELS)
def test_a_saved_model_loads_and_transforms_identically_in_the_other_adapter(stub, rng, tmp_path, name,
                                                                              direction):
    ours, theirs, spark = stub
    writer, reader = (theirs, ours) if direction == "reference_to_port" else (ours, theirs)
    model, df = _fit_model(writer, name, spark, rng)
    path = str(tmp_path / name)
    model._save_impl(path)
    loaded = getattr(reader, name).load(path)
    assert type(loaded).__module__ == reader.__name__
    col = _OUTPUT.get(name, "prediction")
    want, got = _column(model, df, col), _column(loaded, df, col)
    assert want.dtype == got.dtype and want.tobytes() == got.tobytes()
