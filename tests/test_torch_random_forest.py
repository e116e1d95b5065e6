"""The port's RandomForestClassifier / RandomForestRegressor
(``models/random_forest.py``) against the JAX package's, on the same
numpy inputs, and against the reference's bars
(``tests/test_random_forest.py``, the Spark-written directories of
``tests/test_golden_spark.py``).

With ``bootstrap=False``, ``subsamplingRate=1`` and
``featureSubsetStrategy="all"`` neither package draws anything, so the
fits are held field by field: classifier forests bitwise, except that a
threshold may differ by one float32 ulp (the reference's one XLA program
recomputes an edge for its threshold gather with its own rounding; the
binning and so the splits are the same); entropy's gains and impurities
to 1e-6 (log2, see ``test_torch_trees.py``), as are gini's where XLA
fuses the sums of five classes its own way; regression structure
bitwise and leaves within 1e-5; predictions of the same forest bitwise
(classification) or within 1e-5 (regression). Seeded fits draw from a
``torch.Generator`` and are held to the reference's bars.
"""

import pickle

import cloudpickle
import numpy as np
import pandas as pd
import pytest
import torch

pa = pytest.importorskip("pyarrow")

from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame  # noqa: E402
from spark_rapids_ml_tpu.models import random_forest as jax_rf  # noqa: E402
from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch import interop  # noqa: E402
from spark_rapids_ml_tpu_torch.classification import (  # noqa: E402
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from spark_rapids_ml_tpu_torch.core.data import DataFrame  # noqa: E402
from spark_rapids_ml_tpu_torch.core.membudget import FitMemoryError  # noqa: E402
from spark_rapids_ml_tpu_torch.models import random_forest as port_rf  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.trees import Forest  # noqa: E402
from spark_rapids_ml_tpu_torch.regression import (  # noqa: E402
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.utils.testing import assert_close  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _blobs(rng, n_per=100, d=6):
    centers = np.array([[4.0, 0, 0, 0, 0, 0], [0, 4.0, 0, 0, 0, 0], [0, 0, 4.0, 0, 0, 0]])[:, :d]
    xs, ys = [], []
    for c_i, c in enumerate(centers):
        xs.append(rng.normal(size=(n_per, d)) * 0.5 + c)
        ys.append(np.full(n_per, c_i))
    return np.concatenate(xs), np.concatenate(ys).astype(float)


RNG = np.random.default_rng(17)
X = RNG.standard_normal((600, 5))
Y_CLASS = ((X[:, 0] + 0.5 * X[:, 1]) > 0).astype(float) + (X[:, 2] > 1)
Y_REG = np.sin(2 * X[:, 0]) + X[:, 1] ** 2 + 0.1 * RNG.standard_normal(600)
W = RNG.uniform(0.2, 3.0, 600)


def _fixed(est):
    return est.setBootstrap(False).setSubsamplingRate(1.0).setFeatureSubsetStrategy("all")


def _bits(a):
    return np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))


def _hold_classifier_forest(ours, theirs, entropy=False):
    """Bitwise, thresholds within one ulp; with ``entropy`` the gains and
    impurities within 1e-6."""
    for f in Forest._fields:
        got, want = _bits(getattr(ours, f)), _bits(getattr(theirs, f))
        if f == "threshold":
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), f
        elif entropy and f in ("node_gain", "node_impurity"):
            assert_close(f, got, want, rtol=1e-6, atol=1e-6)
        else:
            assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8)), f


def _hold_regression_forest(ours, theirs):
    for f in ("feature", "is_leaf", "node_weight"):
        assert np.array_equal(_bits(getattr(ours, f)), _bits(getattr(theirs, f))), f
    assert np.all(np.abs(_bits(ours.threshold) - _bits(theirs.threshold)) <= np.spacing(np.abs(_bits(theirs.threshold))))
    assert_close("leaf_value", ours.leaf_value, theirs.leaf_value, rtol=1e-5, atol=1e-5)


def _inputs(kind, x, y, frame_cls, weights=None):
    if kind == "tuple":
        return (x, y)
    if kind == "tensor":
        return (torch.from_numpy(x), torch.from_numpy(y))
    cols = {"features": list(x), "label": list(y)}
    if weights is not None:
        cols["w"] = list(weights)
    if kind == "dataframe":
        return frame_cls(cols)
    if kind == "pandas":
        return pd.DataFrame(cols)
    frame = pd.DataFrame(x, columns=[f"f{i}" for i in range(x.shape[1])])
    frame["label"] = y
    if weights is not None:
        frame["w"] = weights
    return frame


KINDS = ("tuple", "tensor", "dataframe", "pandas", "pandas_bare")


# --- deterministic parity ----------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_classifier_matches_the_reference(impurity, kind):
    ours = _fixed(RandomForestClassifier()).setNumTrees(3).setMaxDepth(4).setImpurity(impurity)
    theirs = _fixed(jax_rf.RandomForestClassifier()).setNumTrees(3).setMaxDepth(4).setImpurity(impurity)
    om = ours.fit(_inputs(kind, X, Y_CLASS, DataFrame))
    tm = theirs.fit(_inputs(kind, X, Y_CLASS, JaxDataFrame))
    assert om.numClasses == tm.numClasses == 3 and om.numFeatures == tm.numFeatures == 5
    _hold_classifier_forest(om._forest, tm._forest, entropy=impurity == "entropy")
    assert np.array_equal(_bits(om.predictProbability(X)), _bits(tm.predictProbability(X)))
    assert np.array_equal(om.predict(X), np.asarray(tm.predict(X)))
    assert om.totalNumNodes == tm.totalNumNodes
    assert_close("featureImportances", om.featureImportances, tm.featureImportances, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ("tuple", "tensor", "dataframe"))
@pytest.mark.parametrize("depth,bins,min_instances,min_info_gain", [(2, 8, 1, 0.0), (5, 32, 10, 0.0),
                                                                      (4, 16, 1, 0.01), (0, 32, 1, 0.0)])
def test_regressor_matches_the_reference(kind, depth, bins, min_instances, min_info_gain):
    def cfg(est):
        return (_fixed(est).setNumTrees(2).setMaxDepth(depth).setMaxBins(bins)
                .setMinInstancesPerNode(min_instances).setMinInfoGain(min_info_gain))

    om = cfg(RandomForestRegressor()).fit(_inputs(kind, X, Y_REG, DataFrame))
    tm = cfg(jax_rf.RandomForestRegressor()).fit(_inputs(kind, X, Y_REG, JaxDataFrame))
    _hold_regression_forest(om._forest, tm._forest)
    assert_close("predict", om.predict(X), np.asarray(tm.predict(X)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("estimator", ["classifier", "regressor"])
def test_weight_col_matches_the_reference(estimator):
    y = Y_CLASS if estimator == "classifier" else Y_REG
    cls = RandomForestClassifier if estimator == "classifier" else RandomForestRegressor
    jcls = getattr(jax_rf, cls.__name__)
    om = _fixed(cls()).setNumTrees(2).setMaxDepth(3).setWeightCol("w").fit(_inputs("dataframe", X, y, DataFrame, W))
    tm = _fixed(jcls()).setNumTrees(2).setMaxDepth(3).setWeightCol("w").fit(
        _inputs("dataframe", X, y, JaxDataFrame, W))
    for f in ("feature", "is_leaf"):
        assert np.array_equal(_bits(getattr(om._forest, f)), _bits(getattr(tm._forest, f))), f
    assert_close("leaf_value", om._forest.leaf_value, tm._forest.leaf_value, rtol=1e-5, atol=1e-5)
    assert_close("node_weight", om._forest.node_weight, tm._forest.node_weight, rtol=1e-6, atol=1e-6)


def test_integer_weights_keep_the_exact_histogram():
    w = np.ones(600)
    w[::7] = 3.0
    frame = {"features": list(X), "label": list(Y_CLASS), "w": list(w)}
    om = _fixed(RandomForestClassifier()).setNumTrees(2).setMaxDepth(3).setWeightCol("w").fit(DataFrame(frame))
    tm = _fixed(jax_rf.RandomForestClassifier()).setNumTrees(2).setMaxDepth(3).setWeightCol("w").fit(
        JaxDataFrame(frame))
    _hold_classifier_forest(om._forest, tm._forest)


@pytest.mark.parametrize("stats,weights,want", [
    (np.eye(2, dtype=np.float32)[[0, 1, 1]], torch.tensor([[1.0, 2.0, 0.0]]), True),
    (np.eye(2, dtype=np.float32)[[0, 1, 1]] * 0.5, torch.ones((1, 3)), False),
    (np.eye(2, dtype=np.float32)[[0, 1, 1]] * 129, torch.tensor([[1.0, 2.0, 1.0]]), False),
    (np.eye(2, dtype=np.float32)[[0, 1, 1]], torch.tensor([[1.0, 1.5, 1.0]]), False),
    (np.zeros((0, 2), dtype=np.float32), torch.ones((1, 0)), False),
])
@pytest.mark.parametrize("on_tensor", [False, True])
def test_the_bf16_exactness_predicate_matches_the_reference(stats, weights, want, on_tensor):
    import jax.numpy as jnp

    if stats.size:
        assert bool(jax_rf._hist_exact_in_bf16(stats, jnp.asarray(weights.numpy()))) == want
    rs = torch.from_numpy(stats) if on_tensor else stats
    assert port_rf._hist_exact_in_bf16(rs, weights) == want


# --- the reference's seeded bars -------------------------------------------


def test_single_tree_exact_split():
    rng = np.random.default_rng(0)
    x = np.zeros((200, 3))
    x[:, 0] = np.concatenate([rng.uniform(-1, 0.4, 100), rng.uniform(0.6, 2, 100)])
    x[:, 1:] = rng.normal(size=(200, 2))
    y = np.concatenate([np.zeros(100), np.ones(100)])
    model = RandomForestClassifier().setNumTrees(1).setMaxDepth(1).setBootstrap(False).setSeed(3).fit((x, y))
    assert np.array_equal(model.predict(x), y.astype(int))
    assert int(model._forest.feature[0, 0]) == 0
    assert 0.3 <= float(model._forest.threshold[0, 0]) <= 0.7


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_blobs_accuracy(impurity):
    x, y = _blobs(np.random.default_rng(42))
    model = RandomForestClassifier().setNumTrees(15).setMaxDepth(4).setSeed(1).setImpurity(impurity).fit((x, y))
    assert np.mean(model.predict(x) == y) >= 0.98
    probs = model.predictProbability(x)
    assert probs.shape == (len(y), 3)
    assert_close("probability sums", probs.sum(axis=1), np.ones(len(y)), rtol=0, atol=1e-5)


def test_matches_sklearn_accuracy():
    from sklearn.ensemble import RandomForestClassifier as SkRF

    x, y = _blobs(np.random.default_rng(42), n_per=150)
    x_test, y_test = _blobs(np.random.default_rng(7), n_per=50)
    ours = RandomForestClassifier().setNumTrees(20).setMaxDepth(5).setSeed(2).fit((x, y))
    theirs = SkRF(n_estimators=20, max_depth=5, random_state=2).fit(x, y)
    assert np.mean(ours.predict(x_test) == y_test) >= theirs.score(x_test, y_test) - 0.05


def test_seeded_fits_are_deterministic_and_seeds_differ():
    x, y = _blobs(np.random.default_rng(42), n_per=40)
    m1 = RandomForestClassifier().setNumTrees(5).setSeed(11).fit((x, y))
    m2 = RandomForestClassifier().setNumTrees(5).setSeed(11).fit((x, y))
    m3 = RandomForestClassifier().setNumTrees(5).setSeed(12).fit((x, y))
    for f in Forest._fields:
        assert torch.equal(getattr(m1._forest, f), getattr(m2._forest, f)), f
    assert not torch.equal(m1._forest.node_weight, m3._forest.node_weight)


def test_feature_importances_find_the_informative_feature():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(300, 5))
    y = (x[:, 0] > 0).astype(float)
    imp = RandomForestClassifier().setNumTrees(10).setMaxDepth(3).setSeed(5).fit((x, y)).featureImportances
    assert imp.shape == (5,) and imp.sum() == pytest.approx(1.0, abs=1e-6) and imp[0] > 0.8


def test_min_instances_per_node_keeps_trees_shallow():
    x, y = _blobs(np.random.default_rng(42), n_per=30)
    model = RandomForestClassifier().setNumTrees(3).setMaxDepth(6).setMinInstancesPerNode(20).setSeed(8).fit((x, y))
    assert int((model._forest.feature >= 0).sum()) <= 3 * 7


def test_piecewise_constant_recovery():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 4, size=(400, 2))
    y = np.floor(x[:, 0])
    model = (RandomForestRegressor().setNumTrees(1).setMaxDepth(2).setMaxBins(128).setBootstrap(False)
             .setSeed(0).fit((x, y)))
    assert np.sqrt(np.mean((model.predict(x) - y) ** 2)) < 0.15


def test_regressor_matches_sklearn_rmse():
    from sklearn.ensemble import RandomForestRegressor as SkRFR

    rng = np.random.default_rng(42)
    x = rng.uniform(-2, 2, size=(500, 4))
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.1 * rng.normal(size=500)
    ours = RandomForestRegressor().setNumTrees(20).setMaxDepth(6).setFeatureSubsetStrategy("all").setSeed(3).fit((x, y))
    theirs = SkRFR(n_estimators=20, max_depth=6, random_state=3).fit(x, y)
    rmse = np.sqrt(np.mean((ours.predict(x) - y) ** 2))
    assert rmse <= np.sqrt(np.mean((theirs.predict(x) - y) ** 2)) * 1.5


@pytest.mark.parametrize("kind", ["tuple", "tensor"])
def test_large_label_offset(kind):
    rng = np.random.default_rng(42)
    x = rng.normal(size=(300, 3))
    y = 2.0 * x[:, 0] + 10_000.0
    model = (RandomForestRegressor().setNumTrees(10).setMaxDepth(6).setFeatureSubsetStrategy("all").setSeed(2)
             .fit(_inputs(kind, x, y, DataFrame)))
    pred = model.predict(torch.from_numpy(x) if kind == "tensor" else x)
    assert np.sqrt(np.mean((np.asarray(pred) - y) ** 2)) < 0.6


def test_subsampling_without_bootstrap():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(200, 3))
    y = x[:, 0] * 2.0
    model = (RandomForestRegressor().setNumTrees(10).setSubsamplingRate(0.7).setBootstrap(False)
             .setFeatureSubsetStrategy("all").setSeed(2).fit((x, y)))
    assert np.sqrt(np.mean((model.predict(x) - y) ** 2)) < 0.6
    assert set(np.unique(model._forest.node_weight[:, 0].numpy())) <= set(range(201))


# --- setNumClasses ------------------------------------------------------------


def test_hinted_fit_matches_the_inferred_one():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(300, 5))
    y = ((x[:, 0] + x[:, 1]) > 0).astype(float)
    inferred = RandomForestClassifier().setNumTrees(6).setMaxDepth(4).setSeed(3).fit((x, y))
    hinted = RandomForestClassifier().setNumTrees(6).setMaxDepth(4).setSeed(3).setNumClasses(2).fit((x, y))
    assert hinted.numClasses == 2
    assert np.array_equal(hinted.predictProbability(x), inferred.predictProbability(x))


def test_a_hinted_tensor_fit_reads_nothing_back(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(200, 4)).astype(np.float32))
    y = (x[:, 0] > 0).to(torch.float32)
    est = RandomForestClassifier().setNumTrees(4).setMaxDepth(3).setSeed(0).setNumClasses(2)

    def refuse(*args, **kwargs):
        raise AssertionError("a device value was read back during the fit")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "numpy", "__int__", "__float__"):
            m.setattr(torch.Tensor, name, refuse)
        model = est.fit((x, y))
    root_w = float(model._forest.node_weight[0, 0])
    assert abs(root_w - 200.0) < 5 * np.sqrt(200.0) and model.numClasses == 2


def test_the_hint_survives_copy_and_validates():
    assert RandomForestClassifier().setNumClasses(3).copy().getNumClasses() == 3
    with pytest.raises(ValueError, match="numClasses"):
        RandomForestClassifier().setNumClasses(1)
    assert RandomForestClassifier().setNumClasses(4).setNumClasses(0).getNumClasses() == 0


def test_declared_classes_widen_the_distribution():
    model = _fixed(RandomForestClassifier()).setNumTrees(2).setMaxDepth(2).setNumClasses(5).fit((X, Y_CLASS))
    theirs = _fixed(jax_rf.RandomForestClassifier()).setNumTrees(2).setMaxDepth(2).setNumClasses(5).fit((X, Y_CLASS))
    assert model.predictProbability(X).shape == (600, 5)
    # In this program XLA rounds the 5-class gini sums its own way.
    _hold_classifier_forest(model._forest, theirs._forest, entropy=True)


# --- models: outputs, transform, pickling -----------------------------------


def test_model_outputs_follow_the_input():
    model = _fixed(RandomForestClassifier()).setNumTrees(3).setMaxDepth(3).fit((X, Y_CLASS))
    probs = model.predictProbability(X)
    assert isinstance(probs, np.ndarray) and probs.dtype == np.float32
    probs_t = model.predictProbability(torch.from_numpy(X))
    assert isinstance(probs_t, torch.Tensor) and np.array_equal(probs_t.numpy(), probs)
    assert torch.equal(model.predict(torch.from_numpy(X)), torch.from_numpy(np.argmax(probs, axis=1)))
    assert np.array_equal(model.predictRaw(X), probs * 3)
    reg = _fixed(RandomForestRegressor()).setNumTrees(2).setMaxDepth(3).fit((X, Y_REG))
    assert isinstance(reg.predict(X), np.ndarray) and isinstance(reg.predict(torch.from_numpy(X)), torch.Tensor)
    assert np.array_equal(reg.predict(X[:1][0]), reg.predict(X[:1]))


@pytest.mark.parametrize("kind", ["dataframe", "pandas", "pandas_bare", "tuple"])
def test_classifier_transform_matches_the_reference(kind):
    om = _fixed(RandomForestClassifier()).setNumTrees(3).setMaxDepth(3).fit(_inputs(kind, X, Y_CLASS, DataFrame))
    tm = _fixed(jax_rf.RandomForestClassifier()).setNumTrees(3).setMaxDepth(3).fit(
        _inputs(kind, X, Y_CLASS, JaxDataFrame))
    if kind == "tuple":
        assert np.array_equal(om.transform(X), np.asarray(tm.transform(X)))
        return
    ours, theirs = om.transform(_inputs(kind, X, Y_CLASS, DataFrame)), tm.transform(_inputs(kind, X, Y_CLASS,
                                                                                               JaxDataFrame))
    for col in ("prediction", "probability", "rawPrediction"):
        got = ours.select(col) if kind == "dataframe" else ours[col].tolist()
        want = theirs.select(col) if kind == "dataframe" else theirs[col].tolist()
        assert np.array_equal(np.asarray(list(got)), np.asarray(list(want))), col


@pytest.mark.parametrize("kind", ["dataframe", "pandas", "tuple"])
def test_regressor_transform_matches_the_reference(kind):
    om = _fixed(RandomForestRegressor()).setNumTrees(2).setMaxDepth(3).fit(_inputs(kind, X, Y_REG, DataFrame))
    tm = _fixed(jax_rf.RandomForestRegressor()).setNumTrees(2).setMaxDepth(3).fit(
        _inputs(kind, X, Y_REG, JaxDataFrame))
    if kind == "tuple":
        assert_close("transform", om.transform(X), np.asarray(tm.transform(X)), rtol=1e-5, atol=1e-5)
        return
    ours = om.transform(_inputs(kind, X, Y_REG, DataFrame))
    theirs = tm.transform(_inputs(kind, X, Y_REG, JaxDataFrame))
    got = ours.select("prediction") if kind == "dataframe" else ours["prediction"].tolist()
    want = theirs.select("prediction") if kind == "dataframe" else theirs["prediction"].tolist()
    assert_close("prediction", np.asarray(list(got), dtype=float), np.asarray(list(want), dtype=float),
                 rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("estimator", ["classifier", "regressor"])
def test_pickle_carries_the_forest_on_the_host(estimator):
    cls = RandomForestClassifier if estimator == "classifier" else RandomForestRegressor
    y = Y_CLASS if estimator == "classifier" else Y_REG
    model = _fixed(cls()).setNumTrees(2).setMaxDepth(3).fit((torch.from_numpy(X), torch.from_numpy(y)))
    model.predict(X)  # fills the per-device cache
    other = pickle.loads(cloudpickle.dumps(model))
    assert other._forest_dev == {} and other.uid == model.uid and other.getMaxDepth() == 3
    assert all(t.device.type == "cpu" for t in other._forest)
    assert np.array_equal(np.asarray(other.predict(X)), np.asarray(model.predict(X)))


# --- persistence ------------------------------------------------------------


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
@pytest.mark.parametrize("estimator", ["classifier", "regressor"])
def test_save_load_both_ways(tmp_path, estimator, direction):
    cls = RandomForestClassifier if estimator == "classifier" else RandomForestRegressor
    y = Y_CLASS if estimator == "classifier" else Y_REG
    ours = _fixed(cls()).setNumTrees(3).setMaxDepth(4).setMaxBins(16).fit((X, y))
    theirs = _fixed(getattr(jax_rf, cls.__name__)()).setNumTrees(3).setMaxDepth(4).setMaxBins(16).fit((X, y))
    model_name = "RandomForestClassificationModel" if estimator == "classifier" else "RandomForestRegressionModel"
    port_cls = getattr(port_rf, model_name)
    jax_cls = getattr(jax_rf, model_name)
    saver, loader = {
        "port_to_jax": (ours, jax_cls), "jax_to_port": (theirs, port_cls), "port_to_port": (ours, port_cls),
    }[direction]
    path = str(tmp_path / "rf")
    saver.write.overwrite().save(path)
    loaded = loader.load(path)
    assert loaded.uid == saver.uid and loaded.getMaxDepth() == 4 and loaded.getMaxBins() == 16
    assert loaded.numFeatures == 5
    if estimator == "classifier":
        assert loaded.numClasses == 3
        assert np.array_equal(np.asarray(loaded.predictProbability(X)), np.asarray(saver.predictProbability(X)))
        assert loaded.totalNumNodes == saver.totalNumNodes
    else:
        assert np.array_equal(np.asarray(loaded.predict(X)), np.asarray(saver.predict(X)))
    # Spark's layout keeps the reachable nodes only: the slots below a
    # leaf come back empty, so is_leaf is not compared.
    for f in ("feature", "threshold", "node_gain", "node_impurity"):
        assert np.array_equal(_bits(getattr(loaded._forest, f)), _bits(getattr(saver._forest, f))), f


def test_saved_layout_is_sparks(tmp_path):
    import pyarrow.parquet as pq

    model = _fixed(RandomForestClassifier()).setNumTrees(2).setMaxDepth(2).fit((X, Y_CLASS))
    path = str(tmp_path / "rf")
    model.save(path)
    data = pq.read_table(f"{path}/data/part-00000.parquet")
    assert data.schema.field("nodeData").type == port_rf._spark_nodedata_type()
    assert data.schema.field("nodeData").type == jax_rf._spark_nodedata_type()
    trees = pq.read_table(f"{path}/treesMetadata/part-00000.parquet").to_pylist()
    assert [t["treeID"] for t in trees] == [0, 1] and all(t["weights"] == 1.0 for t in trees)
    ours = port_rf._tree_to_nodedata(Forest(*(t.numpy() for t in model._forest)), 1, True)
    theirs = jax_rf._tree_to_nodedata(jax_rf.Forest(*(t.numpy() for t in model._forest)), 1, True)
    assert ours == theirs


def _golden(tmp_path, name, class_name, rows, param_map, parts=1):
    from tests.test_golden_spark import _nodedata_schema, _write_spark_metadata, _write_spark_parquet

    path = str(tmp_path / name)
    import os

    os.makedirs(path)
    _write_spark_metadata(path, class_name, f"{class_name.rsplit('.', 1)[-1]}_g", param_map)
    _write_spark_parquet(path, _nodedata_schema(), [{"treeID": t, "nodeData": nd} for t, nd in rows], "{}",
                         parts=parts)
    return path


@pytest.mark.parametrize("parts", [1, 2])
def test_spark_written_classifier_loads(tmp_path, parts):
    from tests.test_golden_spark import _node

    rows = [
        (0, _node(0, 1.0, 0.495, [9, 11], 20, gain=0.3, left=1, right=2, feat=0, thr=0.5)),
        (1, _node(0, 0.0, 0.5, [5, 5], 10)),
        (0, _node(1, 0.0, 0.32, [8, 2], 10)),
        (0, _node(2, 1.0, 0.18, [1, 9], 10)),
    ]
    path = _golden(tmp_path, "spark_rfc", "org.apache.spark.ml.classification.RandomForestClassificationModel",
                   rows, {"numTrees": 2, "featuresCol": "features"}, parts)
    model = RandomForestClassificationModel.load(path)
    q = np.array([[0.0, 0.0], [1.0, 0.0]])
    assert_close("probabilities", model.predictProbability(q), np.array([[0.65, 0.35], [0.3, 0.7]]), rtol=0,
                 atol=1e-6)
    assert np.array_equal(model.predict(q), [0, 1]) and model.totalNumNodes == 4
    theirs = jax_rf.RandomForestClassificationModel.load(path)
    assert np.array_equal(model.predictProbability(q), np.asarray(theirs.predictProbability(q)))


def test_spark_written_regressor_loads(tmp_path):
    from tests.test_golden_spark import _node

    rows = [
        (0, _node(0, 0.8, 2.1, [10, 8, 30.0], 10, gain=1.5, left=1, right=2, feat=1, thr=0.0)),
        (0, _node(1, -1.0, 0.1, [4, -4.0, 4.4], 4)),
        (0, _node(2, 2.0, 0.1, [6, 12.0, 24.6], 6)),
    ]
    path = _golden(tmp_path, "spark_rfr", "org.apache.spark.ml.regression.RandomForestRegressionModel",
                   rows, {"numTrees": 1})
    model = RandomForestRegressionModel.load(path)
    assert_close("prediction", model.predict(np.array([[0.0, -1.0], [0.0, 1.0]])), np.array([-1.0, 2.0]),
                 rtol=0, atol=1e-6)


def test_the_reference_legacy_layout_loads(tmp_path):
    from spark_rapids_ml_tpu.core.persistence import save_metadata, save_rows

    path = str(tmp_path / "legacy_rf")
    save_metadata(jax_rf.RandomForestClassificationModel(), path,
                  class_name="org.apache.spark.ml.classification.RandomForestClassificationModel",
                  extra_metadata={"numFeatures": 1, "numClasses": 2})
    save_rows(path, {
        "treeID": ("scalar", [0, 0, 0]), "nodeID": ("scalar", [0, 1, 2]),
        "feature": ("scalar", [0, -1, -1]), "threshold": ("scalar", [0.5, 0.0, 0.0]),
        "isLeaf": ("scalar", [False, True, True]),
        "leafValue": ("vector", [[0.5, 0.5], [0.8, 0.2], [0.1, 0.9]]),
        "nodeWeight": ("scalar", [20.0, 10.0, 10.0]), "nodeGain": ("scalar", [0.3, 0.0, 0.0]),
    })
    model = RandomForestClassificationModel.load(path)
    assert_close("probabilities", model.predictProbability(np.array([[0.0], [1.0]])),
                 np.array([[0.8, 0.2], [0.1, 0.9]]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("estimator", ["classifier", "regressor"])
def test_interop_carries_the_reference_forest(estimator):
    if estimator == "classifier":
        theirs = jax_rf.RandomForestClassifier().setNumTrees(4).setMaxDepth(3).setSeed(7).fit((X, Y_CLASS))
    else:
        theirs = jax_rf.RandomForestRegressor().setNumTrees(4).setMaxDepth(3).setSeed(7).fit((X, Y_REG))
    params = {p.name: v for p, v in theirs.extractParamMap().items()}
    arrays = {f: np.asarray(getattr(theirs._forest, f)) for f in Forest._fields}
    if estimator == "classifier":
        ours = interop.random_forest_classification_model_from_numpy(arrays, theirs.numFeatures, theirs.numClasses,
                                                                     uid=theirs.uid, params=params)
        assert np.array_equal(ours.predictProbability(X), np.asarray(theirs.predictProbability(X)))
        assert ours.numClasses == 3
    else:
        ours = interop.random_forest_regression_model_from_numpy(arrays, theirs.numFeatures, uid=theirs.uid,
                                                                 params=params)
        assert np.array_equal(ours.predict(X), np.asarray(theirs.predict(X)))
    assert ours.uid == theirs.uid and ours.getSeed() == 7 and ours.getNumTrees() == 4
    with pytest.raises(ValueError, match="forest_arrays lacks"):
        interop.random_forest_regression_model_from_numpy({"feature": arrays["feature"]}, 5)


# --- params, errors, unported routes ----------------------------------------


def test_feature_subset_resolution_matches_the_reference():
    for args in [("auto", 100, 20, True), ("auto", 100, 20, False), ("auto", 100, 1, True), ("all", 9, 5, True),
                 ("sqrt", 100, 5, False), ("log2", 64, 5, True), ("onethird", 9, 5, True), ("onethird", 4, 5, True),
                 ("5", 9, 5, True), ("50", 9, 5, True), ("0.5", 10, 5, True), ("1.0", 10, 5, True),
                 ("LOG2", 1, 2, False)]:
        assert port_rf.resolve_feature_subset(*args) == jax_rf.resolve_feature_subset(*args), args
    for bad in ("bogus", "0", "-3", "1.5", "0.0"):
        with pytest.raises(ValueError) as ours:
            port_rf.resolve_feature_subset(bad, 10, 5, True)
        with pytest.raises(ValueError) as theirs:
            jax_rf.resolve_feature_subset(bad, 10, 5, True)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("cls", ["RandomForestClassifier", "RandomForestRegressor",
                                 "RandomForestClassificationModel", "RandomForestRegressionModel"])
def test_defaults_match_the_reference(cls):
    ours, theirs = getattr(port_rf, cls)(), getattr(jax_rf, cls)()
    # deployMode (gang fits) arrived with the distribution slice.
    assert {p.name for p in ours.params} == {p.name for p in theirs.params}
    for p in theirs.params:
        if theirs.hasDefault(p):
            assert ours.getOrDefault(p.name) == theirs.getOrDefault(p), p.name


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("call", [
    lambda m: m.RandomForestClassifier().setNumTrees(0),
    lambda m: m.RandomForestClassifier().setMaxDepth(20),
    lambda m: m.RandomForestClassifier().setMaxDepth(-1),
    lambda m: m.RandomForestClassifier().setMaxBins(1),
    lambda m: m.RandomForestClassifier().setMinInstancesPerNode(0),
    lambda m: m.RandomForestClassifier().setSubsamplingRate(0.0),
    lambda m: m.RandomForestClassifier().setSubsamplingRate(1.5),
    lambda m: m.RandomForestClassifier().setImpurity("variance"),
    lambda m: m.RandomForestRegressor().setImpurity("gini"),
    lambda m: m.RandomForestClassifier().setNumClasses(1),
    lambda m: m.RandomForestClassifier().fit((np.zeros((4, 2)), np.array([0.5, 1, 0, 1]))),
    lambda m: m.RandomForestClassifier().fit((np.zeros((4, 2)), np.array([-1.0, 1, 0, 1]))),
    lambda m: m.RandomForestClassifier().setWeightCol("w").fit((np.zeros((4, 2)), np.zeros(4))),
    lambda m: m.RandomForestRegressor().fit(np.zeros((4, 2))),
], ids=["trees", "depth_high", "depth_low", "bins", "min_instances", "rate_zero", "rate_high", "class_impurity",
        "reg_impurity", "num_classes", "fractional_labels", "negative_labels", "weight_col_on_tuple", "no_labels"])
def test_errors_match_the_reference(call):
    assert _message(lambda: call(port_rf)) == _message(lambda: call(jax_rf))


def test_an_input_over_the_fit_memory_budget_is_refused(monkeypatch):
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1000")
    for est in (RandomForestClassifier(), RandomForestRegressor()):
        with pytest.raises(FitMemoryError, match="no streaming fit") as info:
            est.fit((X, Y_CLASS))
        assert info.value.family == "random_forest" and info.value.budget_bytes == 1000
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "0")
    assert RandomForestClassifier().setNumTrees(1).setMaxDepth(1).fit((X, Y_CLASS)).numClasses == 3


def test_unported_routes_name_their_items():
    """The mesh route is ported since: ``setMesh`` and ``mesh=`` grow the
    single-device forest (the classifier bitwise, the regressor's
    predictions within 1e-5); the serving signature is checked below."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((4, 2), devices=[torch.device("cpu")] * 8)
    est = RandomForestClassifier().setNumTrees(3).setMaxDepth(3).setSeed(4)
    single = est.fit((X, Y_CLASS))
    ours = est.copy().setMesh(mesh).fit((X, Y_CLASS))
    for f in Forest._fields:
        assert torch.equal(getattr(ours._forest, f), getattr(single._forest, f)), f
    reg = RandomForestRegressor(mesh=mesh).setNumTrees(3).setMaxDepth(3).setSeed(4).fit((X, Y_REG))
    want = RandomForestRegressor().setNumTrees(3).setMaxDepth(3).setSeed(4).fit((X, Y_REG))
    assert_close("mesh regressor", reg.predict(X), want.predict(X), rtol=1e-5, atol=1e-5)
    model = _fixed(RandomForestRegressor()).setNumTrees(1).setMaxDepth(1).fit((X, Y_REG))
    # The serving signatures arrived with the composition slice; an
    # unfitted model has none, as in the reference.
    assert model.serving_signature().name == "rf.predict"
    with pytest.raises(RuntimeError, match="no fitted forest"):
        RandomForestClassificationModel().serving_signature()


def test_cuda_platform_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_device.set_platform("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        RandomForestClassifier().fit((X, Y_CLASS))
