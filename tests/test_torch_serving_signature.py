"""The port's serving signatures against the JAX package's.

``serving/signature.py`` and ``serving_signature()`` on the six model
families that declare one. The reference's models are carried across
with ``interop`` (KMeans and forest draws cannot match), so both
packages' signature kernels run on the same weights and the same seeded
float64 rows, the JAX side with x64 on as tier-1 runs it. Tolerances:
labels exact, real values 1e-10 (float64; the forests' float32 outputs
bitwise). Every signature's ``output_spec`` matches its kernel's real
output on a probe batch, host float64 and float32 tensors alike, and its
kernel gives the model's own ``predict`` / ``transform`` bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogReg
from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinReg
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR
from spark_rapids_ml_tpu.serving.signature import ServingSignature as JaxSignature
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.classification import LogisticRegression, RandomForestClassificationModel
from spark_rapids_ml_tpu_torch.core import serving as core_serving
from spark_rapids_ml_tpu_torch.models import logistic_regression as port_logreg
from spark_rapids_ml_tpu_torch.models import random_forest as port_rf
from spark_rapids_ml_tpu_torch.ops.trees import Forest
from spark_rapids_ml_tpu_torch.regression import LinearRegressionModel
from spark_rapids_ml_tpu_torch.serving import ServingSignature, spec_bytes
from spark_rapids_ml_tpu_torch.serving.signature import spec, tree_leaves, tree_map
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

N, D = 96, 12


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _data(seed: int = 42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    y = (x[:, 0] + x[:, 1] - x[:, 2] > 0).astype(np.int64)
    return x, y


X, Y = _data()
Y3 = np.digitize(X[:, 0] + 0.5 * X[:, 3], [-0.5, 0.5]).astype(np.int64)


def stage_dict(ref) -> dict:
    """A fitted reference model as ``interop.pipeline_model_from_numpy``'s
    stage description."""
    params = {p.name: v for p, v in ref.extractParamMap().items()}
    name = type(ref).__name__
    if name == "PCAModel":
        return {"family": "pca", "pc": ref.pc, "explained_variance": ref.explainedVariance,
                "uid": ref.uid, "params": params}
    if name == "KMeansModel":
        return {"family": "kmeans", "centers": ref.clusterCenters(), "uid": ref.uid, "params": params,
                "training_cost": ref.trainingCost, "num_iter": ref.numIter}
    if name == "LinearRegressionModel":
        return {"family": "linear_regression", "coef": ref.coefficients, "intercept": ref.intercept,
                "uid": ref.uid, "params": params}
    if name == "LogisticRegressionModel":
        return {"family": "logistic_regression", "weights": ref.weights, "intercepts": ref.intercepts,
                "num_classes": ref.numClasses, "uid": ref.uid, "params": params, "num_iter": ref.numIter}
    arrays = {f: np.asarray(getattr(ref._forest, f)) for f in Forest._fields}
    if name == "RandomForestClassificationModel":
        return {"family": "random_forest_classification", "forest_arrays": arrays,
                "numFeatures": ref.numFeatures, "numClasses": ref.numClasses, "uid": ref.uid, "params": params}
    assert name == "RandomForestRegressionModel", name
    return {"family": "random_forest_regression", "forest_arrays": arrays, "numFeatures": ref.numFeatures,
            "uid": ref.uid, "params": params}


def carry(ref):
    """The reference's fitted model as the port's."""
    return interop.pipeline_model_from_numpy([stage_dict(ref)]).stages[0]


FAMILIES = {
    "pca": lambda: JaxPCA().setK(4).fit(X),
    "kmeans": lambda: JaxKMeans().setK(3).setSeed(7).fit(X),
    "kmeans-cosine": lambda: JaxKMeans().setK(3).setSeed(7).setDistanceMeasure("cosine").fit(X),
    "linreg": lambda: JaxLinReg().setRegParam(0.1).fit((X, X[:, 1] - 2.0 * X[:, 4])),
    "logreg": lambda: JaxLogReg().setMaxIter(25).fit((X, Y)),
    "logreg-threshold": lambda: JaxLogReg().setMaxIter(25).setThreshold(0.3).fit((X, Y)),
    "logreg-multinomial": lambda: JaxLogReg().setMaxIter(25).fit((X, Y3)),
    "rf-classifier": lambda: JaxRFC().setNumTrees(5).setMaxDepth(4).setSeed(3).fit((X, Y3)),
    "rf-regressor": lambda: JaxRFR().setNumTrees(5).setMaxDepth(4).setSeed(3).fit((X, X[:, 0])),
}
_REFS: dict = {}


def _ref(family):
    if family not in _REFS:
        _REFS[family] = FAMILIES[family]()
    return _REFS[family]


def _run(sig, x):
    return sig.kernel(x, *sig.weights, **sig.static)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_signature_matches_the_reference(family):
    ref = _ref(family)
    theirs, ours = ref.serving_signature(), carry(ref).serving_signature()
    assert ours.name == theirs.name
    assert ours.static == theirs.static
    assert ours.n_features == theirs.n_features == D
    assert (ours.select is None) == (theirs.select is None)
    want = _jax_leaves(_run(theirs, X))
    got = tree_leaves(_run(ours, torch.from_numpy(X)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if np.issubdtype(w.dtype, np.integer) or w.dtype == np.float32:
            assert np.array_equal(_host(g), w), ours.name
        else:
            assert_close(ours.name, g, w, rtol=0, atol=1e-10 * max(1.0, float(np.abs(w).max())))


def _jax_leaves(tree):
    import jax

    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_output_spec_matches_the_real_output(family, dtype):
    sig = carry(_ref(family)).serving_signature()
    probe = torch.from_numpy(X[:7]).to(dtype)
    real = _run(sig, probe)
    specs = sig.output_spec(7, dtype)
    assert isinstance(specs, tuple) == isinstance(real, tuple)
    for s, r in zip(tree_leaves(specs), tree_leaves(real)):
        assert s.device.type == "meta"
        assert (tuple(s.shape), s.dtype) == (tuple(r.shape), r.dtype)
    if sig.select is not None:
        picked, real_picked = sig.select(specs), sig.select(real)
        assert (tuple(picked.shape), picked.dtype) == (tuple(real_picked.shape), real_picked.dtype)
    assert spec_bytes(specs) == sum(r.numel() * r.element_size() for r in tree_leaves(real))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernel_is_the_models_own_route(family):
    """The signature's kernel on the signature's weights gives the model's
    own predict / transform bit for bit, for a tensor and a host batch."""
    model = carry(_ref(family))
    sig = model.serving_signature()
    for x in (torch.from_numpy(X), torch.from_numpy(X.astype(np.float32))):
        out = _run(sig, x)
        out = sig.select(out) if sig.select is not None else out
        if family.startswith("rf-classifier"):
            want = torch.argmax(model.predictProbability(x), dim=1)
        elif family == "pca":
            want = model.transform(x)
        else:
            want = model.predict(x)
        assert torch.equal(out, want), family
    host = sig.host_weights if sig.host_weights is not None else sig.weights
    out = sig.kernel(torch.from_numpy(X), *host, **sig.static)
    out = sig.select(out) if sig.select is not None else out
    want = model.transform(X) if family == "pca" else (
        np.argmax(model.predictProbability(X), axis=1) if family == "rf-classifier" else model.predict(X))
    assert np.array_equal(_host(out), want), family


def test_signature_fields_are_the_references():
    ours = {f.name for f in dataclasses.fields(ServingSignature)}
    theirs = {f.name for f in dataclasses.fields(JaxSignature)}
    assert theirs <= ours
    assert ours - theirs == {"host_weights", "_moved"}


def test_weights_helpers():
    sig = carry(_ref("logreg")).serving_signature()
    w, b = sig.weights
    assert sig.weights_dtype() == torch.float64
    assert sig.weights_bytes() == w.numel() * 8 + b.numel() * 8
    cpu = sig.cpu_weights()
    assert cpu is sig.cpu_weights()
    assert all(a.device.type == "cpu" and torch.equal(a, b_) for a, b_ in zip(cpu, sig.weights))
    assert sig.weights_on(torch.device("cpu")) is sig.weights
    moved = sig.weights_on(torch.device("meta"))
    assert moved is sig.weights_on(torch.device("meta")) and moved[0].device.type == "meta"
    forest = carry(_ref("rf-regressor")).serving_signature()
    assert forest.weights_dtype() == torch.float32  # the first floating leaf: thresholds
    leaves = tree_leaves(forest.weights)
    assert len(leaves) == len(Forest._fields)
    doubled = tree_map(lambda a: a, forest.weights)
    assert isinstance(doubled[0], Forest)
    assert tree_leaves({"b": 2, "a": (1, [3])}) == [1, 3, 2]
    assert spec((3, 2), torch.float32).device.type == "meta"


def test_logistic_fitted_in_float32_keeps_float64_host_weights():
    """A tensor fit in float32 serves tensors at float32 and host rows at
    float64, as ``predict`` does; the signature carries both pairs."""
    model = LogisticRegression().setMaxIter(10).fit((torch.from_numpy(X.astype(np.float32)), torch.from_numpy(Y)))
    sig = model.serving_signature()
    assert sig.weights[0].dtype == torch.float32
    assert sig.host_weights[0].dtype == torch.float64
    labels, probs, raw = sig.kernel(torch.from_numpy(X), *sig.host_weights, **sig.static)
    assert np.array_equal(labels.numpy(), model.predict(X))
    assert np.array_equal(probs.numpy(), model.predictProbability(X))
    assert _run(sig, torch.from_numpy(X))[1].dtype == torch.float32
    assert carry(_ref("logreg")).serving_signature().host_weights is None


def test_select_functions_are_module_level():
    assert carry(_ref("logreg")).serving_signature().select is port_logreg._select_labels
    assert carry(_ref("rf-classifier")).serving_signature().select is port_rf._select_argmax
    assert carry(_ref("rf-regressor")).serving_signature().kernel is port_rf._reg_kernel
    labels = torch.tensor([1, 0], dtype=torch.int32)
    assert port_logreg._select_labels((labels, None, None)) is labels
    probs = torch.tensor([[0.2, 0.8], [0.9, 0.1]])
    assert torch.equal(port_rf._select_argmax(probs), port_rf._select_argmax((probs,)))


def test_unfitted_models_raise_as_the_reference():
    with pytest.raises(RuntimeError, match="no fitted forest"):
        RandomForestClassificationModel().serving_signature()
    with pytest.raises(RuntimeError, match="no coefficients"):
        LinearRegressionModel().serving_signature()


def test_runtime_names_resolve_and_the_hooks_take_the_model():
    """The in-process runtime and the distributed tier resolve from the
    package, and the device-cache hooks take the model, as the
    reference's."""
    import spark_rapids_ml_tpu_torch.serving as serving
    from spark_rapids_ml_tpu_torch.serving import router, server

    for name in ("ServingRuntime", "ModelRegistry", "MicroBatcher", "RoutingRuntime", "ElasticScaler"):
        assert getattr(serving, name).__name__ == name
    assert serving.ServingRuntime is server.ServingRuntime
    assert serving.router_snapshots is router.router_snapshots
    with pytest.raises(AttributeError):
        serving.no_such_name  # noqa: B018
    with pytest.raises(TypeError):
        core_serving.invalidate_device_caches()  # the model is required
    model = LinearRegressionModel("hooks", np.arange(3.0), 0.5)
    model.predict(np.ones((2, 3)))
    assert model._coef_dev
    assert core_serving.invalidate_device_caches(model) == 1
    assert model._coef_dev is None
    core_serving.note_device_cache(model)
