"""The port's logistic-regression slice against the JAX package.

``ops/lbfgs`` (the counterpart of the ``optax.lbfgs()`` call), ``ops/logistic``
(the fused objective as a ``torch.autograd.Function``, L-BFGS, FISTA, the
streaming fit, prediction, metrics) and the ``LogisticRegression``
estimator and model: the same seeded numpy inputs go through both packages,
the JAX side with x64 on as tier-1 runs it. Tolerances:

- ``ops/lbfgs`` against ``optax.lbfgs`` driven by the reference's loop on
  test functions: iterates 1e-8, equal objective evaluations;
- ``fit_logistic`` with ``tol=0`` and ``maxIter`` 1–5: weights within 1e-8;
  converged fits (tol 1e-10): weights 1e-7 with equal ``numIter``;
- ``fit_logistic_elastic_net`` with JAX's start vector: 1e-10, equal
  ``n_iter``; ``fit_logistic_streaming``: 1e-10, equal ``nit``;
- ``predict_logistic``: labels exact, probabilities 1e-12;
- error paths raise the reference's exception types.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.classification import LogisticRegressionModel as JaxLRModel
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.core.data import HostArrayBlockReader as JaxReader
from spark_rapids_ml_tpu.ops import logistic as jax_logistic
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.classification import LogisticRegression, LogisticRegressionModel
from spark_rapids_ml_tpu_torch.core.data import DataFrame, HostArrayBlockReader
from spark_rapids_ml_tpu_torch.interop import logistic_regression_model_from_numpy
from spark_rapids_ml_tpu_torch.ops import lbfgs, logistic
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

N, D = 300, 5


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _data(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)) * rng.uniform(0.5, 3.0, size=D) + rng.uniform(-1, 1, size=D)
    margin = (x - x.mean(0)) / x.std(0) @ rng.standard_normal(D) + 0.7 * rng.standard_normal(N)
    y2 = (margin > 0).astype(np.int64)
    y3 = np.digitize(margin, [-0.6, 0.6]).astype(np.int64)
    return x, y2, y3


X, Y2, Y3 = _data()
W = np.random.default_rng(7).uniform(0.2, 2.0, size=N)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(name, got, want, tol):
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert_close(name, got, want, rtol=0, atol=tol * scale)


# --- ops/lbfgs against optax ------------------------------------------------------


def _rosenbrock(np_mod):
    def f(x):
        return np_mod.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    return f


def _quadratic(np_mod):
    a = np.diag(np.linspace(1.0, 120.0, 5)) + 0.3
    def f(x):
        return 0.5 * x @ (a @ x) - np_mod.sum(x) + np_mod.sum(x ** 4) * 0.01
    return f


def _softplus_sum(np_mod):
    m = np.random.default_rng(2).standard_normal((8, 5))
    def f(x):
        z = m @ x
        return np_mod.sum(np_mod.logaddexp(z, 0.0) - 0.3 * z) + 0.05 * np_mod.sum(x * x)
    return f


FUNCS = {"rosenbrock": _rosenbrock, "quadratic": _quadratic, "softplus": _softplus_sum}


_OPTAX_STEPS = {}


def _optax_run(func, x0, iters):
    """The reference's loop (``ops/logistic.py:305-318``) around
    ``optax.lbfgs()``: returns the iterate and the evaluation count. One
    compiled step per test function."""
    solver = optax.lbfgs()
    if func not in _OPTAX_STEPS:
        fn = FUNCS[func](jnp)
        vg = optax.value_and_grad_from_state(fn)

        @jax.jit
        def step(params, state):
            value, grad = vg(params, state=state)
            updates, state = solver.update(grad, state, params, value=value, grad=grad, value_fn=fn)
            return optax.apply_updates(params, updates), state

        _OPTAX_STEPS[func] = step
    step = _OPTAX_STEPS[func]
    params, state = jnp.asarray(x0), solver.init(jnp.asarray(x0))
    evals = 1
    for _ in range(iters):
        params, state = step(params, state)
        evals += int(optax.tree_utils.tree_get(state, "num_linesearch_steps"))
    return np.asarray(params), evals


@pytest.mark.parametrize("iters", [3, 15])
@pytest.mark.parametrize("func", list(FUNCS))
def test_lbfgs_matches_optax(func, iters):
    jfn = FUNCS[func](jnp)
    grad = jax.jit(jax.value_and_grad(jfn))

    def value_and_grad(theta):
        v, g = grad(jnp.asarray(theta))
        return float(v), np.asarray(g, dtype=np.float64)

    x0 = np.linspace(-1.2, 0.8, 5)
    got = lbfgs.minimize(value_and_grad, x0, max_iter=iters, tol=0.0)
    want, want_evals = _optax_run(func, x0, iters)
    assert got.n_iter == iters
    assert got.n_evals == want_evals
    _close(f"{func} iterate", got.params, want, 1e-8)


def test_lbfgs_stops_on_the_previous_gradient_norm():
    f = _quadratic(np)

    def value_and_grad(theta):
        a = np.diag(np.linspace(1.0, 120.0, 5)) + 0.3
        return float(f(theta)), a @ theta - 1.0 + 0.04 * theta ** 3

    res = lbfgs.minimize(value_and_grad, np.zeros(5), max_iter=500, tol=1e-9)
    assert res.n_iter < 500
    assert np.linalg.norm(value_and_grad(res.params)[1]) <= 1e-9
    assert lbfgs.minimize(value_and_grad, np.zeros(5), max_iter=0, tol=0.0).n_iter == 0


def test_interpolation_steps_match_optax():
    from optax._src import linesearch as ols

    for args in [(0.0, 1.0, -2.0, 1.0, 0.5, 0.4, 0.7), (0.1, 2.0, -1.0, 0.7, 1.9, 0.3, 1.5),
                 (0.0, 1.0, -1.0, 0.0, 1.0, 0.0, 1.0)]:
        with np.errstate(all="ignore"):
            got = lbfgs._cubicmin(*(np.float64(a) for a in args))
        want = float(ols._cubicmin(*(jnp.float64(a) for a in args)))
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= 1e-12 * max(1.0, abs(want))
    for args in [(0.0, 1.0, -2.0, 1.0, 0.5), (0.2, 3.0, -0.5, 1.1, 2.9)]:
        assert abs(lbfgs._quadmin(*(np.float64(a) for a in args))
                   - float(ols._quadmin(*(jnp.float64(a) for a in args)))) <= 1e-12


# --- ops/logistic: L-BFGS fits ------------------------------------------------------


_REF = {}


def _ref_fit(key, y, n_classes, **kw):
    if key not in _REF:
        _REF[key] = jax_logistic.fit_logistic(
            jnp.asarray(X), jnp.asarray(y, dtype=jnp.int32), jnp.asarray(kw.pop("mask", np.ones(N))),
            n_classes, **kw)
    return _REF[key]


def _port_fit(y, n_classes, **kw):
    mask = kw.pop("mask", np.ones(N))
    return logistic.fit_logistic(_t(X), _t(y), _t(mask), n_classes, **kw)


@pytest.mark.parametrize("max_iter", [1, 2, 3, 4, 5])
def test_fixed_iterations_match_jax(max_iter):
    kw = dict(reg_param=0.01, max_iter=max_iter, tol=0.0)
    got = _port_fit(Y2, 2, **kw)
    want = _ref_fit(("tol0", max_iter), Y2, 2, **kw)
    assert got.n_iter == int(want.n_iter) == max_iter
    _close("weights", got.weights, want.weights, 1e-8)
    _close("intercepts", got.intercepts, want.intercepts, 1e-8)


@pytest.mark.parametrize("max_iter", [1, 3])
def test_fixed_multinomial_iterations_match_jax(max_iter):
    kw = dict(reg_param=0.0, max_iter=max_iter, tol=0.0)
    got = _port_fit(Y3, 3, **kw)
    want = _ref_fit(("tol0_multi", max_iter), Y3, 3, **kw)
    _close("weights", got.weights, want.weights, 1e-8)


CONVERGED = {
    "binomial": (Y2, 2, dict(reg_param=0.01)),
    "binomial_unregularized": (Y2, 2, dict(reg_param=0.0)),
    "multinomial": (Y3, 3, dict(reg_param=0.0)),
    "multinomial_regularized": (Y3, 3, dict(reg_param=0.05)),
    "multinomial_two_classes": (Y2, 2, dict(reg_param=0.1, multinomial=True)),
    "no_intercept": (Y2, 2, dict(reg_param=0.01, fit_intercept=False)),
    "no_standardization": (Y2, 2, dict(reg_param=0.01, standardization=False)),
    "weighted": (Y2, 2, dict(reg_param=0.01, mask=W)),
    "unfused": (Y2, 2, dict(reg_param=0.01, fused=False)),
    "warm_start": (Y2, 2, dict(reg_param=0.01, init_w=np.full((D, 1), 0.2), init_b=np.array([-0.3]))),
}


@pytest.mark.parametrize("case", list(CONVERGED))
def test_converged_fits_match_jax_with_equal_iterations(case):
    y, k, kw = CONVERGED[case]
    kw = dict(kw, max_iter=100, tol=1e-10)
    got = _port_fit(y, k, **dict(kw))
    want = _ref_fit(("conv", case), y, k, **dict(kw))
    assert got.n_iter == int(want.n_iter)
    _close("weights", got.weights, want.weights, 1e-7)
    _close("intercepts", got.intercepts, want.intercepts, 1e-7)
    _close("loss", got.loss, want.loss, 1e-10)


def test_fused_and_plain_objectives_agree_and_blocks_only_reorder_sums():
    kw = dict(reg_param=0.01, max_iter=100, tol=1e-10)
    fused = _port_fit(Y3, 3, **kw)
    plain = _port_fit(Y3, 3, fused=False, **kw)
    assert fused.n_iter == plain.n_iter
    _close("plain", plain.weights, fused.weights, 1e-10)
    mask = torch.ones(N, dtype=torch.float64)
    offset, scale = logistic._standardizer(_t(X), mask, True, True)
    args = (_t(X), logistic._targets(_t(Y3), 3, torch.float64), mask, offset, scale, mask.sum(), 0.01, 3, True,
            torch.matmul)
    w = torch.linspace(-0.5, 0.5, D * 3, dtype=torch.float64).reshape(D, 3)
    b = torch.zeros(3, dtype=torch.float64)
    whole = logistic.LogisticLoss(*args).value_and_grad(w, b)
    blocked = logistic.LogisticLoss(*args, block_rows=37).value_and_grad(w, b)  # 8 full blocks, a short one
    _close("blocked value", blocked[0], whole[0], 1e-13)
    _close("blocked gradient", blocked[1][0], whole[1][0], 1e-13)


@pytest.mark.parametrize("c", [1, 3])
def test_fused_function_differentiates_like_autograd(c):
    y = Y2 if c == 1 else Y3
    mask = _t(W)
    offset, scale = logistic._standardizer(_t(X), mask, True, True)
    args = (_t(X), logistic._targets(_t(y), c, torch.float64), mask, offset, scale, mask.sum(), 0.1, c, True,
            torch.matmul)
    fused = logistic.LogisticLoss(*args, fused=True, block_rows=64)
    plain = logistic.LogisticLoss(*args, fused=False)
    w = torch.linspace(-0.5, 0.5, D * c, dtype=torch.float64).reshape(D, c).requires_grad_()
    b = torch.linspace(-0.2, 0.2, c, dtype=torch.float64).requires_grad_()
    (2.5 * fused(w, b)).backward()
    gw, gb = w.grad.clone(), b.grad.clone()
    w.grad, b.grad = None, None
    (2.5 * plain(w, b)).backward()
    _close("dw", gw, w.grad, 1e-12)
    _close("db", gb, b.grad, 1e-12)
    value, (vw, vb) = fused.value_and_grad(w.detach(), b.detach())
    _close("value", value, plain(w, b).detach(), 1e-12)
    _close("value_and_grad dw", 2.5 * vw, gw, 1e-12)


def test_softplus_is_exact_where_torch_switches_to_identity():
    z = np.array([-60.0, -5.0, 0.0, 3.0, 19.0, 20.5, 25.0, 36.0, 60.0])
    got = logistic.softplus(_t(z)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    assert torch.nn.functional.softplus(_t(z))[6].item() != got[6]  # torch's identity branch differs


# --- ops/logistic: FISTA and streaming -----------------------------------------------


def _jax_v0(d=D):
    return np.asarray(jax.random.normal(jax.random.key(0), (d,), dtype=jnp.float64))


ENET = {
    "binomial": (Y2, 2, dict(reg_param=0.05, elastic_net_param=0.5)),
    "multinomial": (Y3, 3, dict(reg_param=0.02, elastic_net_param=0.8)),
    "no_standardization": (Y2, 2, dict(reg_param=0.05, elastic_net_param=1.0, standardization=False)),
    "unfused_no_intercept": (Y2, 2, dict(reg_param=0.05, elastic_net_param=0.5, fused=False,
                                         fit_intercept=False)),
}


@pytest.mark.parametrize("case", list(ENET))
def test_elastic_net_matches_jax_with_its_start_vector(case):
    y, k, kw = ENET[case]
    want = jax_logistic.fit_logistic_elastic_net(jnp.asarray(X), jnp.asarray(y, dtype=jnp.int32),
                                                 jnp.ones(N), k, **kw)
    got = logistic.fit_logistic_elastic_net(_t(X), _t(y), torch.ones(N, dtype=torch.float64), k,
                                            v0=_t(_jax_v0()), **kw)
    assert got.n_iter == int(want.n_iter)
    _close("weights", got.weights, want.weights, 1e-10)
    _close("intercepts", got.intercepts, want.intercepts, 1e-10)
    _close("loss", got.loss, want.loss, 1e-10)


def test_default_start_vector_is_a_seeded_float64_draw():
    v = logistic.default_start_vector(D, torch.float32, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    want = torch.randn(D, generator=gen, dtype=torch.float64).float()
    assert torch.equal(v, want)
    a = logistic.fit_logistic_elastic_net(_t(X), _t(Y2), torch.ones(N, dtype=torch.float64), 2, 0.05, 0.5)
    b = logistic.fit_logistic_elastic_net(_t(X), _t(Y2), torch.ones(N, dtype=torch.float64), 2, 0.05, 0.5,
                                          v0=_t(_jax_v0()))
    _close("any start converges to one optimum", a.weights, b.weights, 1e-5)


def _pairs(y, rows=70):
    return [(X[i:i + rows], y[i:i + rows]) for i in range(0, N, rows)]


STREAM = {
    "binomial": (Y2, 2, dict(reg_param=0.01)),
    "multinomial": (Y3, 3, dict(reg_param=0.0)),
    "no_intercept_unfused": (Y2, 2, dict(reg_param=0.01, fit_intercept=False, fused=False)),
}


@pytest.mark.parametrize("case", list(STREAM))
def test_streaming_fit_matches_jax(case):
    y, k, kw = STREAM[case]
    pairs = _pairs(y)
    n, mean, sigma, y_max, ok = logistic.streaming_label_feature_stats(iter(pairs))
    want_stats = jax_logistic.streaming_label_feature_stats(iter(pairs))
    assert (n, y_max, ok) == (want_stats[0], want_stats[3], want_stats[4])
    _close("mean", mean, want_stats[1], 1e-12)
    _close("sigma", sigma, want_stats[2], 1e-12)
    kw = dict(kw, max_iter=100, tol=1e-10)
    got = logistic.fit_logistic_streaming(lambda: iter(pairs), k, n, mean, sigma, **kw)
    want = jax_logistic.fit_logistic_streaming(lambda: iter(pairs), k, n, mean, sigma, **kw)
    assert got.n_iter == int(want.n_iter)
    _close("weights", got.weights, want.weights, 1e-10)
    _close("loss", got.loss, want.loss, 1e-10)


# --- prediction and metrics ------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 3])
def test_predict_logistic_matches_jax(c):
    rng = np.random.default_rng(11)
    w, b = rng.standard_normal((D, c)), rng.standard_normal(c)
    got = logistic.predict_logistic(_t(X), _t(w), _t(b), max(2, c))
    want = jax_logistic.predict_logistic(jnp.asarray(X), jnp.asarray(w), jnp.asarray(b), max(2, c))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    _close("probabilities", got[1], want[1], 1e-12)
    _close("raw", got[2], want[2], 1e-12)


def test_classification_metrics_match_jax():
    pred = (Y2 + (np.arange(N) % 7 == 0)) % 2
    mask = np.ones(N)
    mask[:5] = 0
    got = logistic.classification_metrics(_t(Y2), _t(pred), _t(mask))
    want = jax_logistic.classification_metrics(jnp.asarray(Y2), jnp.asarray(pred), jnp.asarray(mask))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-15


# --- the estimator and model -------------------------------------------------------------


def _configure(est, **params):
    for name, value in params.items():
        est.set(est.getParam(name), value)
    return est


_EST = {}


def _jax_est(key, data, **params):
    if key not in _EST:
        _EST[key] = _configure(JaxLR(), **params).fit(data)
    return _EST[key]


EST_CASES = {
    "binomial": (lambda: (X, Y2.astype(float)), dict(regParam=0.01, tol=1e-10)),
    "multinomial": (lambda: (X, Y3.astype(float)), dict(tol=1e-10)),
    "multinomial_family": (lambda: (X, Y2.astype(float)), dict(family="multinomial", regParam=0.1, tol=1e-10)),
    "elastic_net": (lambda: (X, Y2.astype(float)), dict(regParam=0.05, elasticNetParam=0.5)),
    "max_iter_3": (lambda: (X, Y2.astype(float)), dict(maxIter=3, tol=0.0)),
}


@pytest.mark.parametrize("case", list(EST_CASES))
def test_estimator_matches_jax(case):
    data, params = EST_CASES[case]
    model = _configure(LogisticRegression(), **params).fit(data())
    want = _jax_est(case, data(), **params)
    tol = 1e-5 if case == "elastic_net" else 1e-7  # FISTA from another start vector: to its tol
    assert model.numClasses == want.numClasses
    if case != "elastic_net":
        assert model.numIter == want.numIter
    _close("weights", model.weights, want.weights, tol)
    _close("intercepts", model.intercepts, want.intercepts, tol)
    np.testing.assert_array_equal(model.predict(X), want.predict(X))
    _close("probabilities", model.predictProbability(X), want.predictProbability(X), max(tol, 1e-12) * 10)


@pytest.mark.parametrize("route", ["factory", "reader"])
def test_streaming_estimator_matches_jax(route):
    blocks = [X[i:i + 64] for i in range(0, N, 64)]
    src = {"factory": lambda: iter(blocks), "reader": HostArrayBlockReader(X, block_rows=64)}[route]
    jsrc = {"factory": lambda: iter(blocks), "reader": JaxReader(X, block_rows=64)}[route]
    model = LogisticRegression().setRegParam(0.01).setTol(1e-10).fit((src, Y2.astype(float)))
    want = JaxLR().setRegParam(0.01).setTol(1e-10).fit((jsrc, Y2.astype(float)))
    assert model.numIter == want.numIter
    _close("weights", model.weights, want.weights, 1e-10)


def test_weight_col_matches_jax():
    df = DataFrame({"features": list(X), "label": list(Y3.astype(float)), "w": list(W)})
    jdf = JaxDataFrame({"features": list(X), "label": list(Y3.astype(float)), "w": list(W)})
    model = LogisticRegression().setWeightCol("w").setTol(1e-10).fit(df)
    want = JaxLR().setWeightCol("w").setTol(1e-10).fit(jdf)
    assert model.numIter == want.numIter
    _close("weights", model.weights, want.weights, 1e-7)


def test_warm_start_matches_jax():
    start = _jax_est("binomial", (X, Y2.astype(float)), **EST_CASES["binomial"][1])
    carried = logistic_regression_model_from_numpy(start.weights, start.intercepts, 2)
    model = LogisticRegression().setRegParam(0.02).setTol(1e-10).setInitialModel(carried).fit((X, Y2.astype(float)))
    want = JaxLR().setRegParam(0.02).setTol(1e-10).setInitialModel(start).fit((X, Y2.astype(float)))
    assert model.numIter == want.numIter
    _close("weights", model.weights, want.weights, 1e-7)


def test_tensor_fit_and_predict_stay_where_they_live():
    model = LogisticRegression().setRegParam(0.01).setTol(1e-10).fit((_t(X), _t(Y2)))
    assert isinstance(model._w_raw, torch.Tensor)
    labels = model.predict(_t(X))
    assert isinstance(labels, torch.Tensor) and labels.dtype == torch.int32
    want = _jax_est("binomial", (X, Y2.astype(float)), **EST_CASES["binomial"][1])
    np.testing.assert_array_equal(labels.numpy(), want.predict(X))
    f32 = LogisticRegression().setRegParam(0.01).fit((_t(X).float(), _t(Y2)))
    assert f32._w_raw.dtype == torch.float32
    _close("float32 fit", f32.weights, want.weights, 1e-3)


@pytest.fixture(scope="module")
def binomial():
    port_device.set_platform("cpu")
    model = LogisticRegression().setRegParam(0.01).setTol(1e-10).fit((X, Y2.astype(float)))
    port_device.set_platform("cuda")
    return model, _jax_est("binomial", (X, Y2.astype(float)), **EST_CASES["binomial"][1])


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.8])
def test_threshold_matches_jax(binomial, threshold):
    model, want = binomial
    model = model.copy().setThreshold(threshold)
    want = want.copy().setThreshold(threshold)
    np.testing.assert_array_equal(model.predict(X), want.predict(X))


def test_accessors_and_raw_margins_match_jax(binomial):
    model, want = binomial
    _close("coefficients", model.coefficients, want.coefficients, 1e-7)
    assert abs(model.intercept - want.intercept) <= 1e-7 * max(1.0, abs(want.intercept))
    assert model.coefficientMatrix.shape == (1, D) and model.interceptVector.shape == (1,)
    _close("raw", model.predictRaw(X), want.predictRaw(X), 1e-6)
    multi = LogisticRegression().fit((X, Y3.astype(float)))
    with pytest.raises(AttributeError):
        multi.coefficients
    with pytest.raises(AttributeError):
        multi.intercept


def test_transform_and_evaluate_match_jax(binomial):
    model, want = binomial
    df = DataFrame({"features": list(X[:30])})
    jdf = JaxDataFrame({"features": list(X[:30])})
    got, exp = model.transform(df), want.transform(jdf)
    np.testing.assert_array_equal(np.asarray(got.select("prediction")), np.asarray(exp.select("prediction")))
    _close("probability column", np.stack(got.select("probability")), np.stack(exp.select("probability")), 1e-6)
    pdf = pd.DataFrame({f"f{i}": X[:30, i] for i in range(D)})
    np.testing.assert_array_equal(model.transform(pdf)["prediction"].to_numpy(),
                                  want.transform(pdf)["prediction"].to_numpy())
    np.testing.assert_array_equal(model.transform(X[:30]), want.transform(X[:30]))
    assert model.evaluate((X, Y2.astype(float))) == want.evaluate((X, Y2.astype(float)))


def test_copy_and_pickle_keep_fitted_state(binomial):
    model, _ = binomial
    back = pickle.loads(pickle.dumps(model))
    np.testing.assert_array_equal(back.weights, model.weights)
    assert back.numIter == model.numIter and back.getRegParam() == 0.01


@pytest.mark.parametrize("labels", ["binomial", "multinomial"])
def test_saved_by_either_package_loads_in_the_other(labels, tmp_path):
    y = Y2 if labels == "binomial" else Y3
    model = LogisticRegression().setRegParam(0.01).setMaxIter(30).fit((X, y.astype(float)))
    model.write.overwrite().save(str(tmp_path / "port"))
    back = JaxLRModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.weights, model.weights)
    assert (back.numClasses, back.numIter, back.getRegParam()) == (model.numClasses, model.numIter, 0.01)
    back.write.overwrite().save(str(tmp_path / "jax"))
    again = LogisticRegressionModel.load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(again.weights, model.weights)
    np.testing.assert_array_equal(again.predict(X), back.predict(X))
    _close("loaded probabilities", again.predictProbability(X), back.predictProbability(X), 1e-12)


@pytest.mark.parametrize("labels", ["binomial", "multinomial"])
def test_interop_carries_a_jax_model(labels):
    y = Y2 if labels == "binomial" else Y3
    want = _jax_est(("interop", labels), (X, y.astype(float)), regParam=0.01, maxIter=30)
    params = {p.name: v for p, v in want.extractParamMap().items()}
    model = logistic_regression_model_from_numpy(want.weights, want.intercepts, want.numClasses,
                                                 uid=want.uid, params=params, num_iter=want.numIter)
    assert (model.uid, model.numIter, model.getRegParam()) == (want.uid, want.numIter, 0.01)
    np.testing.assert_array_equal(model.predict(X), want.predict(X))
    _close("probabilities", model.predictProbability(X), want.predictProbability(X), 1e-12)
    with pytest.raises(ValueError, match="weights must be"):
        logistic_regression_model_from_numpy(np.ones((D, 2)), np.ones(3), 3)


# --- error paths --------------------------------------------------------------------------


def _both(build):
    errors = []
    for cls in (JaxLR, LogisticRegression):
        with pytest.raises(Exception) as info:
            build(cls)
        errors.append((type(info.value), str(info.value)))
    assert errors[0][0] is errors[1][0], errors
    return errors


_gen = lambda: (X[i:i + 50] for i in range(0, N, 50))  # noqa: E731
ERROR_CASES = {
    "binomial_with_three_labels": lambda c: c().setFamily("binomial").fit((X, Y3.astype(float))),
    "fractional_labels": lambda c: c().fit((X, Y2 + 0.5)),
    "negative_labels": lambda c: c().fit((X, Y2 - 1.0)),
    "bad_family": lambda c: c().setFamily("poisson"),
    "negative_reg": lambda c: c().setRegParam(-0.1),
    "enet_out_of_range": lambda c: c().setElasticNetParam(-0.5),
    "bad_precision": lambda c: c().setPrecision("fp8"),
    "warm_start_with_l1": lambda c: c().setRegParam(0.1).setElasticNetParam(0.5).setInitialModel(
        JaxLRModel("m", np.zeros((D, 1)), np.zeros(1))).fit((X, Y2.astype(float))),
    "warm_start_wrong_shape": lambda c: c().setInitialModel(
        JaxLRModel("m", np.zeros((D + 1, 1)), np.zeros(1))).fit((X, Y2.astype(float))),
    "warm_start_not_a_model": lambda c: c().setInitialModel(JaxLRModel("m", np.zeros(D), np.zeros(1))),
    "stream_one_shot_generator": lambda c: c().fit((_gen(), Y2.astype(float))),
    "stream_weight_col": lambda c: c().setWeightCol("w").fit((lambda: _gen(), Y2.astype(float))),
    "stream_elastic_net": lambda c: c().setRegParam(0.1).setElasticNetParam(0.5).fit(
        (lambda: _gen(), Y2.astype(float))),
    "stream_fractional_labels": lambda c: c().fit((lambda: _gen(), Y2 + 0.5)),
    "labels_too_short": lambda c: c().fit((X, Y2[:-1].astype(float))),
    "bad_dataset": lambda c: c().fit(X),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_paths_raise_the_reference_types(case):
    _both(ERROR_CASES[case])


def test_routes_of_later_slices_raise_naming_their_item(binomial):
    # The mesh (A.9, 9d) arrived with the distribution slice.
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    np.testing.assert_allclose(LogisticRegression(mesh=mesh).fit((X, Y2)).weights,
                               LogisticRegression().fit((X, Y2)).weights, rtol=0, atol=1e-10)
    # The serving signature arrived with the composition slice.
    assert binomial[0].serving_signature().name == "logreg.predict"


def test_params_surface_matches_jax():
    port, ref = LogisticRegression(), JaxLR()
    assert {p.name for p in ref.params} - {p.name for p in port.params} <= {"deployMode"}
    for p in port.params:
        if ref.hasParam(p.name) and ref.hasDefault(ref.getParam(p.name)):
            assert port.getOrDefault(p) == ref.getOrDefault(ref.getParam(p.name)), p.name
