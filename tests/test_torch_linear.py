"""The port's linear-regression slice against the JAX package.

``ops/linalg.soft_threshold``, the label helpers of ``core/ingest``,
``ops/linear`` (statistics, normal-equation solve with its eigh fallback,
FISTA, the host float64 solve, the streaming statistics) and the
``LinearRegression`` estimator and model: the same seeded numpy inputs go
through both packages, the JAX side with x64 on as tier-1 runs it.
Tolerances:

- ``ops/linear`` and every estimator route: 1e-10 relative (coefficients
  and intercept), FISTA with equal ``n_iter``;
- the fits against ``numpy.linalg.lstsq``: 1e-8;
- the port's ``dd`` (native float64) against the JAX package's ``highest``
  fit: 1e-10, and against the JAX ``dd`` emulation: 1e-5 (the emulation
  lands ~4e-7 from float64, ROADMAP "Differences that hold by design");
- error paths raise the reference's exception types.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.core import ingest as jax_ingest
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.core.data import HostArrayBlockReader as JaxReader
from spark_rapids_ml_tpu.ops import linalg as jax_linalg
from spark_rapids_ml_tpu.ops import linear as jax_linear
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLR
from spark_rapids_ml_tpu.regression import LinearRegressionModel as JaxLRModel
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.core import ingest
from spark_rapids_ml_tpu_torch.core.data import DataFrame, HostArrayBlockReader
from spark_rapids_ml_tpu_torch.interop import linear_regression_model_from_numpy
from spark_rapids_ml_tpu_torch.ops import linalg, linear
from spark_rapids_ml_tpu_torch.regression import LinearRegression, LinearRegressionModel
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

TOL = 1e-10
LSTSQ_TOL = 1e-8
N, D = 240, 6


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _xy(seed: int = 0, n: int = N, d: int = D, noise: float = 0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * rng.uniform(0.3, 4.0, size=d) + rng.uniform(-2, 2, size=d)
    y = x @ rng.standard_normal(d) + 1.5 + noise * rng.standard_normal(n)
    return x, y


X, Y = _xy()
W = np.random.default_rng(5).uniform(0.2, 2.0, size=N)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(name, got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    assert_close(name, got, want, rtol=0, atol=tol * scale)


# --- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("t", [0.0, 0.4, 3.0])
def test_soft_threshold_matches_jax(t):
    v = np.linspace(-3, 3, 13)
    _close("soft_threshold", linalg.soft_threshold(_t(v), t), jax_linalg.soft_threshold(jnp.asarray(v), t))


@pytest.mark.parametrize("mask", ["none", "ones", "weights"])
def test_normal_eq_stats_matches_jax(mask):
    m = {"none": None, "ones": np.ones(N), "weights": W}[mask]
    got = linear.normal_eq_stats(_t(X), _t(Y), None if m is None else _t(m))
    want = jax_linear.normal_eq_stats(jnp.asarray(X), jnp.asarray(Y), None if m is None else jnp.asarray(m))
    for name, g, w in zip(("xtx", "xty", "x_sum", "y_sum", "yty", "count"), got, want):
        _close(name, g, w)


def _stats(x=X, y=Y):
    return linear.normal_eq_stats(_t(x), _t(y)), jax_linear.normal_eq_stats(jnp.asarray(x), jnp.asarray(y), None)


def _rank_deficient():
    x = X[:60, :4].copy()
    x = np.column_stack([x, x[:, 0]])  # a duplicated column: a singular Gram
    return x, x[:, 0] * 2.0 - x[:, 2]


def _zero_column():
    x = X[:60].copy()
    x[:, 2] = 0.0  # a zero pivot: the Cholesky fails in both packages
    return x, Y[:60]


SOLVE_CASES = {
    "ols": dict(),
    "ridge_std": dict(reg_param=0.3),
    "ridge_no_std": dict(reg_param=0.3, standardization=False),
    "no_intercept": dict(reg_param=0.1, fit_intercept=False),
}


@pytest.mark.parametrize("case", [*SOLVE_CASES, "zero_column"])
def test_solve_normal_matches_jax(case):
    kw = SOLVE_CASES.get(case, {})
    p, j = _stats(*_zero_column()) if case == "zero_column" else _stats()
    coef, b = linear.solve_normal(*p[:4], p[5], **kw)
    jcoef, jb = jax_linear.solve_normal(*j[:4], j[5], **kw)
    _close(f"{case} coef", coef, jcoef)
    _close(f"{case} intercept", b, jb)
    if case == "zero_column":  # the eigh minimum-norm branch: ~0 on the zero column
        assert abs(float(coef[2])) <= 1e-12 * float(coef.abs().max())


def test_solve_normal_on_a_duplicated_column_fits_as_jax_does():
    """A duplicated column leaves a line of exact solutions; whether a
    Cholesky of the rounded Gram succeeds (a ~1e-13 pivot of either sign)
    decides which point each package returns, so the two are held on what
    the data determines: the predictions and the duplicated pair's sum."""
    x, y = _rank_deficient()
    p, j = _stats(x, y)
    coef, b = linear.solve_normal(*p[:4], p[5])
    jcoef, jb = jax_linear.solve_normal(*j[:4], j[5])
    _close("predictions", x @ coef.numpy() + float(b), x @ np.asarray(jcoef) + float(jb))
    _close("predictions vs y", x @ coef.numpy() + float(b), y, 1e-9)
    _close("identified sum", coef[0] + coef[4], jcoef[0] + jcoef[4])
    _close("other coefficients", coef[1:4], jcoef[1:4])


ENET_CASES = {
    "std": dict(reg_param=0.2, elastic_net_param=0.5),
    "no_std": dict(reg_param=0.2, elastic_net_param=0.7, standardization=False),
    "no_intercept": dict(reg_param=0.1, elastic_net_param=1.0, fit_intercept=False),
    "warm_start": dict(reg_param=0.2, elastic_net_param=0.5, init_coef=np.full(D, 0.25)),
}


@pytest.mark.parametrize("case", list(ENET_CASES))
def test_solve_elastic_net_matches_jax_with_equal_iterations(case):
    kw = ENET_CASES[case]
    p, j = _stats()
    coef, b, it = linear.solve_elastic_net(*p[:4], p[5], **kw)
    jcoef, jb, jit = jax_linear.solve_elastic_net(*j[:4], j[5], **kw)
    assert it == int(jit)
    _close(f"{case} coef", coef, jcoef)
    _close(f"{case} intercept", b, jb)


@pytest.mark.parametrize("case", [*SOLVE_CASES, "zero_column"])
def test_solve_normal_host_matches_jax(case):
    kw = SOLVE_CASES.get(case, {})
    p, j = _stats(*_zero_column()) if case == "zero_column" else _stats()
    coef, b = linear.solve_normal_host(*p[:4], p[5], **kw)
    jcoef, jb = jax_linear.solve_normal_host(*(np.asarray(v) for v in j[:4]), float(j[5]), **kw)
    _close(f"{case} coef", coef, jcoef)
    _close(f"{case} intercept", b, jb)


def test_normal_eq_stats_streaming_matches_jax():
    blocks = [(X[:100], Y[:100]), (np.zeros((0, 0)), np.zeros(0)), (X[100:], Y[100:])]
    got = linear.normal_eq_stats_streaming(iter(blocks))
    want = jax_linear.normal_eq_stats_streaming(iter(blocks))
    for name, g, w in zip(("xtx", "xty", "x_sum", "y_sum", "yty", "count"), got, want):
        _close(name, g, w)


@pytest.mark.parametrize("bad", ["dims", "rows", "empty"])
def test_normal_eq_stats_streaming_errors_match_jax(bad):
    blocks = {
        "dims": [(X[:10], Y[:10]), (X[10:20, :3], Y[10:20])],
        "rows": [(X[:10], Y[:9])],
        "empty": [],
    }[bad]
    with pytest.raises(ValueError) as want:
        jax_linear.normal_eq_stats_streaming(iter(blocks))
    with pytest.raises(ValueError) as got:
        linear.normal_eq_stats_streaming(iter(blocks))
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


def test_predict_linear_and_regression_metrics_match_jax():
    coef = np.linspace(-1, 1, D)
    pred = linear.predict_linear(_t(X), _t(coef), 0.5)
    jpred = jax_linear.predict_linear(jnp.asarray(X), jnp.asarray(coef), 0.5)
    _close("predict", pred, jpred)
    mask = np.ones(N)
    mask[:7] = 0.0
    for name, g, w in zip(("mse", "rmse", "mae", "r2"),
                          linear.regression_metrics(_t(Y), pred, _t(mask)),
                          jax_linear.regression_metrics(jnp.asarray(Y), jpred, jnp.asarray(mask))):
        _close(name, g, w)


# --- core/ingest label helpers -------------------------------------------------


@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_prepare_labels_matches_jax(kind):
    y = np.arange(5, dtype=np.float64)
    arg = _t(y) if kind == "tensor" else y
    jarg = jnp.asarray(y) if kind == "tensor" else y
    got = ingest.prepare_labels(arg, 7, n_true=5, dtype=torch.float64)
    want = jax_ingest.prepare_labels(jarg, 7, n_true=5, dtype=jnp.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="label vector has 5 entries but the data has 6 rows"):
        ingest.prepare_labels(arg, 6, n_true=6, dtype=torch.float64)
    with pytest.raises(ValueError, match="label vector has 5 entries but the data has 6 rows"):
        jax_ingest.prepare_labels(jarg, 6, n_true=6, dtype=jnp.float64)


@pytest.mark.parametrize("labels", [[0, 2, 1, 2], [0.0, 1.0, 1.0], [0.5, 1.0], [-1, 0, 1]])
@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_validate_int_labels_matches_jax(labels, kind):
    y = np.asarray(labels)
    arg = _t(y) if kind == "tensor" else y
    jarg = jnp.asarray(y) if kind == "tensor" else y
    try:
        want_y, want_c = jax_ingest.validate_int_labels(jarg)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("[", r"\[").replace(")", r"\)")):
            ingest.validate_int_labels(arg)
        return
    got_y, got_c = ingest.validate_int_labels(arg)
    assert got_c == want_c
    np.testing.assert_array_equal(np.asarray(got_y), np.asarray(want_y))
    assert isinstance(got_y, torch.Tensor) == (kind == "tensor")


def test_to_host_f64():
    got = ingest.to_host_f64(torch.arange(3, dtype=torch.float32))
    assert got.dtype == np.float64 and got.tolist() == [0.0, 1.0, 2.0]


# --- the estimator -------------------------------------------------------------


def _configure(est, **params):
    for name, value in params.items():
        est.set(est.getParam(name), value)
    return est


_JAX_FITS = {}


def _jax_fit(key, **params):
    """One JAX fit per configuration for the whole module."""
    if key not in _JAX_FITS:
        _JAX_FITS[key] = _configure(JaxLR(), **params).fit((X, Y))
    return _JAX_FITS[key]


def _lstsq(x=X, y=Y):
    a = np.column_stack([x, np.ones(len(y))])
    return np.linalg.lstsq(a, y, rcond=None)[0]


def _routes():
    blocks = [X[i:i + 50] for i in range(0, N, 50)]
    return {
        "array": lambda: (X, Y),
        "list_of_rows": lambda: (list(X), list(Y)),
        "list_of_blocks": lambda: (blocks, Y),
        "per_block_labels": lambda: (blocks, [Y[i:i + 50] for i in range(0, N, 50)]),
        "generator": lambda: (iter(blocks), Y),
        "factory": lambda: (lambda: iter(blocks), Y),
        "reader": lambda: (HostArrayBlockReader(X, block_rows=64), Y),
        "tensor": lambda: (_t(X), _t(Y)),
        "tensor_host_y": lambda: (_t(X), Y),
        "dataframe": lambda: DataFrame({"features": list(X), "label": list(Y)}),
        "pandas_columns": lambda: pd.DataFrame({**{f"f{i}": X[:, i] for i in range(D)}, "label": Y}),
    }


@pytest.mark.parametrize("route", list(_routes()))
def test_every_route_matches_jax_and_lstsq(route):
    model = LinearRegression().fit(_routes()[route]())
    want = _jax_fit("ols")
    _close(f"{route} coef", model.coefficients, want.coefficients)
    _close(f"{route} intercept", model.intercept, want.intercept)
    ref = _lstsq()
    _close(f"{route} coef vs lstsq", model.coefficients, ref[:-1], LSTSQ_TOL)
    _close(f"{route} intercept vs lstsq", model.intercept, ref[-1], LSTSQ_TOL)


def test_the_reader_route_matches_the_jax_reader_route():
    model = LinearRegression().setRegParam(0.2).fit((HostArrayBlockReader(X, block_rows=37), Y))
    want = JaxLR().setRegParam(0.2).fit((JaxReader(X, block_rows=37), Y))
    _close("coef", model.coefficients, want.coefficients)


ESTIMATOR_CASES = {
    "ridge": dict(regParam=0.3),
    "ridge_no_std": dict(regParam=0.3, standardization=False),
    "no_intercept": dict(fitIntercept=False),
    "elastic_net": dict(regParam=0.2, elasticNetParam=0.5),
    "lasso_no_std": dict(regParam=0.05, elasticNetParam=1.0, standardization=False),
    "bf16x3": dict(precision="bf16x3"),
}


@pytest.mark.parametrize("case", list(ESTIMATOR_CASES))
def test_estimator_configurations_match_jax(case):
    params = ESTIMATOR_CASES[case]
    model = _configure(LinearRegression(), **params).fit((X, Y))
    want = _jax_fit(case, **params)
    tol = 1e-6 if case == "bf16x3" else TOL  # float64 operands multiply in float64 in every mode
    _close(f"{case} coef", model.coefficients, want.coefficients, tol)
    _close(f"{case} intercept", model.intercept, want.intercept, tol)


def test_weight_col_matches_jax():
    df = DataFrame({"features": list(X), "label": list(Y), "w": list(W)})
    jdf = JaxDataFrame({"features": list(X), "label": list(Y), "w": list(W)})
    model = LinearRegression().setWeightCol("w").setRegParam(0.1).fit(df)
    want = JaxLR().setWeightCol("w").setRegParam(0.1).fit(jdf)
    _close("coef", model.coefficients, want.coefficients)
    _close("intercept", model.intercept, want.intercept)


@pytest.mark.parametrize("route", ["array", "list_of_blocks"])
def test_dd_is_native_float64(route):
    data = _routes()[route]()
    model = LinearRegression().setPrecision("dd").setRegParam(0.1).fit(data)
    want = _jax_fit("ridge01", regParam=0.1)
    _close("dd coef vs jax highest", model.coefficients, want.coefficients)
    jdd = JaxLR().setPrecision("dd").setRegParam(0.1).fit(data)
    _close("dd coef vs jax dd", model.coefficients, jdd.coefficients, 1e-5)
    assert isinstance(model._coef_raw, np.ndarray)  # solved on the host


def test_fista_warm_start_matches_jax():
    start = _jax_fit("ridge", regParam=0.3)
    model = LinearRegression().setRegParam(0.2).setElasticNetParam(0.5).setInitialModel(
        linear_regression_model_from_numpy(start.coefficients, start.intercept)).fit((X, Y))
    want = JaxLR().setRegParam(0.2).setElasticNetParam(0.5).setInitialModel(start).fit((X, Y))
    _close("coef", model.coefficients, want.coefficients)
    # The warm start lands on the cold start's optimum.
    _close("coef vs cold", model.coefficients, _jax_fit("elastic_net").coefficients, 1e-4)


def test_tensor_fit_keeps_tensors_until_read():
    model = LinearRegression().fit((_t(X), _t(Y)))
    assert isinstance(model._coef_raw, torch.Tensor)
    pred = model.predict(_t(X))
    assert isinstance(pred, torch.Tensor) and pred.shape == (N,)
    f32 = LinearRegression().fit((_t(X).float(), _t(Y).float()))
    assert f32._coef_raw.dtype == torch.float32
    _close("float32 fit", f32.coefficients, _jax_fit("ols").coefficients, 1e-4)


# --- model ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted():
    port_device.set_platform("cpu")
    model = LinearRegression().setRegParam(0.1).fit((X, Y))
    port_device.set_platform("cuda")
    return model, _jax_fit("ridge01", regParam=0.1)


def test_predict_matches_jax(fitted):
    model, want = fitted
    x_new = _xy(seed=3, n=70)[0]
    _close("predict", model.predict(x_new), want.predict(x_new))
    _close("predict one row", model.predict(x_new[0]), want.predict(x_new[0]))


def test_transform_matches_jax(fitted):
    model, want = fitted
    df = DataFrame({"features": list(X[:20])})
    jdf = JaxDataFrame({"features": list(X[:20])})
    got = model.transform(df).select("prediction")
    _close("transform frame", np.asarray(got, dtype=np.float64), np.asarray(want.transform(jdf).select("prediction")))
    pdf = pd.DataFrame({f"f{i}": X[:20, i] for i in range(D)})
    _close("transform pandas", model.transform(pdf)["prediction"].to_numpy(),
           want.transform(pdf)["prediction"].to_numpy())
    _close("transform tuple", model.transform((X[:20], Y[:20])), want.transform((X[:20], Y[:20])))


def test_evaluate_matches_jax(fitted):
    model, want = fitted
    got, exp = model.evaluate((X, Y)), want.evaluate((X, Y))
    assert set(got) == set(exp)
    for key in exp:
        _close(key, got[key], exp[key])
    dev = model.evaluate((_t(X), _t(Y)))
    for key in exp:
        _close(f"tensor {key}", dev[key], exp[key])


def test_copy_and_pickle_keep_fitted_state(fitted):
    import pickle

    model, _ = fitted
    twin = model.copy()
    np.testing.assert_array_equal(twin.coefficients, model.coefficients)
    back = pickle.loads(pickle.dumps(model))
    np.testing.assert_array_equal(back.coefficients, model.coefficients)
    assert back.intercept == model.intercept and back.getRegParam() == 0.1


def test_saved_by_the_port_loads_in_jax(fitted, tmp_path):
    model, _ = fitted
    model.write.overwrite().save(str(tmp_path / "m"))
    back = JaxLRModel.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(back.coefficients, model.coefficients)
    assert back.intercept == model.intercept and back.getRegParam() == 0.1


def test_saved_by_jax_loads_in_the_port(fitted, tmp_path):
    _, want = fitted
    want.write.overwrite().save(str(tmp_path / "m"))
    back = LinearRegressionModel.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(back.coefficients, want.coefficients)
    assert back.intercept == want.intercept and back.getRegParam() == 0.1
    _close("loaded predict", back.predict(X), want.predict(X))


def test_interop_carries_a_jax_model(fitted):
    _, want = fitted
    params = {p.name: v for p, v in want.extractParamMap().items()}
    model = linear_regression_model_from_numpy(want.coefficients, want.intercept, uid=want.uid, params=params)
    assert model.uid == want.uid and model.getRegParam() == 0.1
    _close("interop predict", model.predict(X), want.predict(X))
    with pytest.raises(ValueError, match="coef must be"):
        linear_regression_model_from_numpy(np.ones((2, 2)), 0.0)


# --- error paths -----------------------------------------------------------------


def _both(build):
    """Run ``build(cls)`` on both estimators; both must raise the same type."""
    errors = []
    for cls in (JaxLR, LinearRegression):
        with pytest.raises(Exception) as info:
            build(cls)
        errors.append(type(info.value))
    assert errors[0] is errors[1], errors


blocks6 = [X[:100], X[100:]]
ERROR_CASES = {
    "normal_solver_with_l1": lambda c: c().setSolver("normal").setElasticNetParam(0.5).fit((X, Y)),
    "negative_reg": lambda c: c().setRegParam(-1.0),
    "enet_out_of_range": lambda c: c().setElasticNetParam(1.5),
    "bad_solver": lambda c: c().setSolver("lbfgs"),
    "warm_start_exact_solve": lambda c: c().setInitialModel(np.ones(D)).fit((X, Y)),
    "warm_start_wrong_width": lambda c: c().setRegParam(0.1).setElasticNetParam(0.5)
    .setInitialModel(np.ones(D + 1)).fit((X, Y)),
    "warm_start_matrix": lambda c: c().setInitialModel(np.ones((2, 2))),
    "dd_with_weights": lambda c: c().setPrecision("dd").setWeightCol("w").fit(
        (JaxDataFrame if c is JaxLR else DataFrame)({"features": list(X), "label": list(Y), "w": list(W)})),
    "dd_with_l1": lambda c: c().setPrecision("dd").setRegParam(0.1).setElasticNetParam(0.5).fit((X, Y)),
    "dd_on_a_device_array": lambda c: c().setPrecision("dd").fit(
        (jnp.asarray(X), jnp.asarray(Y)) if c is JaxLR else (_t(X), _t(Y))),
    "labels_too_short": lambda c: c().fit((X, Y[:-1])),
    "blocks_labels_short": lambda c: c().fit((blocks6, Y[:-1])),
    "blocks_labels_long": lambda c: c().fit((blocks6, np.append(Y, 0.0))),
    "per_block_lists_differ": lambda c: c().fit((blocks6, [Y[:100]])),
    "blocks_inconsistent_width": lambda c: c().fit(([X[:100], X[100:, :3]], Y)),
    "bad_dataset": lambda c: c().fit(X),
    "bad_precision": lambda c: c().setPrecision("fp8"),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_paths_raise_the_reference_types(case):
    _both(ERROR_CASES[case])


def test_routes_of_later_slices_raise_naming_their_item(fitted):
    # The mesh (A.9, 8d) arrived with the distribution slice.
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    np.testing.assert_allclose(LinearRegression(mesh=mesh).fit((X, Y)).coefficients,
                               LinearRegression().fit((X, Y)).coefficients, rtol=0, atol=1e-10)
    # The serving signature arrived with the composition slice.
    assert fitted[0].serving_signature().name == "linreg.predict"


def test_params_surface_matches_jax():
    port, ref = LinearRegression(), JaxLR()
    assert {p.name for p in ref.params} - {p.name for p in port.params} <= {"deployMode"}
    for p in port.params:
        if ref.hasParam(p.name) and ref.hasDefault(ref.getParam(p.name)):
            assert port.getOrDefault(p) == ref.getOrDefault(ref.getParam(p.name)), p.name
