"""The port's evaluators and device metrics against the JAX package.

``ops/metrics`` (regression reductions, the bincount confusion matrix, the
tie-grouped AUC by one sort and scans, float32 scores as packed int64
keys) and ``evaluation.py`` (the three evaluators, host and device
routes): the same seeded numpy inputs go through both packages, the JAX
side with x64 on as tier-1 runs it. The device route runs for a tensor
pair (a JAX array pair in the reference) and for a host pair of at least
1,000,000 rows. Tolerances: 1e-12 in float64, 1e-6 on float32 scores.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu import evaluation as jax_eval
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.ops import metrics as jax_metrics
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import evaluation
from spark_rapids_ml_tpu_torch.core.data import DataFrame
from spark_rapids_ml_tpu_torch.ops import metrics

N = 400


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _scores(kind: str, n: int = N, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "heavy_ties":
        s = np.round(rng.uniform(size=n), 1)  # 11 distinct scores
        y = (rng.uniform(size=n) < s).astype(np.float64)
    elif kind == "signed_zeros":
        s = np.round(rng.normal(size=n), 1)
        s[s == 0] = 0.0
        s[: n // 4] = -0.0
        s[n // 4: n // 2] = 0.0
        y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    elif kind == "continuous":
        s = rng.uniform(size=n)
        y = (rng.uniform(size=n) < s).astype(np.float64)
    elif kind == "all_positive":
        s, y = rng.uniform(size=n), np.ones(n)
    else:  # all_negative
        s, y = rng.uniform(size=n), np.zeros(n)
    return y, s


SCORE_KINDS = ["heavy_ties", "signed_zeros", "continuous", "all_positive", "all_negative"]
AUC = ["areaUnderROC", "areaUnderPR"]


def _tol(dtype):
    return 1e-6 if dtype == np.float32 else 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", SCORE_KINDS)
@pytest.mark.parametrize("metric", AUC)
def test_binary_auc_device_matches_jax(metric, kind, dtype):
    y, s = _scores(kind)
    s = s.astype(dtype)
    got = float(metrics.binary_auc_device(torch.tensor(y), torch.tensor(s), metric))
    want = float(jax_metrics.binary_auc_device(jnp.asarray(y), jnp.asarray(s), metric=metric))
    assert abs(got - want) <= _tol(dtype)


@pytest.mark.parametrize("route", ["host", "tensor"])
@pytest.mark.parametrize("kind", SCORE_KINDS)
@pytest.mark.parametrize("metric", AUC)
def test_binary_evaluator_matches_jax(metric, kind, route):
    y, s = _scores(kind)
    port = evaluation.BinaryClassificationEvaluator().setMetricName(metric)
    ref = jax_eval.BinaryClassificationEvaluator().setMetricName(metric)
    if route == "host":
        got, want = port.evaluate((y, s)), ref.evaluate((y, s))
    else:
        got, want = port.evaluate((torch.tensor(y), torch.tensor(s))), ref.evaluate((jnp.asarray(y), jnp.asarray(s)))
    assert abs(got - want) <= 1e-12
    assert abs(got - port.evaluate((y, s))) <= 1e-12  # device route == host route


@pytest.mark.parametrize("metric", AUC)
def test_a_large_host_pair_scores_on_the_device_as_jax_does(metric, monkeypatch):
    y, s = _scores("heavy_ties", n=evaluation._DEVICE_THRESHOLD)
    calls = []
    real = evaluation.binary_auc_device
    monkeypatch.setattr(evaluation, "binary_auc_device", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = evaluation.BinaryClassificationEvaluator().setMetricName(metric).evaluate((y, s))
    want = jax_eval.BinaryClassificationEvaluator().setMetricName(metric).evaluate((y, s))
    assert calls == [1]
    assert abs(got - want) <= 1e-12


def test_binary_evaluator_reads_named_columns_as_jax_does():
    y, s = _scores("continuous", n=60)
    raw = [np.array([-v, v]) for v in s]
    got = evaluation.BinaryClassificationEvaluator().evaluate(DataFrame({"label": list(y), "rawPrediction": raw}))
    want = jax_eval.BinaryClassificationEvaluator().evaluate(JaxDataFrame({"label": list(y), "rawPrediction": raw}))
    assert got == want
    pdf = pd.DataFrame({"label": y, "score": s})
    assert (evaluation.BinaryClassificationEvaluator().setRawPredictionCol("score").evaluate(pdf)
            == jax_eval.BinaryClassificationEvaluator().setRawPredictionCol("score").evaluate(pdf))


def _regression_pair(seed=1):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=N) * 3 + 1
    return y, y + rng.normal(size=N) * 0.5


@pytest.mark.parametrize("route", ["host", "tensor"])
@pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2"])
def test_regression_evaluator_matches_jax(metric, route):
    y, p = _regression_pair()
    port = evaluation.RegressionEvaluator().setMetricName(metric)
    ref = jax_eval.RegressionEvaluator().setMetricName(metric)
    if route == "host":
        got, want = port.evaluate((y, p)), ref.evaluate((y, p))
    else:
        got, want = port.evaluate((torch.tensor(y), torch.tensor(p))), ref.evaluate((jnp.asarray(y), jnp.asarray(p)))
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
    assert port.isLargerBetter() == ref.isLargerBetter()


def test_regression_metrics_device_matches_jax():
    y, p = _regression_pair(2)
    got = metrics.regression_metrics_device(torch.tensor(y), torch.tensor(p))
    want = jax_metrics.regression_metrics_device(jnp.asarray(y), jnp.asarray(p))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-12 * max(1.0, abs(float(w)))
    flat = metrics.regression_metrics_device(torch.ones(5, dtype=torch.float64), torch.ones(5, dtype=torch.float64))
    assert float(flat[3]) == float(jax_metrics.regression_metrics_device(jnp.ones(5), jnp.ones(5))[3]) == 0.0


def _class_pair(seed=3, k=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=N).astype(np.float64)
    p = np.where(rng.uniform(size=N) < 0.7, y, rng.integers(0, k, size=N)).astype(np.float64)
    return y, p


MULTI = ["f1", "accuracy", "weightedPrecision", "weightedRecall"]


@pytest.mark.parametrize("route", ["host", "tensor"])
@pytest.mark.parametrize("metric", MULTI)
def test_multiclass_evaluator_matches_jax(metric, route):
    y, p = _class_pair()
    port = evaluation.MulticlassClassificationEvaluator().setMetricName(metric)
    ref = jax_eval.MulticlassClassificationEvaluator().setMetricName(metric)
    if route == "host":
        got, want = port.evaluate((y, p)), ref.evaluate((y, p))
    else:
        got, want = port.evaluate((torch.tensor(y), torch.tensor(p))), ref.evaluate((jnp.asarray(y), jnp.asarray(p)))
    assert abs(got - want) <= 1e-12


@pytest.mark.parametrize("case", ["fractional", "large_ids", "negative"])
def test_multiclass_gate_falls_back_to_the_host_route_as_jax_does(case):
    y, p = _class_pair()
    if case == "fractional":
        y = y + 0.5
    elif case == "large_ids":
        y, p = y + 5000, p + 5000
    else:
        y, p = y - 2, p - 2
    got = evaluation.MulticlassClassificationEvaluator().evaluate((torch.tensor(y), torch.tensor(p)))
    want = jax_eval.MulticlassClassificationEvaluator().evaluate((jnp.asarray(y), jnp.asarray(p)))
    assert abs(got - want) <= 1e-12
    assert evaluation._multiclass_gate_probe(torch.tensor(y), torch.tensor(p)) == pytest.approx(
        np.asarray(jax_eval._multiclass_gate_probe(jnp.asarray(y), jnp.asarray(p))).tolist())


def test_confusion_matrix_and_multiclass_metrics_match_jax():
    y, p = _class_pair(k=5)
    got = metrics.confusion_matrix_device(torch.tensor(y), torch.tensor(p), 5)
    want = jax_metrics.confusion_matrix_device(jnp.asarray(y), jnp.asarray(p), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert metrics.multiclass_metrics_device(torch.tensor(y), torch.tensor(p), 5) == \
        jax_metrics.multiclass_metrics_device(jnp.asarray(y, dtype=jnp.int32), jnp.asarray(p, dtype=jnp.int32), 5)


def test_packed_keys_order_float32_scores_and_merge_signed_zeros():
    s = torch.tensor([-np.inf, -2.5, -0.0, 0.0, 1e-30, 3.0, np.inf], dtype=torch.float32)
    keys = metrics._pack_f32_keys(torch.zeros(7), s) >> 1
    assert torch.all(keys[1:] >= keys[:-1])
    assert keys[2] == keys[3]  # -0.0 and +0.0 share one tie group
    assert int(keys.max()) < 2 ** 32 and int(keys.min()) >= 0  # 32 key bits; the label makes 33


def test_evaluators_read_frames_and_refuse_bare_arrays():
    y, p = _regression_pair()
    df = DataFrame({"label": list(y), "prediction": list(p)})
    jdf = JaxDataFrame({"label": list(y), "prediction": list(p)})
    assert evaluation.RegressionEvaluator().evaluate(df) == jax_eval.RegressionEvaluator().evaluate(jdf)
    yc, pc = _class_pair()
    pdf = pd.DataFrame({"label": yc, "prediction": pc})
    assert (evaluation.MulticlassClassificationEvaluator().evaluate(pdf)
            == jax_eval.MulticlassClassificationEvaluator().evaluate(pdf))
    with pytest.raises(TypeError):
        jax_eval.RegressionEvaluator().evaluate(np.ones(3))
    with pytest.raises(TypeError):
        evaluation.RegressionEvaluator().evaluate(np.ones(3))


@pytest.mark.parametrize("name", ["RegressionEvaluator", "MulticlassClassificationEvaluator",
                                  "BinaryClassificationEvaluator"])
def test_params_and_bad_metric_names_match_jax(name):
    port, ref = getattr(evaluation, name)(), getattr(jax_eval, name)()
    assert port.getMetricName() == ref.getMetricName()
    assert {p.name for p in port.params} == {p.name for p in ref.params}
    with pytest.raises(ValueError):
        ref.setMetricName("logLoss")
    with pytest.raises(ValueError):
        port.setMetricName("logLoss")
