"""The elastic net's stopping rule on float32 rows.

FISTA stops when ``max|c_new − c| ≤ tol`` (1e-7 by default), the
reference's rule. Float32 iterates cannot take a step that small on a
coefficient of magnitude ≥ 1 (one ulp there is 1.19e-7), so a float32
solve met the rule only when the iterate stood exactly still and
otherwise ran to ``maxIter``. The port now iterates in float64 on the
d × d moment form whatever the rows' dtype (``ops/linear._enet_prep``),
and casts the coefficients back to the fit's dtype at the end.

At config 4's width (28 features, coefficients of magnitude ≥ 1, 4,000
float32 rows):

- the old float32 iterates run to ``maxIter`` = 2,000 and the float64
  ones stop well before it;
- a warm ``partial_fit`` takes fewer iterations than a cold one, and a
  cold one is bitwise a plain fit;
- a checkpointed (segmented) solve is bitwise the monolithic one;
- the float32 solve is within 1e-4 of the JAX package's float64 solve.

The logistic elastic net (``ops/logistic.fit_logistic_elastic_net``)
keeps its float32 iterates: here its float32 fits meet the rule before
``maxIter``, as the last test shows.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import linear as jax_linear
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.ops import linear
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.robustness.checkpoint import DIR_ENV, EVERY_ENV
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

N, D = 4000, 28
REG, ALPHA, MAX_ITER, TOL = 0.1, 0.5, 2000, 1e-7


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _rows(seed: int = 1):
    """Two float32 draws of config 4's shape: HIGGS-like shifted, scaled
    columns and true coefficients of magnitude ≥ 1."""
    rng = np.random.default_rng(seed)
    mu, sd = rng.random(D) - 0.5, rng.random(D) + 0.5
    w = np.sign(rng.normal(size=D)) * (1.0 + np.abs(rng.normal(size=D)))
    xa = (rng.normal(size=(N, D)) * sd + mu).astype(np.float32)
    xb = (rng.normal(size=(N, D)) * sd + mu).astype(np.float32)
    ya = (xa @ w + 0.1 * rng.normal(size=N)).astype(np.float32)
    yb = (xb @ w + 0.1 * rng.normal(size=N)).astype(np.float32)
    return (torch.from_numpy(xa), torch.from_numpy(ya)), (torch.from_numpy(xb), torch.from_numpy(yb))


def _estimator():
    return LinearRegression().setRegParam(REG).setElasticNetParam(ALPHA)


def _iterations(fn):
    before = counter_value("linear.fista.iterations")
    model = fn()
    return model, counter_value("linear.fista.iterations") - before


def test_float32_iterates_run_to_max_iter_and_float64_iterates_stop():
    _, (xb, yb) = _rows()
    stats = linear.normal_eq_stats(xb, yb)
    assert stats[0].dtype == torch.float32
    a_quad, b_lin, lip, thresh, _, _ = linear._enet_prep(*stats[:4], stats[5], REG, ALPHA, True, True)
    assert a_quad.dtype == torch.float64
    f32 = [t.to(torch.float32) for t in (a_quad, b_lin, lip, thresh)]
    c, z, t, it, delta = linear._enet_init(f32[0], None)
    old_iters = linear._enet_segment(*f32, TOL, c, z, t, it, delta, MAX_ITER, MAX_ITER)[3]
    coef, b0, new_iters = linear.solve_elastic_net(*stats[:4], stats[5], REG, ALPHA)
    assert old_iters == MAX_ITER
    assert 0 < new_iters < MAX_ITER // 4
    assert coef.dtype == torch.float32 and b0.dtype == torch.float32


def test_float32_solve_is_near_the_jax_float64_solve():
    _, (xb, yb) = _rows()
    stats = linear.normal_eq_stats(xb, yb)
    coef, b0, _ = linear.solve_elastic_net(*stats[:4], stats[5], REG, ALPHA)
    s64 = [np.asarray(s.numpy(), dtype=np.float64) for s in stats]
    jcoef, jb0, _ = jax_linear.solve_elastic_net(*s64[:4], s64[5], REG, ALPHA)
    scale = float(np.max(np.abs(np.asarray(jcoef))))
    assert float(np.max(np.abs(coef.numpy() - np.asarray(jcoef)))) <= 1e-4 * scale
    assert abs(float(b0) - float(jb0)) <= 1e-4 * max(1.0, abs(float(jb0)))


def test_warm_partial_fit_takes_fewer_iterations_than_cold_on_float32_rows():
    (xa, ya), (xb, yb) = _rows()
    prev = _estimator().fit((xa, ya))
    warm, warm_iters = _iterations(lambda: _estimator().partial_fit((xb, yb), model=prev))
    cold, cold_iters = _iterations(lambda: _estimator().partial_fit((xb, yb)))
    plain = _estimator().fit((xb, yb))
    assert 0 < warm_iters < cold_iters < MAX_ITER
    assert cold.coefficients.tobytes() == plain.coefficients.tobytes()
    assert cold.intercept == plain.intercept
    scale = float(np.max(np.abs(cold.coefficients)))
    assert float(np.max(np.abs(warm.coefficients - cold.coefficients))) <= 1e-4 * scale


def test_segmented_float32_solve_is_bitwise_the_monolithic_solve(tmp_path, monkeypatch):
    _, (xb, yb) = _rows()
    monkeypatch.delenv(DIR_ENV, raising=False)
    whole, whole_iters = _iterations(lambda: _estimator().fit((xb, yb)))
    monkeypatch.setenv(DIR_ENV, str(tmp_path / "ckpt"))
    monkeypatch.setenv(EVERY_ENV, "16")
    seg, seg_iters = _iterations(lambda: _estimator().fit((xb, yb)))
    assert counter_value("checkpoint.segments") > 0
    assert seg_iters == whole_iters < MAX_ITER
    assert seg.coefficients.tobytes() == whole.coefficients.tobytes()
    assert seg.intercept == whole.intercept


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_float32_logistic_elastic_net_meets_tol_before_max_iter(seed):
    rng = np.random.default_rng(seed)
    w = np.sign(rng.normal(size=D)) * (1.0 + np.abs(rng.normal(size=D)))
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = ((x @ w + 2.0 * rng.normal(size=N)) > 0).astype(np.float32)
    model = (LogisticRegression().setRegParam(0.001).setElasticNetParam(ALPHA).setMaxIter(MAX_ITER)
             .fit((torch.from_numpy(x), torch.from_numpy(y))))
    assert float(np.max(np.abs(model.coefficients))) >= 1.0
    assert 0 < model.numIter < MAX_ITER
