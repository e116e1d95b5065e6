"""The port's covariance ops and kernel K1's CPU route, against the JAX package.

Inputs are made with numpy from a seed and go through both packages. The
JAX side runs as its own tests run it (x64 on the CPU; the Pallas kernel
in interpret mode, as in tests/test_pallas.py). Tolerances:

- float64 against JAX ``centered_gram``: rtol 1e-12, atol 1e-12·max|C|
  (two LAPACK/BLAS sum orders of the same float64 products);
- float32 against ``centered_gram_pallas(interpret=True)``: rtol 2e-5,
  atol 1e-3, the bar of tests/test_pallas.py;
- Welford column stats: rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.ops.precision as jprec
from spark_rapids_ml_tpu.ops.covariance import (
    centered_gram as jax_centered_gram,
    mean_and_covariance as jax_mean_and_covariance,
    welford_add_block as jax_welford_add_block,
    welford_init as jax_welford_init,
)
from spark_rapids_ml_tpu.ops.pallas.covariance import centered_gram_pallas
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.ops import covariance as tcov
from spark_rapids_ml_tpu_torch.ops import precision as tprec
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1
from spark_rapids_ml_tpu_torch.utils.testing import assert_close, seeded_matrix


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _f64_bar(want: np.ndarray) -> dict:
    return {"rtol": 1e-12, "atol": 1e-12 * max(1.0, float(np.abs(want).max()))}


@pytest.mark.parametrize("n,d,seed", [(300, 200, 0), (77, 50, 1), (2, 3, 2), (1, 1, 3)])
def test_centered_gram_f64_matches_jax(n, d, seed):
    x = seeded_matrix(n, d, seed, offset=5.0)
    mean = x.mean(axis=0)
    want = np.asarray(jax_centered_gram(jnp.asarray(x), jnp.asarray(mean)))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mean)
    assert_close("ops.centered_gram f64", tcov.centered_gram(xt, mt), want, **_f64_bar(want))
    assert_close("K1 CPU route f64", k1.centered_gram_cuda(xt, mt), want, **_f64_bar(want))
    assert_close("K1 plain f64", k1.centered_gram_plain(xt, mt), want, **_f64_bar(want))


@pytest.mark.parametrize(
    "n,d,block_rows", [(300, 200, 128), (77, 50, 32), (0, 8, 1024)], ids=["tiled", "ragged", "empty"]
)
def test_k1_cpu_route_matches_pallas_interpret(n, d, block_rows):
    x = seeded_matrix(n, d, n + d, dtype=np.float32)
    mean = (x.mean(axis=0) if n else np.zeros(d)).astype(np.float32)
    want = np.asarray(
        centered_gram_pallas(jnp.asarray(x), jnp.asarray(mean), block_rows=block_rows, interpret=True)
    )
    got = k1.centered_gram_cuda(torch.from_numpy(x), torch.from_numpy(mean))
    assert got.dtype == torch.float32 and got.shape == (d, d)
    assert_close("K1 CPU route vs Pallas interpret", got, want, rtol=2e-5, atol=1e-3)
    assert_close("ops.centered_gram vs Pallas interpret",
                 tcov.centered_gram(torch.from_numpy(x), torch.from_numpy(mean)), want,
                 rtol=2e-5, atol=1e-3)


def test_launches_stay_zero_on_cpu():
    k1.reset_launches()
    x = torch.from_numpy(seeded_matrix(40, 6, 4))
    k1.centered_gram_cuda(x, x.mean(dim=0))
    assert k1.launches == 0


def test_k1_wrapper_validates_its_inputs():
    x = torch.from_numpy(seeded_matrix(16, 4, 5))
    mean = x.mean(dim=0)
    with pytest.raises(ValueError, match="2-D"):
        k1.centered_gram_cuda(x[0], mean)
    with pytest.raises(ValueError, match="mean must have shape"):
        k1.centered_gram_cuda(x, mean[:3])
    with pytest.raises(TypeError, match="float32 or float64"):
        k1.centered_gram_cuda(x.half(), mean.half())
    with pytest.raises(TypeError, match="dtype"):
        k1.centered_gram_cuda(x, mean.float())
    with pytest.raises(ValueError, match="contiguous"):
        k1.centered_gram_cuda(x.T, torch.zeros(16, dtype=x.dtype))
    with pytest.raises(ValueError, match="runs on CUDA or CPU"):
        k1.centered_gram_cuda(x.to("meta"), mean.to("meta"))


@pytest.mark.parametrize("n,d,sms", [(1_000_000, 1024, 132), (65_536, 1024, 132), (37, 5, 132), (10, 3000, 132)])
def test_plan_splits_fills_the_card_within_the_workspace(n, d, sms):
    item = 4
    splits = k1.plan_splits(n, d, item, sms)
    tiles = -(-d // k1.TILE)
    pairs = tiles * (tiles + 1) // 2
    assert 1 <= splits <= 65535
    assert splits * d * d * item <= max(k1.WORKSPACE_BYTES, d * d * item)
    assert splits <= -(-n // k1.ROWS_PER_STEP)
    if n >= 2 * sms * k1.ROWS_PER_STEP and d * d * item * 2 <= k1.WORKSPACE_BYTES:
        assert pairs * splits >= 2 * sms or splits * d * d * item * 2 > k1.WORKSPACE_BYTES


def test_mean_and_covariance_matches_jax():
    x = seeded_matrix(120, 9, 6, offset=-2.0)
    want_mean, want_cov = jax_mean_and_covariance(jnp.asarray(x))
    got_mean, got_cov = tcov.mean_and_covariance(torch.from_numpy(x))
    assert_close("mean", got_mean, np.asarray(want_mean), rtol=1e-12, atol=1e-12)
    assert_close("cov", got_cov, np.asarray(want_cov), **_f64_bar(np.asarray(want_cov)))


def test_welford_column_stats_match_jax():
    x = seeded_matrix(250, 7, 8, offset=3.0)
    parts = [x[:100], x[100:100], x[100:180], x[180:]]  # an empty partition too
    jstate = jax_welford_init(7)
    tstate = tcov.welford_init(7)
    for p in parts:
        jstate = jax_welford_add_block(jstate, jnp.asarray(p))
        tstate = tcov.welford_add_block(tstate, torch.from_numpy(p))
    for name, got, want in zip(("count", "mean", "M2"), tstate, jstate):
        assert_close(f"welford {name}", got, np.asarray(want), rtol=1e-12, atol=1e-12)
    assert_close("welford mean vs numpy", tstate[1], x.mean(axis=0), rtol=1e-12, atol=1e-12)


#: The port's legacy names carry the TPU meaning of the reference's
#: ``lax.Precision`` levels (DEFAULT = one bf16 pass, HIGH = the 3-pass
#: split); XLA:CPU computes every level in full fp32, so the JAX side is
#: asked for the named mode that the level means on the TPU.
_JAX_MODE = {"highest": "f32", "high": "bf16x3", "default": "bf16"}


@pytest.mark.parametrize("mode", ["f32", "highest", "bf16x3", "high", "bf16", "default"])
def test_precision_modes_match_jax(mode):
    a = seeded_matrix(64, 48, 9, dtype=np.float32)
    b = seeded_matrix(48, 32, 10, dtype=np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    want = np.asarray(jprec.make_dot(_JAX_MODE.get(mode, mode))(jnp.asarray(a), jnp.asarray(b)))
    got = tprec.make_dot(mode)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    bound = tprec.REL_TOL.get(_JAX_MODE.get(mode, mode), 1e-6)
    scale = np.abs(exact).max()
    assert np.abs(got.numpy() - exact).max() <= bound * scale
    # Both packages round the operands to bf16 at the same places, so the
    # two agree far inside the mode's own bound (fp32 sum order only).
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


def test_documented_bounds_match_jax():
    assert tprec.REL_TOL == jprec.REL_TOL
    assert tprec.MODES == jprec.MODES


@pytest.mark.parametrize("name", ["gemm_syrk", "project_rows", "gemm_project"])
def test_linalg_gemms_match_jax(name):
    import spark_rapids_ml_tpu.ops.linalg as jlin
    from spark_rapids_ml_tpu_torch.ops import linalg as tlin

    a = seeded_matrix(40, 7, 13)
    b = seeded_matrix(40, 3, 14) if name == "gemm_project" else seeded_matrix(7, 3, 14)
    args = (a,) if name == "gemm_syrk" else (a, b)
    want = np.asarray(getattr(jlin, name)(*map(jnp.asarray, args)))
    got = getattr(tlin, name)(*map(torch.from_numpy, args))
    assert_close(f"ops.linalg.{name}", got, want, **_f64_bar(want))


def test_split_hi_lo_is_exact():
    a = torch.from_numpy(seeded_matrix(20, 20, 11, dtype=np.float32))
    hi, lo = tprec.split_hi_lo(a)
    assert torch.equal(hi + lo, a)
    assert torch.equal(hi, hi.to(torch.bfloat16).to(torch.float32))
    jhi, jlo = jprec.split_hi_lo(jnp.asarray(a.numpy()))
    assert np.array_equal(hi.numpy(), np.asarray(jhi)) and np.array_equal(lo.numpy(), np.asarray(jlo))


def test_float64_operands_stay_float64_in_every_mode():
    a = torch.from_numpy(seeded_matrix(10, 8, 12))
    for mode in ("bf16x3", "bf16", "dd", "highest"):
        out = tprec.make_dot(mode)(a.T, a)
        assert out.dtype == torch.float64
        assert torch.equal(out, a.T @ a)
    with pytest.raises(ValueError, match="no GEMM"):
        tprec.make_dot("nope")
