"""The port's eigensolvers (``ops/eigh.py``) against the JAX package's.

Inputs are numpy matrices made from a seed; both packages see the same
bytes. The subspace solvers start from a random basis that torch cannot
draw as JAX does, so the port is handed JAX's own draw
(``jax.random.normal(key(0), (d, l))``) as its pinned ``q0``. Tolerances:
``sign_flip`` exact; eigenpairs 1e-10 (full solve) and 1e-8 (subspace
solvers), absolute, on unit-scale matrices with distinct top eigenvalues.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import eigh as jeigh
from spark_rapids_ml_tpu_torch.ops import eigh as teigh
from spark_rapids_ml_tpu_torch.utils.testing import assert_close, seeded_matrix


def _jax_q0(d: int, k: int) -> np.ndarray:
    l = teigh._subspace_l(d, k)
    return np.asarray(jax.random.normal(jax.random.key(0), (d, l), dtype=jnp.float64))


def _planted(d: int, spectrum: np.ndarray, seed: int) -> np.ndarray:
    q, _ = np.linalg.qr(seeded_matrix(d, d, seed))
    return (q * spectrum[None, :]) @ q.T


def _spectra(d: int) -> dict:
    i = np.arange(d)
    return {
        # Marchenko–Pastur: the sample covariance of pure noise.
        "flat": (lambda z: z.T @ z / 60)(seeded_matrix(60, d, 21)),
        "decaying": _planted(d, 10 * 0.5 ** i + 0.01, 22),
        "slow": _planted(d, 10 * 0.97 ** i, 23),
    }


def test_sign_flip_is_exact_including_ties():
    u = seeded_matrix(30, 8, 1)
    u[:, 3] = 0.0
    u[[4, 9], 3] = [-2.0, 2.0]  # a tie of |max|: the first index (negative) decides
    u[:, 5] = -np.abs(u[:, 5])
    want = np.asarray(jeigh.sign_flip(jnp.asarray(u)))
    got = teigh.sign_flip(torch.from_numpy(u)).numpy()
    assert np.array_equal(got, want)
    assert got[4, 3] == 2.0 and np.all(got[:, 5] >= 0)
    assert np.array_equal(teigh._sign_flip_host(u), want)


def test_eigh_descending_matches_jax_on_a_distinct_spectrum():
    a = _planted(20, np.linspace(5.0, 0.1, 20), 2)
    wj, vj = jeigh.eigh_descending(jnp.asarray(a))
    wt, vt = teigh.eigh_descending(torch.from_numpy(a))
    assert_close("eigenvalues", wt, np.asarray(wj), rtol=0, atol=1e-10)
    assert_close("eigenvectors", vt, np.asarray(vj), rtol=0, atol=1e-10)
    assert np.all(np.diff(wt.numpy()) < 0)
    wh, vh = teigh.eigh_descending_host(torch.from_numpy(a))
    wjh, vjh = jeigh.eigh_descending_host(a)
    assert_close("host eigenvalues", wh, wjh, rtol=0, atol=1e-10)
    assert_close("host eigenvectors", vh, vjh, rtol=0, atol=1e-10)


@pytest.mark.parametrize("spectrum", ["flat", "decaying", "slow"])
def test_eigh_topk_matches_jax_with_its_start_basis(spectrum):
    d, k = 40, 4
    a = _spectra(d)[spectrum]
    wj, vj = jeigh.eigh_topk(jnp.asarray(a), k, iters=8)
    wt, vt = teigh.eigh_topk(torch.from_numpy(a), k, iters=8, q0=_jax_q0(d, k))
    assert_close("topk eigenvalues", wt, np.asarray(wj), rtol=0, atol=1e-8)
    assert_close("topk eigenvectors", vt, np.asarray(vj), rtol=0, atol=1e-8)


@pytest.mark.parametrize(
    "spectrum,promoted", [("flat", True), ("decaying", False), ("slow", True)]
)
def test_eigh_auto_accepts_and_promotes_as_jax_does(spectrum, promoted):
    d, k = 40, 4
    a = _spectra(d)[spectrum]
    wj, vj, pj = jeigh.eigh_auto(jnp.asarray(a), k, max_iters=12)
    wt, vt, pt = teigh.eigh_auto(torch.from_numpy(a), k, max_iters=12, q0=_jax_q0(d, k))
    assert bool(pj) is promoted and pt is promoted
    assert_close("auto eigenvalues", wt, np.asarray(wj), rtol=0, atol=1e-8)
    assert_close("auto eigenvectors", vt, np.asarray(vj), rtol=0, atol=1e-8)


def test_eigh_auto_promotes_on_the_chip_smoke_spectrum_as_jax_does():
    """chip_smoke.py's planted spectrum (top 32 singular values 1 + 30·0.8^i
    over unit noise, k = 16), exact and at d = 64: both packages promote
    to the full solve."""
    d, k = 64, 16
    s = np.ones(d)
    s[:32] += 30 * 0.8 ** np.arange(32)
    a = _planted(d, s**2, 24)
    wj, vj, pj = jeigh.eigh_auto(jnp.asarray(a), k, max_iters=12)
    wt, vt, pt = teigh.eigh_auto(torch.from_numpy(a), k, max_iters=12, q0=_jax_q0(d, k))
    assert bool(pj) is True and pt is True
    assert_close("promoted eigenvectors", vt, np.asarray(vj), rtol=0, atol=1e-8)


def test_eigh_auto_with_k_equal_d_is_the_full_solve():
    a = _planted(6, np.linspace(3.0, 0.5, 6), 3)
    w, v, promoted = teigh.eigh_auto(torch.from_numpy(a), 6)
    wf, vf = teigh.eigh_descending(torch.from_numpy(a))
    assert promoted is True and torch.equal(w, wf) and torch.equal(v, vf)


def test_default_start_basis_is_seeded_and_float32_works():
    d, k = 24, 3
    a = _spectra(d)["decaying"][:d, :d]
    w1, v1, _ = teigh.eigh_auto(torch.from_numpy(a), k)
    w2, v2, _ = teigh.eigh_auto(torch.from_numpy(a), k)
    assert torch.equal(v1, v2) and torch.equal(w1, w2)
    wf, vf = teigh.eigh_descending(torch.from_numpy(a))
    assert_close("seeded start vs full solve", v1, vf[:, :k], rtol=0, atol=1e-8)
    w32, v32, _ = teigh.eigh_auto(torch.from_numpy(a).float(), k)
    assert v32.dtype == torch.float32
    assert_close("float32 auto vs float64 full", v32, vf[:, :k], rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="q0 must have shape"):
        teigh.eigh_topk(torch.from_numpy(a), k, q0=np.zeros((d, 2)))


def test_cholqr_matches_jax():
    z = seeded_matrix(50, 10, 4)
    qj, sj = jeigh._cholqr(jnp.asarray(z))
    qt, st = teigh._cholqr(torch.from_numpy(z))
    assert_close("cholqr q", qt, np.asarray(qj), rtol=0, atol=1e-12)
    assert_close("cholqr trace", st, np.asarray(sj), rtol=1e-14, atol=0)


def test_cal_svd_matches_jax():
    a = _planted(12, np.concatenate([np.linspace(4.0, 0.5, 11), [-1e-13]]), 5)
    uj, sj = jeigh.cal_svd(jnp.asarray(a))
    ut, st = teigh.cal_svd(torch.from_numpy(a))
    assert_close("singular values", st, np.asarray(sj), rtol=0, atol=1e-10)
    assert_close("singular vectors", ut[:, :11], np.asarray(uj)[:, :11], rtol=0, atol=1e-10)
    assert st[-1] >= 0


def test_iteration_constants_match_jax():
    assert teigh.AUTO_MIN_ITERS == jeigh.AUTO_MIN_ITERS
    for it in (1, 8, 12, 30):
        assert teigh.auto_max_iters(it) == jeigh.auto_max_iters(it)
    for d, k in ((40, 4), (10, 9), (1024, 16)):
        assert teigh._subspace_l(d, k) == jeigh._subspace_l(d, k)


def _constant_column_cov(d: int) -> np.ndarray:
    x = seeded_matrix(30, d, 6, scales=np.linspace(2.0, 0.5, d))
    x[:, 1] = 3.0
    b = x - x.mean(axis=0)
    return b.T @ b / 29


@pytest.mark.parametrize("case", ["zero", "constant column"])
def test_eigh_auto_on_a_singular_covariance_matches_jax(case):
    """A zero Gram (constant data) has no positive-definite CholeskyQR
    factor: both packages carry NaN through the subspace steps and promote
    to the full solve, which gives the zero spectrum."""
    d, k = 12, 2
    a = np.zeros((d, d)) if case == "zero" else _constant_column_cov(d)
    wj, vj, pj = jeigh.eigh_auto(jnp.asarray(a), k, max_iters=12)
    wt, vt, pt = teigh.eigh_auto(torch.from_numpy(a), k, max_iters=12, q0=_jax_q0(d, k))
    assert pt is bool(pj)
    if case == "zero":
        assert pt is True
    assert_close(f"{case} auto eigenvalues", wt, np.asarray(wj), rtol=0, atol=1e-10)
    assert_close(f"{case} auto eigenvectors", vt, np.asarray(vj), rtol=0, atol=1e-8)
    wf, vf = teigh.eigh_descending(torch.from_numpy(a))
    wfj, vfj = jeigh.eigh_descending(jnp.asarray(a))
    assert_close(f"{case} full eigenvalues", wf, np.asarray(wfj), rtol=0, atol=1e-10)
    assert_close(f"{case} full eigenvectors", vf[:, :k], np.asarray(vfj)[:, :k], rtol=0, atol=1e-8)


def test_cholqr_of_a_zero_block_is_nan_as_in_jax():
    z = np.zeros((20, 6))
    qj, sj = jeigh._cholqr(jnp.asarray(z))
    qt, st = teigh._cholqr(torch.from_numpy(z))
    assert np.all(np.isnan(np.asarray(qj))) and torch.isnan(qt).all()
    assert float(st) == float(sj) == 0.0


@pytest.mark.parametrize("solver", ["auto", "full", "topk"])
def test_a_nan_matrix_gives_nan_without_raising_as_in_jax(solver):
    d, k = 10, 3
    a = _planted(d, np.linspace(4.0, 0.5, d), 7)
    a[2, 5] = a[5, 2] = np.nan
    if solver == "auto":
        wj, vj, _ = jeigh.eigh_auto(jnp.asarray(a), k, max_iters=12)
        wt, vt, pt = teigh.eigh_auto(torch.from_numpy(a), k, max_iters=12, q0=_jax_q0(d, k))
        assert pt is True
    elif solver == "full":
        wj, vj = jeigh.eigh_descending(jnp.asarray(a))
        wt, vt = teigh.eigh_descending(torch.from_numpy(a))
    else:
        wj, vj = jeigh.eigh_topk(jnp.asarray(a), k, iters=8)
        wt, vt = teigh.eigh_topk(torch.from_numpy(a), k, iters=8, q0=_jax_q0(d, k))
    for name, got, want in (("eigenvalues", wt, wj), ("eigenvectors", vt, vj)):
        assert np.all(np.isnan(np.asarray(want))), f"reference {name} are not NaN"
        assert torch.isnan(got).all(), f"{solver} {name} are not NaN"
