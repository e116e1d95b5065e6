"""The port's randomized PCA (``ops/randomized.py``) and the ``solver``
routing of ``PCA``, against the JAX package and the float64 oracle.

The sketch's draw Ω cannot be JAX's threefry bits in torch, so the port
takes Ω as an argument: these tests pass JAX's own
``jax.random.normal(key(0), (d, l), float64)``, and both packages compute
from the same numbers. Tolerances (float64):

- components against JAX 1e-8 elementwise after sign alignment, explained-
  variance ratios 1e-10, ``_chol_qr2`` 1e-10;
- with the port's own draw, against ``numpy_pca_oracle``: components 1e-4
  (sign-invariant), ratios 1e-5 (the subspace tolerance of the random-
  numbers rule).

The ``solver="auto"`` switch (fault C2: the port raised at d ≥ 4096) is
held to the reference's route: the sketch exactly where the JAX package
takes it, the covariance path where it keeps that (``dd``, ``pallas``, a
one-shot generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import numpy_pca_oracle
from spark_rapids_ml_tpu.core.data import HostArrayBlockReader as JaxHostArrayBlockReader
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.ops import randomized as jrand
from spark_rapids_ml_tpu.ops.precision import make_dot as jax_make_dot
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.ops import randomized as trand
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.utils.testing import assert_close
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

PC_TOL = 1e-8
EV_TOL = 1e-10
ORACLE_PC_TOL = 1e-4
ORACLE_EV_TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def jax_omega(d: int, l: int) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.key(0), (d, l), dtype=jnp.float64))


def planted(n: int, d: int, seed: int, rank: int = 6, noise: float = 0.05) -> np.ndarray:
    """A decaying top ``rank`` (20, 14, 10, ...) over small noise, offset
    from the origin: the top components are well determined."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    s = np.full(d, noise)
    s[:rank] = 20.0 * 0.7 ** np.arange(rank)
    return (rng.standard_normal((n, d)) * s) @ q.T + rng.uniform(-3.0, 3.0, d)


def aligned(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``got`` with each column's sign set to agree with ``want``'s."""
    signs = np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)
    return got * signs


def assert_pc_close(name, got, want, atol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert_close(name, aligned(got, want), want, rtol=0, atol=atol)


def blocks_of(x: np.ndarray, cuts):
    edges = [0, *cuts, x.shape[0]]
    return [x[a:b] for a, b in zip(edges[:-1], edges[1:])]


# --- ops/randomized.py ------------------------------------------------------


@pytest.mark.parametrize("shape,decades", [((200, 30), 0), ((50, 50), 0), ((300, 12), 5)],
                         ids=["tall", "square", "ill-conditioned"])
def test_chol_qr2_matches_jax(shape, decades):
    """Singular values spread over ``decades`` (condition 1e5: the Gram's
    1e10 is where the second pass earns its keep)."""
    rng = np.random.default_rng(1)
    u, _ = np.linalg.qr(rng.standard_normal((shape[0], shape[1])))
    v, _ = np.linalg.qr(rng.standard_normal((shape[1], shape[1])))
    y = (u * np.logspace(0, -decades, shape[1])) @ v.T
    got = trand._chol_qr2(torch.from_numpy(y), make_dot("highest"))
    want = np.asarray(jrand._chol_qr2(jnp.asarray(y), jax_make_dot("highest")))
    assert_close("chol_qr2", got, want, rtol=0, atol=1e-10)
    q = got.numpy()
    assert_close("orthonormal", q.T @ q, np.eye(shape[1]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("center", [True, False], ids=["centered", "uncentered"])
@pytest.mark.parametrize("n,d,k,power_iters", [(500, 60, 5, 2), (300, 120, 8, 1), (40, 25, 3, 0)])
def test_randomized_pca_matches_jax(n, d, k, power_iters, center):
    x = planted(n, d, seed=n + d)
    l = min(k + 10, d, n)
    jc, jr, jm = jrand.randomized_pca(jnp.asarray(x), k, jax.random.key(0), power_iters=power_iters,
                                      center=center)
    c, r, m = trand.randomized_pca(torch.from_numpy(x), k, jax_omega(d, l), power_iters=power_iters,
                                   center=center)
    assert c.shape == (d, k) and r.shape == (k,)
    assert_pc_close("components", c.numpy(), np.asarray(jc), PC_TOL)
    assert_close("ratios", r, np.asarray(jr), rtol=0, atol=EV_TOL)
    assert_close("mean", m, np.asarray(jm), rtol=0, atol=1e-12)


def test_randomized_pca_matches_the_oracle_with_its_own_draw():
    x = planted(600, 80, seed=3)
    c, r, _ = trand.randomized_pca(torch.from_numpy(x), 4)
    want_pc, want_ev = numpy_pca_oracle(x, 4)
    assert_pc_close("components vs oracle", c.numpy(), want_pc, ORACLE_PC_TOL)
    assert_close("ratios vs oracle", r, want_ev, rtol=0, atol=ORACLE_EV_TOL)


def test_randomized_pca_on_a_near_rank_deficient_sketch_matches_jax():
    """Rank 3 data under a sketch of width 12: the Cholesky-QR2 ridge keeps
    the factor defined, and the top components still agree."""
    x = planted(200, 40, seed=4, rank=3, noise=0.0)
    for center in (True, False):
        jc, jr, _ = jrand.randomized_pca(jnp.asarray(x), 2, jax.random.key(0), center=center)
        c, r, _ = trand.randomized_pca(torch.from_numpy(x), 2, jax_omega(40, 12), center=center)
        assert np.isfinite(c.numpy()).all()
        assert_pc_close("components", c.numpy(), np.asarray(jc), PC_TOL)
        assert_close("ratios", r, np.asarray(jr), rtol=0, atol=EV_TOL)
        blocks = blocks_of(x, [70, 71, 150])
        sc, sr, _, _ = trand.randomized_pca_streaming(
            lambda: iter(blocks), 2, jax_omega(40, 12), center=center, device=torch.device("cpu"))
        jsc, jsr, _, _ = jrand.randomized_pca_streaming(lambda: iter(blocks), 2, jax.random.key(0),
                                                        center=center)
        assert_pc_close("streamed components", sc, jsc, PC_TOL)
        assert_close("streamed ratios", sr, jsr, rtol=0, atol=EV_TOL)


def test_randomized_pca_validates_k_and_the_draw():
    x = torch.from_numpy(planted(20, 8, seed=5))
    with pytest.raises(ValueError, match="k <= min"):
        trand.randomized_pca(x, 9)
    with pytest.raises(ValueError, match=r"\(d, l\)"):
        trand.randomized_pca(x, 2, np.zeros((8, 3)))
    a = trand.draw_omega(8, 5, torch.float64)
    assert torch.equal(a, trand.draw_omega(8, 5, torch.float64)) and a.device.type == "cpu"


@pytest.mark.parametrize("center", [True, False], ids=["centered", "uncentered"])
@pytest.mark.parametrize("cuts", [[100, 101, 377], [250]], ids=["ragged", "two"])
def test_randomized_pca_streaming_matches_jax(cuts, center):
    x = planted(500, 60, seed=6)
    k = 5
    blocks = blocks_of(x, cuts) + [np.zeros((0, 60))]
    jc, jr, jm, jn = jrand.randomized_pca_streaming(lambda: iter(blocks), k, jax.random.key(0),
                                                    center=center)
    before = counter_value("pca.sketch.stream.passes")
    c, r, m, n = trand.randomized_pca_streaming(lambda: iter(blocks), k, jax_omega(60, 15),
                                                center=center, device=torch.device("cpu"))
    assert counter_value("pca.sketch.stream.passes") - before == 4  # moments, 2 power, Rayleigh-Ritz
    assert n == jn == 500 and isinstance(c, np.ndarray) and c.shape == (60, k)
    assert_pc_close("components", c, jc, PC_TOL)
    assert_close("ratios", r, jr, rtol=0, atol=EV_TOL)
    assert_close("mean", m, jm, rtol=0, atol=1e-12)


def test_randomized_pca_streaming_matches_the_oracle_with_its_own_draw():
    x = planted(700, 90, seed=7).astype(np.float32)
    reader = HostArrayBlockReader(x, block_rows=128)
    c, r, _, n = trand.randomized_pca_streaming(reader.iter_blocks, 4, device=torch.device("cpu"))
    want_pc, want_ev = numpy_pca_oracle(x.astype(np.float64), 4)
    assert n == 700
    assert_pc_close("components vs oracle", c, want_pc, ORACLE_PC_TOL)
    assert_close("ratios vs oracle", r, want_ev, rtol=0, atol=ORACLE_EV_TOL)


def test_randomized_pca_streaming_guards_match_jax():
    x = planted(30, 6, seed=8)
    for fn, args in ((jrand.randomized_pca_streaming, (jax.random.key(0),)),
                     (trand.randomized_pca_streaming, (None,))):
        kw = {"device": torch.device("cpu")} if fn is trand.randomized_pca_streaming else {}
        with pytest.raises(ValueError, match="at least 2 rows"):
            fn(lambda: iter([np.zeros((0, 6))]), 2, *args, **kw)
        with pytest.raises(ValueError, match="k <= min"):
            fn(lambda: iter([x]), 7, *args, **kw)


# --- the estimator: solver="randomized" and the auto switch ------------------


@pytest.fixture
def jax_draw(monkeypatch):
    """The port estimator's default draw replaced by JAX's key(0) draw."""
    monkeypatch.setattr(trand, "draw_omega", lambda d, l, dtype: torch.tensor(jax_omega(d, l), dtype=dtype))


@pytest.fixture
def jax_routes(monkeypatch):
    """Records each JAX fit that takes the sketch."""
    calls = []
    original = JaxPCA._fit_randomized

    def spy(self, rows):
        calls.append(type(rows).__name__)
        return original(self, rows)

    monkeypatch.setattr(JaxPCA, "_fit_randomized", spy)
    return calls


def _inputs(kind: str, x: np.ndarray):
    """(port input, JAX input) of one container kind over the same rows."""
    parts = blocks_of(x, [x.shape[0] // 3, x.shape[0] // 2])
    if kind == "matrix":
        return x, x
    if kind == "tensor":
        return torch.from_numpy(x), jnp.asarray(x)
    if kind == "factory":
        return (lambda: iter(parts)), (lambda: iter(parts))
    if kind == "reader":
        return HostArrayBlockReader(x, block_rows=13), JaxHostArrayBlockReader(x, block_rows=13)
    if kind == "generator":
        return iter(parts), iter(parts)
    raise AssertionError(kind)


def _sketches() -> int:
    return counter_value("pca.sketch") + counter_value("pca.sketch.stream")


@pytest.mark.parametrize("center", [True, False], ids=["centered", "uncentered"])
@pytest.mark.parametrize("kind", ["matrix", "tensor", "factory", "reader"])
def test_randomized_solver_matches_jax(kind, center, jax_draw, jax_routes):
    x = planted(240, 50, seed=9)
    ours, theirs = _inputs(kind, x)
    before = _sketches()
    model = PCA().setK(4).setSolver("randomized").setMeanCentering(center).fit(ours)
    jmodel = JaxPCA().setK(4).setSolver("randomized").setMeanCentering(center).fit(theirs)
    assert _sketches() - before == 1 and len(jax_routes) == 1
    assert model.pc.shape == (50, 4)
    assert_pc_close("components", model.pc, jmodel.pc, PC_TOL)
    assert_close("ratios", model.explainedVariance, jmodel.explainedVariance, rtol=0, atol=EV_TOL)


def test_randomized_solver_on_a_tensor_stays_lazy_and_in_its_dtype():
    x = torch.from_numpy(planted(100, 20, seed=10).astype(np.float32))
    model = PCA().setK(3).setSolver("randomized").fit(x)
    assert isinstance(model._pc_raw, torch.Tensor) and model._pc_raw.dtype == torch.float32
    want_pc, want_ev = numpy_pca_oracle(x.double().numpy(), 3)
    assert_pc_close("float32 components vs oracle", model.pc, want_pc, 1e-3)


def test_auto_takes_the_sketch_at_4096_features(jax_draw, jax_routes):
    """Fault C2: the default call at d = 4096 takes the sketch in both
    packages (40 rows keep it small) and agrees."""
    x = planted(40, 4096, seed=11, rank=3)
    before = counter_value("pca.sketch")
    model = PCA().setK(2).fit(x)
    jmodel = JaxPCA().setK(2).fit(x)
    assert counter_value("pca.sketch") - before == 1 and jax_routes == ["ndarray"]
    assert_pc_close("components", model.pc, jmodel.pc, PC_TOL)
    assert_close("ratios", model.explainedVariance, jmodel.explainedVariance, rtol=0, atol=EV_TOL)


@pytest.mark.parametrize(
    "kind,params,sketch",
    [
        ("matrix", {}, True),
        ("tensor", {}, True),
        ("factory", {}, True),
        ("reader", {}, True),
        ("generator", {}, False),
        ("matrix", {"precision": "dd"}, False),
        ("factory", {"precision": "dd"}, False),
        ("matrix", {"covarianceBackend": "pallas"}, False),
        ("matrix", {"solver": "covariance"}, False),
    ],
)
def test_auto_routes_as_the_reference_does(kind, params, sketch, monkeypatch, jax_draw, jax_routes):
    """With the switch width lowered to 32 in both packages, a 48-wide
    input takes the sketch wherever the JAX package does and keeps the
    covariance path wherever it does, with the same result."""
    monkeypatch.setattr(PCA, "_RANDOMIZED_AUTO_DIM", 32)
    monkeypatch.setattr(JaxPCA, "_RANDOMIZED_AUTO_DIM", 32)
    x = planted(150, 48, seed=12)
    ours, theirs = _inputs(kind, x)
    before = _sketches()
    est, jest = PCA().setK(3), JaxPCA().setK(3)
    for name, value in params.items():
        est.set(est.getParam(name), value)
        jest.set(jest.getParam(name), value)
    model, jmodel = est.fit(ours), jest.fit(theirs)
    assert (_sketches() - before == 1) is sketch
    assert (len(jax_routes) == 1) is sketch
    if params.get("precision") == "dd":
        # Native float64 meets the oracle to rounding; the JAX package's
        # double-float emulation is held to the oracle's 1e-5.
        want_pc, want_ev = numpy_pca_oracle(x, 3)
        assert_pc_close("dd components vs oracle", model.pc, want_pc, PC_TOL)
        assert_close("dd ratios vs oracle", model.explainedVariance, want_ev, rtol=0, atol=EV_TOL)
        pc_tol, ev_tol = 1e-5, 1e-5
    else:
        pc_tol, ev_tol = PC_TOL, EV_TOL
    assert_pc_close("components", model.pc, jmodel.pc, pc_tol)
    assert_close("ratios", model.explainedVariance, jmodel.explainedVariance, rtol=0, atol=ev_tol)


@pytest.mark.parametrize("precision", ["auto", "dd", "highest", "f32", "bf16x3", "bf16"])
def test_sketch_precision_matches_jax(precision):
    assert PCA().setPrecision(precision)._sketch_precision() == JaxPCA().setPrecision(
        precision)._sketch_precision()
    assert PCA()._sketch_precision() == JaxPCA()._sketch_precision() == "highest"


def test_randomized_guards_match_jax():
    x = planted(30, 6, seed=13)
    for Est, gen in ((PCA, lambda: iter([x])), (JaxPCA, lambda: iter([x]))):
        with pytest.raises(ValueError, match="one-shot"):
            Est().setK(2).setSolver("randomized").fit(gen())
        with pytest.raises(ValueError, match="no dd path"):
            Est().setK(2).setSolver("randomized").setPrecision("dd").fit(x)
        with pytest.raises(ValueError, match="covarianceBackend='pallas'"):
            Est().setK(2).setSolver("randomized").setCovarianceBackend("pallas").fit(x)
        with pytest.raises(ValueError, match="k must be in"):
            Est().setK(7).setSolver("randomized").fit(x)
        with pytest.raises(ValueError, match="k <= min"):
            Est().setK(7).setSolver("randomized").fit(gen)
        with pytest.raises(ValueError, match="no rows"):
            Est().setK(2).fit(lambda: iter([np.zeros((0, 6))]))
