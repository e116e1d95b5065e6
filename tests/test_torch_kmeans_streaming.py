"""The port's streaming KMeans fit against the JAX package.

``reservoir_sample_rows`` draws from numpy's ``default_rng(seed)`` in both
packages, so the seeding sample is held bitwise. ``lloyd_streaming`` and
the estimator's ``_fit_streaming`` start from pinned centers (a warm
start) and are held at rtol 1e-10 (atol 1e-10 of the largest value) in
float64, with equal ``numIter``; the estimator's float32 default is held
at 1e-4 (centers) and 1e-5 (cost, relative) against the float64 reference,
as the in-memory estimator is. Default seeding (k-means++ on the
reservoir) cannot match JAX's threefry bits: it is held to planted blobs,
every center recovered within 1.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.core.data import HostArrayBlockReader as JaxHostArrayBlockReader
from spark_rapids_ml_tpu.ops import kmeans as jkm
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader
from spark_rapids_ml_tpu_torch.models import kmeans as mk
from spark_rapids_ml_tpu_torch.ops import kmeans as tkm
from spark_rapids_ml_tpu_torch.utils.testing import assert_close
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def make_blobs(seed, n=600, d=6, k=4, sep=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    labels = rng.integers(0, k, size=n)
    return centers[labels] + rng.normal(size=(n, d)), centers


def _pinned(x, k, seed=11):
    return x[np.random.default_rng(seed).choice(x.shape[0], k, replace=False)].copy()


def _blocks(x, cuts=(150, 151, 400)):
    """Ragged row blocks with an empty block in the middle."""
    edges = [0, *cuts, x.shape[0]]
    out = [x[a:b] for a, b in zip(edges[:-1], edges[1:])]
    return out[:2] + [np.zeros((0, x.shape[1]))] + out[2:]


def _f64(want) -> dict:
    want = np.asarray(want)
    return {"rtol": 1e-10, "atol": 1e-10 * max(1.0, float(np.abs(want).max()))}


# --- reservoir_sample_rows --------------------------------------------------


@pytest.mark.parametrize("cap", [1, 64, 600, 1000])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", [None, np.float32])
def test_reservoir_sample_is_the_reference_bit_for_bit(cap, seed, dtype):
    x, _ = make_blobs(3)
    blocks = _blocks(x) + [x[:50]]
    got, seen = tkm.reservoir_sample_rows(iter(blocks), cap, seed, dtype=dtype)
    want, jseen = jkm.reservoir_sample_rows(iter(blocks), cap, seed, dtype=dtype)
    assert seen == jseen == 650
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (min(cap, 650), 6)


def test_reservoir_sample_of_no_rows_raises_as_jax_does():
    for fn in (tkm.reservoir_sample_rows, jkm.reservoir_sample_rows):
        with pytest.raises(ValueError, match="no rows"):
            fn(iter([np.zeros((0, 4))]), 8, 0)


# --- lloyd_streaming --------------------------------------------------------


@pytest.mark.parametrize("tol", [0.0, 1e-4])
@pytest.mark.parametrize("cosine", [False, True], ids=["euclidean", "cosine"])
def test_lloyd_streaming_matches_jax(cosine, tol):
    x, _ = make_blobs(5, sep=4.0)
    init = _pinned(x, 4)
    if cosine:
        init = np.asarray(jkm.normalize_rows(jnp.asarray(init)))
    blocks = _blocks(x)
    before = counter_value("fit.stream.prefetched")
    c, cost, it = tkm.lloyd_streaming(lambda: iter(blocks), torch.from_numpy(init), max_iter=12,
                                      tol=tol, cosine=cosine)
    jc, jcost, jit = jkm.lloyd_streaming(lambda: iter(blocks), jnp.asarray(init), max_iter=12,
                                         tol=tol, cosine=cosine)
    assert it == int(jit) and 1 <= it <= 12
    # Five blocks a pass (one empty), so four one-ahead hand-offs a pass.
    assert counter_value("fit.stream.prefetched") - before == 4 * (it + 1)
    assert c.dtype == torch.float64
    assert_close("centers", c, np.asarray(jc), **_f64(jc))
    assert float(cost) == pytest.approx(float(jcost), rel=1e-10)


def test_lloyd_streaming_is_lloyd_over_the_same_rows():
    x, _ = make_blobs(6, sep=4.0)
    init = torch.from_numpy(_pinned(x, 4))
    c, cost, it = tkm.lloyd_streaming(lambda: iter(_blocks(x)), init, max_iter=30, tol=1e-6)
    want_c, want_cost, want_it = tkm.lloyd(torch.from_numpy(x), torch.ones(600, dtype=torch.float64),
                                           init, max_iter=30, tol=1e-6)
    assert it == want_it
    assert_close("centers", c, want_c, **_f64(want_c))
    assert float(cost) == pytest.approx(float(want_cost), rel=1e-10)


def test_lloyd_streaming_in_float32_from_float64_blocks():
    x, _ = make_blobs(8, sep=4.0)
    init = _pinned(x, 4)
    c, cost, _ = tkm.lloyd_streaming(lambda: iter(_blocks(x)), torch.from_numpy(init).float(),
                                     max_iter=10)
    jc, jcost, _ = jkm.lloyd_streaming(lambda: iter(_blocks(x)), jnp.asarray(init), max_iter=10)
    assert c.dtype == torch.float32
    assert_close("float32 centers", c, np.asarray(jc), rtol=0, atol=1e-4)
    assert float(cost) == pytest.approx(float(jcost), rel=1e-5)


# --- the estimator ----------------------------------------------------------


@pytest.fixture
def float64_default(monkeypatch):
    """The estimator's compute dtype at float64, the JAX package's under x64."""
    monkeypatch.setattr(mk, "default_dtype", lambda: torch.float64)


def _source(kind, x, pkg_reader):
    if kind == "factory":
        blocks = _blocks(x)
        return lambda: iter(blocks)
    return pkg_reader(x, block_rows=97)


@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
@pytest.mark.parametrize("kind", ["factory", "reader"])
def test_warm_started_fit_streaming_matches_jax(kind, measure, float64_default):
    x, _ = make_blobs(9, sep=4.0)
    init = _pinned(x, 4)
    model = (KMeans().setK(4).setMaxIter(15).setDistanceMeasure(measure).setInitialModel(init)
             .fit(_source(kind, x, HostArrayBlockReader)))
    jmodel = (JaxKMeans().setK(4).setMaxIter(15).setDistanceMeasure(measure).setInitialModel(init)
              .fit(_source(kind, x, JaxHostArrayBlockReader)))
    assert model.numIter == jmodel.numIter
    assert_close("centers", model.clusterCenters(), jmodel.clusterCenters(), **_f64(jmodel.clusterCenters()))
    assert model.trainingCost == pytest.approx(jmodel.trainingCost, rel=1e-10)
    assert np.array_equal(np.asarray(model.predict(x)), np.asarray(jmodel.predict(x)))


def test_fit_streaming_computes_in_float32_by_default():
    x, _ = make_blobs(10, sep=4.0)
    init = _pinned(x, 4)
    model = KMeans().setK(4).setInitialModel(init).fit(lambda: iter(_blocks(x)))
    jmodel = JaxKMeans().setK(4).setInitialModel(init).fit(lambda: iter(_blocks(x)))
    assert model._centers_raw.dtype == torch.float32
    assert model.numIter == jmodel.numIter
    assert_close("centers", model.clusterCenters(), jmodel.clusterCenters(), rtol=0, atol=1e-4)
    assert model.trainingCost == pytest.approx(jmodel.trainingCost, rel=1e-5)


def test_seeded_fit_streaming_recovers_planted_blobs():
    x, truth = make_blobs(12, n=2000, d=5, k=3, sep=20.0)
    model = KMeans().setK(3).setSeed(4).fit(HostArrayBlockReader(x, 300))
    centers = model.clusterCenters()
    nearest = np.sqrt(((truth[:, None, :] - centers[None]) ** 2).sum(-1)).min(axis=1)
    assert np.all(nearest < 1.0), nearest
    again = KMeans().setK(3).setSeed(4).fit(HostArrayBlockReader(x, 300))
    assert np.array_equal(again.clusterCenters(), centers)  # seeded: repeatable


def test_random_seeding_of_a_stream_is_repeatable():
    x, _ = make_blobs(15, n=900, d=5, k=3)
    fits = [KMeans().setK(3).setSeed(2).setInitMode("random").fit(lambda: iter(_blocks(x))) for _ in range(2)]
    assert np.isfinite(fits[0].clusterCenters()).all() and fits[0].clusterCenters().shape == (3, 5)
    assert np.array_equal(fits[0].clusterCenters(), fits[1].clusterCenters())
    assert fits[0].numIter == fits[1].numIter


def test_reservoir_cap_is_max_4096_and_4k(monkeypatch):
    caps = []

    class Stop(Exception):
        pass

    def spy(blocks, cap, seed, dtype=None):
        caps.append(cap)
        raise Stop

    monkeypatch.setattr(mk, "reservoir_sample_rows", spy)
    x, _ = make_blobs(13, n=50)
    for k in (3, 1500):
        with pytest.raises(Stop):
            KMeans().setK(k).fit(lambda: iter([x]))
    assert caps == [4096, 6000]


def test_fit_streaming_guards_match_jax():
    x, _ = make_blobs(14, n=40)
    for Est in (KMeans, JaxKMeans):
        with pytest.raises(ValueError, match="RE-ITERABLE"):
            Est().setK(2).fit(iter([x]))
        with pytest.raises(ValueError, match="exceeds number of rows 40"):
            Est().setK(41).fit(lambda: iter([x[:25], x[25:]]))
        with pytest.raises(ValueError, match="no rows"):
            Est().setK(2).fit(lambda: iter([np.zeros((0, 6))]))
        with pytest.raises(ValueError, match="k=3"):
            Est().setK(3).setInitialModel(x[:2]).fit(lambda: iter([x]))
        with pytest.raises(ValueError, match="features"):
            Est().setK(2).setInitialModel(x[:2, :3]).fit(lambda: iter([x]))
    with pytest.raises(ValueError, match="single-device"):
        KMeans(mesh=object()).setK(2).fit(lambda: iter([x]))
