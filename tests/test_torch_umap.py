"""The port's UMAP (``ops/umap.py``, ``models/umap.py``, ``manifold.py``)
against the JAX package's, on the same numpy inputs.

Tolerances, and why:

- ``smooth_knn_dist`` and ``fuzzy_simplicial_set``: rtol 1e-5 in float32
  (the two packages' ``exp`` round differently; bisection flips near the
  root change sigma by ulps). ``find_ab_params``: 1e-10 (the same scipy
  fit on the same points).
- ``spectral_init``: columns sign-aligned, atol 1e-3 on the ±10 box; each
  side adds its own N(0, 1e-4²) noise.
- ``fuzzy_simplicial_set`` with duplicate rows: a row whose neighbour
  list holds log2(k) or more distances at rho has no sigma that meets
  the target (the sum exceeds it for every sigma > 0), so the bisection
  runs sigma down until float32 rounding of the sum stops it, which
  depends on the order the sum is taken in. Its memberships agree all
  the same; sigma is held on the other rows.
- One SGD epoch from a pinned layout, fed the negative indices JAX drew
  (threefry cannot be reproduced in torch): atol 1e-5, the bar of
  ``tests/test_umap.py``'s one-epoch backend test. Both tail routes (the
  K4 plan and the plain scatter), both negative paths (shared pool,
  per edge) and the transform mode. The pool path's factorised gradient
  ``rowsum(c)·y − c @ pool`` cancels ``c_ip·y_i`` against ``c_ip·pool_p``
  in float32; for a pool point at squared distance d² from ``y_i``,
  ``c_ip`` reaches ~2b/(0.001 + d²), so the two packages' different
  rounding of d² (each orders the ``y @ pool.T`` product its own way)
  moves such a row by ~1e-3 at d² ≈ 0 (a row drawn into its own pool).
  The pool tests therefore start from a jittered grid, no two points
  closer than 1, and give zero weight to the rows JAX drew into the pool.
- Three epochs with ``repulsionStrength=0`` (no random draw matters):
  1e-4. More epochs are not held numerically: the SGD is chaotic and
  amplifies per-epoch ulps to O(1) (BASELINE.md "UMAP tail scatter"), so
  longer fits are held to ``tests/test_umap.py``'s structural bars: blob
  separation > 2.0, trustworthiness > 0.85.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from spark_rapids_ml_tpu.manifold import UMAP as JaxUMAP
from spark_rapids_ml_tpu.manifold import UMAPModel as JaxUMAPModel
from spark_rapids_ml_tpu.models.umap import _knn_excluding_self as jax_knn_excluding_self
from spark_rapids_ml_tpu.ops import umap as jou
from spark_rapids_ml_tpu.ops.pallas import umap as jpu
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.core.data import DataFrame
from spark_rapids_ml_tpu_torch.interop import umap_model_from_numpy
from spark_rapids_ml_tpu_torch.manifold import UMAP, UMAPModel
from spark_rapids_ml_tpu_torch.models import umap as port_models_umap
from spark_rapids_ml_tpu_torch.ops import umap as pou
from spark_rapids_ml_tpu_torch.ops.kernels import umap as k4
from spark_rapids_ml_tpu_torch.utils.testing import assert_close, trustworthiness

A, B = jou.find_ab_params(1.0, 0.1)


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _three_blobs(rng, n_per=60, d=10, sep=12.0):
    centers = np.zeros((3, d))
    centers[0, 0] = centers[1, 1] = centers[2, 2] = sep
    x = np.concatenate([rng.normal(size=(n_per, d)) + c for c in centers])
    return x, np.repeat(np.arange(3), n_per)


def _separation_ratio(emb, labels):
    """min inter-centroid distance / mean intra-cluster spread."""
    cents = np.stack([emb[labels == c].mean(axis=0) for c in np.unique(labels)])
    inter = min(np.linalg.norm(cents[i] - cents[j])
                for i in range(len(cents)) for j in range(i + 1, len(cents)))
    intra = np.mean([np.linalg.norm(emb[labels == c] - cents[c], axis=1).mean() for c in range(len(cents))])
    return inter / max(intra, 1e-12)


def _graphs(x, k):
    """The JAX fuzzy graph of x and the same arrays as a port graph."""
    jd, ji = jax_knn_excluding_self(jnp.asarray(x, dtype=jnp.float32), k, "euclidean")
    jg = jou.fuzzy_simplicial_set(ji, jd)
    pg = pou.FuzzyGraph(*(torch.from_numpy(np.array(a)) for a in jg))
    return jg, pg


def _jax_draws(seed, epochs, shape, n_ref):
    """The negative indices JAX's epochs draw from ``key(seed)``: each
    epoch splits the carried key and draws from the second half."""
    key, out = jax.random.key(seed), []
    for _ in range(epochs):
        key, k_neg = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.randint(k_neg, shape, 0, n_ref))))
    return out


def _run_both(y0, jg, pg, epochs, seed=3, target=None, tail=False, **kw):
    """``epochs`` epochs of each package's epoch function from ``y0``."""
    n, dim = y0.shape
    kw = dict(dict(n_epochs=10, neg_rate=5, neg_pool=16, learning_rate=1.0, repulsion=1.0,
                   a=A, b=B, move_other=True), **kw)
    jtail, ptail = {}, None
    if tail:
        plan, cfg = jpu.build_tail_plan(np.asarray(jg.indices), n, dim)
        jtail = dict(tail_plan=plan, tail_cfg=cfg, tail_interpret=True)
        ptail = k4.build_tail_plan(pg.indices, n, dim)
    jepoch = jou._make_epoch_fn((n, dim), jg, None if target is None else jnp.asarray(target), **kw, **jtail)
    want, _ = lax.fori_loop(0, epochs, jepoch, (jnp.asarray(y0), jax.random.key(seed)))
    pepoch = pou._make_epoch_fn((n, dim), pg, None if target is None else torch.from_numpy(target),
                                **kw, tail_plan=ptail)
    n_ref = n if target is None else target.shape[0]
    shape = pou.negative_shape(n, pg.indices.shape[1], kw["neg_rate"], kw["neg_pool"])
    y = torch.from_numpy(y0)
    for ep, neg in enumerate(_jax_draws(seed, epochs, shape, n_ref)):
        y = pepoch(ep, y, neg)
    return np.asarray(want), y.numpy()


# --- graph construction ---------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_smooth_knn_dist_matches_jax(rng, scale):
    d = np.sort(rng.uniform(0.0, 3.0, size=(200, 12)), axis=1).astype(np.float32) * scale
    d[:5, 0] = 0.0  # duplicates: rho skips the zero distance
    js, jr = jou.smooth_knn_dist(jnp.asarray(d), 12.0)
    ps, pr = pou.smooth_knn_dist(torch.from_numpy(d), 12.0)
    assert_close("rho", pr, np.asarray(jr), rtol=1e-5)
    assert_close("sigma", ps, np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("dups", [0, 10])
def test_fuzzy_simplicial_set_matches_jax(rng, dups):
    x, _ = _three_blobs(rng, n_per=40)
    if dups:
        x[-dups:] = x[:dups]
    jg, _ = _graphs(x, 8)
    jd, ji = jax_knn_excluding_self(jnp.asarray(x, dtype=jnp.float32), 8, "euclidean")
    pg = pou.fuzzy_simplicial_set(torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(jd)))
    assert pg.indices.dtype == torch.int32 and pg.weight.dtype == torch.float32
    assert np.array_equal(pg.indices.numpy(), np.asarray(jg.indices))
    for name in ("weight", "rhos"):
        assert_close(name, getattr(pg, name), np.asarray(getattr(jg, name)), rtol=1e-5, atol=1e-7)
    d = np.asarray(jd)
    at_rho = np.sum(np.maximum(d - np.asarray(jg.rhos)[:, None], 0.0) == 0.0, axis=1)
    solvable = at_rho < np.log2(8)
    assert solvable.sum() >= 100 and (dups == 0) == solvable.all()
    assert_close("sigmas", pg.sigmas[solvable], np.asarray(jg.sigmas)[solvable], rtol=1e-5)


@pytest.mark.parametrize("spread,min_dist", [(1.0, 0.1), (1.0, 0.5), (2.0, 0.01)])
def test_find_ab_params_matches_jax(spread, min_dist):
    want = jou.find_ab_params(spread, min_dist)
    got = pou.find_ab_params(spread, min_dist)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_spectral_init_matches_jax(rng):
    x = rng.uniform(size=(160, 3))
    jg, pg = _graphs(x, 10)
    want = np.asarray(jou.spectral_init(jg, 160, 2, jax.random.key(0)))
    gen = torch.Generator().manual_seed(0)
    got = pou.spectral_init(pg, 160, 2, gen).numpy()
    assert got.shape == (160, 2) and np.abs(got).max() <= 10.0 + 1e-3
    signs = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * signs, want, atol=1e-3)


# --- one epoch, three epochs ----------------------------------------------


def _grid(rng, n, spacing=1.5):
    """n points of a jittered square grid centred in the ±10 box: any two
    at least spacing − 0.4 apart."""
    side = int(np.ceil(np.sqrt(n)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)), axis=-1).reshape(-1, 2)[:n]
    pts = (cells - (side - 1) / 2.0) * spacing + rng.uniform(-0.2, 0.2, size=(n, 2))
    return pts[rng.permutation(n)].astype(np.float32)


def _unpool(jg, pg, seed, epochs, neg_pool, n):
    """Zero the weights of the rows JAX draws into its pools (see the
    module docstring)."""
    drawn = torch.cat(_jax_draws(seed, epochs, (neg_pool,), n)).unique()
    w = pg.weight.clone()
    w[drawn] = 0.0
    return jg._replace(weight=jnp.asarray(w.numpy())), pg._replace(weight=w)


@pytest.mark.parametrize("tail", [False, True], ids=["scatter", "k4"])
@pytest.mark.parametrize("neg_pool", [16, 0], ids=["pool", "per_edge"])
def test_one_epoch_matches_jax(rng, neg_pool, tail):
    x, _ = _three_blobs(rng, n_per=50)
    jg, pg = _graphs(x, 8)
    if neg_pool:
        jg, pg = _unpool(jg, pg, 3, 1, neg_pool, 150)
        y0 = _grid(rng, 150)
    else:
        y0 = rng.uniform(-10, 10, size=(150, 2)).astype(np.float32)
    want, got = _run_both(y0, jg, pg, 1, neg_pool=neg_pool, tail=tail)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("neg_pool", [16, 0], ids=["pool", "per_edge"])
def test_one_epoch_target_mode_matches_jax(rng, neg_pool):
    """Transform mode: new points attract to a fixed training layout,
    negatives come from it, no tail update."""
    pts = _grid(rng, 150)  # the new points and the training layout never meet
    train_emb, y0 = pts[:120], pts[120:]
    idx = rng.integers(0, 120, size=(30, 6)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(30, 6)).astype(np.float32)
    zeros = np.zeros(30, dtype=np.float32)
    jg = jou.FuzzyGraph(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(zeros), jnp.asarray(zeros))
    pg = pou.FuzzyGraph(*(torch.from_numpy(a) for a in (idx, w, zeros, zeros)))
    want, got = _run_both(y0, jg, pg, 1, target=train_emb, move_other=False, neg_pool=neg_pool)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("tail", [False, True], ids=["scatter", "k4"])
def test_three_epochs_without_repulsion_match_jax(rng, tail):
    x, _ = _three_blobs(rng, n_per=40)
    jg, pg = _graphs(x, 8)
    y0 = rng.uniform(-10, 10, size=(120, 2)).astype(np.float32)
    want, got = _run_both(y0, jg, pg, 3, repulsion=0.0, n_epochs=3, tail=tail)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_k4_and_scatter_routes_agree(rng):
    x, _ = _three_blobs(rng, n_per=40)
    _, pg = _graphs(x, 8)
    y0 = torch.from_numpy(rng.uniform(-10, 10, size=(120, 2)).astype(np.float32))
    plan = k4.build_tail_plan(pg.indices, 120, 2)
    gen_a, gen_b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    kw = dict(n_epochs=5, a=A, b=B, neg_pool=32)
    a = pou.optimize_layout(y0, pg, gen_a, tail_plan=plan, **kw)
    b = pou.optimize_layout(y0, pg, gen_b, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# --- the estimator --------------------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_estimator_matches_jax_from_a_pinned_layout(rng, metric):
    x, _ = _three_blobs(rng, n_per=40)
    y0 = rng.uniform(-10, 10, size=(120, 2)).astype(np.float32)

    def est(cls):
        return (cls().setNNeighbors(8).setNEpochs(3).setMetric(metric).setRepulsionStrength(0.0)
                .setSeed(2).setInitEmbedding(y0))

    want = est(JaxUMAP).fit(x)
    got = est(UMAP).fit(x)
    assert got.embedding.dtype == np.float64 and got.embedding.shape == (120, 2)
    np.testing.assert_allclose(got.embedding, want.embedding, atol=1e-4)
    assert (got.a, got.b) == (want.a, want.b)
    np.testing.assert_array_equal(got.trainData, want.trainData)


def test_transform_of_a_jax_model_matches_jax(rng):
    x, _ = _three_blobs(rng, n_per=40)
    ref = JaxUMAP().setNNeighbors(8).setNEpochs(9).setRepulsionStrength(0.0).setSeed(1).fit(x)
    params = {p.name: v for p, v in ref.extractParamMap().items()}
    model = umap_model_from_numpy(ref.embedding, ref.trainData, ref.a, ref.b, uid=ref.uid, params=params)
    assert model.uid == ref.uid and model.getRepulsionStrength() == 0.0
    x_new = x[::7] + 0.3 * rng.normal(size=x[::7].shape)
    np.testing.assert_allclose(model.transform(x_new), ref.transform(x_new), atol=1e-4)
    with pytest.raises(ValueError, match="embedding must be"):
        umap_model_from_numpy(ref.embedding[:5], ref.trainData, ref.a, ref.b)


def test_blobs_separate_and_stay_trustworthy(rng):
    x, labels = _three_blobs(rng)
    model = UMAP().setNNeighbors(10).setNEpochs(150).setSeed(0).fit(x)
    emb = model.embedding
    assert emb.shape == (180, 2) and np.all(np.isfinite(emb))
    assert _separation_ratio(emb, labels) > 2.0
    assert trustworthiness(x, emb, 10) > 0.85


def test_random_init_cosine_and_per_edge_negatives(rng):
    x, labels = _three_blobs(rng, n_per=40)
    model = (UMAP().setInit("random").setMetric("cosine").setNNeighbors(8).setNEpochs(150)
             .setNegativePoolSize(0).setSeed(3).fit(x))
    assert _separation_ratio(model.embedding, labels) > 1.5


def test_transform_places_new_points_by_their_blob(rng):
    x, labels = _three_blobs(rng, n_per=50)
    model = UMAP().setNNeighbors(10).setNEpochs(150).setSeed(2).fit(x)
    x_new = rng.normal(size=(20, x.shape[1]))
    x_new[:, 0] += 12.0
    emb_new = model.transform(x_new)
    assert emb_new.shape == (20, 2) and emb_new.dtype == np.float64
    cents = np.stack([model.embedding[labels == c].mean(axis=0) for c in range(3)])
    d = np.linalg.norm(emb_new[:, None, :] - cents[None, :, :], axis=2)
    assert np.mean(np.argmin(d, axis=1) == 0) >= 0.9


def test_spectral_init_up_to_the_cap_random_above(rng, monkeypatch):
    x, _ = _three_blobs(rng, n_per=20)
    calls = []
    real = port_models_umap.spectral_init
    monkeypatch.setattr(port_models_umap, "spectral_init", lambda *a: calls.append(1) or real(*a))
    UMAP().setNEpochs(2).fit(x)
    assert calls == [1]
    monkeypatch.setattr(port_models_umap, "_SPECTRAL_CAP", 59)
    UMAP().setNEpochs(2).fit(x)
    assert calls == [1]


def test_a_tensor_fit_keeps_tensors_and_is_deterministic(rng):
    x, _ = _three_blobs(rng, n_per=20)
    xt = torch.from_numpy(x.astype(np.float32))
    m1 = UMAP().setNEpochs(30).setSeed(7).fit(xt)
    m2 = UMAP().setNEpochs(30).setSeed(7).fit(xt)
    assert isinstance(m1._emb_raw, torch.Tensor) and m1._train_raw is xt
    assert torch.equal(m1._emb_raw, m2._emb_raw)
    out = m1.transform(xt[:4])
    assert isinstance(out, torch.Tensor) and out.shape == (4, 2)


# --- persistence, shims, params -------------------------------------------


def test_save_in_the_port_load_in_jax(rng, tmp_path):
    x, _ = _three_blobs(rng, n_per=20)
    model = UMAP().setNEpochs(20).setNNeighbors(7).setSeed(4).fit(x)
    path = str(tmp_path / "umap")
    model.write.overwrite().save(path)
    ref = JaxUMAPModel.load(path)
    np.testing.assert_array_equal(ref.embedding, model.embedding)
    np.testing.assert_array_equal(ref.trainData, model.trainData)
    assert (ref.a, ref.b, ref.uid, ref.getNNeighbors()) == (model.a, model.b, model.uid, 7)
    again = UMAPModel.load(path)
    np.testing.assert_array_equal(again.embedding, model.embedding)
    np.testing.assert_allclose(again.transform(x[:5]), model.transform(x[:5]), atol=1e-6)


def test_save_in_jax_load_in_the_port(rng, tmp_path):
    x, _ = _three_blobs(rng, n_per=20)
    ref = JaxUMAP().setNEpochs(20).setMinDist(0.3).setSeed(4).fit(x)
    path = str(tmp_path / "umap")
    ref.save(path)
    model = UMAPModel.load(path)
    np.testing.assert_array_equal(model.embedding, ref.embedding)
    assert (model.a, model.b, model.uid, model.getMinDist()) == (ref.a, ref.b, ref.uid, 0.3)


def test_dataframe_and_pandas_shims(rng):
    pd = pytest.importorskip("pandas")
    x, _ = _three_blobs(rng, n_per=15)
    df = DataFrame({"features": list(x)})
    model = UMAP().setNEpochs(20).setSeed(5).fit(df)
    out = model.transform(df)
    assert "embedding" in out.columns and len(out.select("embedding")) == len(x)
    frame = pd.DataFrame({"features": list(x[:6])})
    out = model.setOutputCol("emb").transform(frame)
    assert list(out.columns) == ["features", "emb"] and np.asarray(out["emb"].tolist()).shape == (6, 2)


def test_defaults_equal_the_reference():
    port, ref = UMAP(), JaxUMAP()
    assert {p.name: v for p, v in port._defaultParamMap.items()} == \
        {p.name: v for p, v in ref._defaultParamMap.items()}
    assert len(port._defaultParamMap) == 15
    for n in (5_000, 10_000, 10_001, 50_000):
        assert port._auto_epochs(n) == ref._auto_epochs(n)


@pytest.mark.parametrize(
    "setter,value,match",
    [("setNNeighbors", 1, "nNeighbors must be >= 2"), ("setNComponents", 0, "nComponents must be >= 1"),
     ("setMetric", "mahalanobis", "metric must be euclidean or cosine"),
     ("setInit", "pca", "init must be spectral or random"),
     ("setNegativePoolSize", -1, "negativePoolSize must be >= 0"),
     ("setBuildAlgo", "ivf", "buildAlgo must be brute|brute_approx")],
)
def test_validation_messages_equal_the_reference(setter, value, match):
    for cls in (UMAP, JaxUMAP):
        with pytest.raises(ValueError, match=match):
            getattr(cls(), setter)(value)


def test_fit_refusals(rng):
    with pytest.raises(ValueError, match="at least 3 rows"):
        UMAP().fit(np.zeros((2, 3)))
    x = rng.normal(size=(30, 5))
    with pytest.raises(ValueError, match="shape"):
        UMAP().setNNeighbors(5).setInitEmbedding(np.zeros((10, 2))).fit(x)
    # A mesh fit is ported since (tests/test_torch_mesh_neighbours.py holds
    # it); only a gang of several processes is refused.
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

    gang = np.empty((1, 1), dtype=object)
    gang[0, 0] = torch.device("cpu")
    with pytest.raises(NotImplementedError, match=r"item 18 \(gang\)"):
        UMAP(mesh=Mesh(gang, processes=2)).setNNeighbors(5).fit(x)


def test_copy_keeps_the_init_embedding(rng):
    x = rng.normal(size=(30, 5))
    y0 = rng.uniform(-1, 1, size=(30, 2))
    est = UMAP().setNNeighbors(5).setNEpochs(2).setInitEmbedding(y0)
    assert np.array_equal(est.copy()._init_embedding, y0.astype(np.float32))
    assert est.copy().fit(x).embedding.shape == (30, 2)


# --- the torch trustworthiness --------------------------------------------


@pytest.mark.parametrize("n,d,k", [(120, 10, 5), (200, 4, 10), (90, 30, 12)])
def test_trustworthiness_matches_sklearn(rng, n, d, k):
    manifold = pytest.importorskip("sklearn.manifold")
    x = rng.normal(size=(n, d))
    emb = x[:, :2] + 0.5 * rng.normal(size=(n, 2))
    want = manifold.trustworthiness(x, emb, n_neighbors=k)
    assert abs(trustworthiness(torch.from_numpy(x), torch.from_numpy(emb), k) - want) <= 1e-12
