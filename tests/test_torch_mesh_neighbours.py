"""The port's sharded neighbours, ANN, UMAP layout, DBSCAN and forests
against the JAX package's mesh routes, on the same numpy inputs.

The JAX side runs on its 8 virtual CPU devices, the port on (8, 1) and
(4, 2) meshes of one repeated CPU device. Data from a numpy seed: n = 203
(no mesh shape divides it) and n = 5 (below the data axis, so whole shards
are padding). Tolerances:

  - kNN, ANN and DBSCAN indices, labels and core masks: exact; distances
    1e-10 in float64, 1e-5 in float32, against JAX and against the port's
    single-device search (CPU GEMMs of other shapes may round otherwise).
  - The mesh-built IVF / PQ index against the port's single-device build
    (the quantizer's draws are the port's own): lists, ids and codes
    exact, centroids and codebooks 1e-10 in float64.
  - The UMAP sharded epoch: 1e-5 from JAX's with JAX's pool (or per-shard
    draws) passed in, and 1e-6 from the port's single-device epoch.
  - Forests: classification bitwise with JAX's draws passed in;
    regression as the single-device tests hold it (leaves 1e-5, gains
    1e-4, structure exact).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import neighbors as jax_neighbors
from spark_rapids_ml_tpu.clustering import DBSCAN as JaxDBSCAN
from spark_rapids_ml_tpu.models.umap import _knn_excluding_self as jax_excluding_self
from spark_rapids_ml_tpu.ops import ann as jax_ann
from spark_rapids_ml_tpu.ops import dbscan as jax_dbscan
from spark_rapids_ml_tpu.ops import knn as jax_knn
from spark_rapids_ml_tpu.ops import trees as jax_trees
from spark_rapids_ml_tpu.ops import umap as jax_umap
from spark_rapids_ml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.clustering import DBSCAN
from spark_rapids_ml_tpu_torch.manifold import UMAP
from spark_rapids_ml_tpu_torch.models.umap import _knn_excluding_self
from spark_rapids_ml_tpu_torch.neighbors import ApproximateNearestNeighbors, NearestNeighbors
from spark_rapids_ml_tpu_torch.ops import ann, dbscan, knn, trees, umap
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.utils.testing import assert_close, trustworthiness

CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2)]
SIZES = [203, 5]
D = 7
_RNG = np.random.default_rng(1616)
X = _RNG.normal(size=(203, D)) * np.linspace(1.0, 2.0, D)
X[:70] += 4.0
Q = _RNG.normal(size=(13, D)) + 1.0


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def port_mesh(shape):
    return make_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def jax_mesh(shape=(8, 1)):
    return jax_make_mesh(shape)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _hold(name, got, want, rtol):
    gd, gi = (_np(a) for a in got)
    wd, wi = (_np(a) for a in want)
    assert np.array_equal(gi, wi), f"{name}: indices differ in {np.sum(gi != wi)} places"
    assert_close(f"{name} distances", gd, wd, rtol=rtol, atol=rtol * 1e-2)


def _same(name, got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), name


# --- kNN (11a) ---------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
@pytest.mark.parametrize("shape", MESHES)
def test_knn_sharded_matches_jax(shape, metric, dtype, n):
    x, q, k = X[:n].astype(dtype), Q.astype(dtype), min(4, n)
    xs, mask = knn.shard_items(x, port_mesh(shape), metric=metric)
    assert len(xs) == shape[0] and all(int(b.shape[0]) == -(-n // shape[0]) for b in xs)
    got = knn.knn_sharded(torch.from_numpy(q), xs, mask, port_mesh(shape), k, metric=metric)
    jxs, jmask = jax_knn.shard_items(x, jax_mesh(shape), metric=metric)
    want = jax_knn.knn_sharded(jnp.asarray(q), jxs, jmask, jax_mesh(shape), k=k, metric=metric)
    assert got[1].dtype == torch.int32
    _hold(f"{shape}/{metric}", got, want, 1e-10 if dtype == np.float64 else 1e-5)
    single = knn.knn(torch.from_numpy(q), torch.from_numpy(x), k, metric=metric)
    _hold("single device", got, single, 1e-10 if dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_knn_sharded_approx_is_the_exact_search(shape):
    xs, mask = knn.shard_items(X[:170], port_mesh(shape))
    q = torch.from_numpy(Q[:9])
    _same("approx", knn.knn_sharded(q, xs, mask, port_mesh(shape), 4, approx=True),
          knn.knn_sharded(q, xs, mask, port_mesh(shape), 4))


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
@pytest.mark.parametrize("shape", MESHES)
def test_the_nearest_neighbors_mesh_model_matches_jax(shape, metric):
    ours = NearestNeighbors(mesh=port_mesh(shape)).setK(5).setMetric(metric).fit(torch.from_numpy(X))
    assert ours.mesh is not None
    got = ours.kneighbors(torch.from_numpy(Q))
    want = jax_neighbors.NearestNeighbors(mesh=jax_mesh(shape)).setK(5).setMetric(metric).fit(X).kneighbors(Q)
    _hold(f"{shape}/{metric}", got, want, 1e-10)
    _hold("single device", got, NearestNeighbors().setK(5).setMetric(metric).fit(torch.from_numpy(X))
          .kneighbors(torch.from_numpy(Q)), 1e-10)
    d, idx = ours.kneighbors(Q)  # host queries compute in float32
    assert d.dtype == np.float32 and np.array_equal(idx, np.asarray(want[1]))


def test_the_mesh_upload_is_kept_per_metric_and_dropped_by_set_mesh():
    model = NearestNeighbors().setK(3).fit(X).setMesh(port_mesh((8, 1)))
    model.kneighbors(Q)
    first = model._sharded
    model.kneighbors(Q)
    assert model._sharded is first
    model.set(model.metric, "cosine")
    model.kneighbors(Q)
    assert model._sharded is not first and model._sharded[0][0] == "cosine"
    model.setMesh(port_mesh((4, 2)))
    assert model._sharded is None


# --- ANN (13) ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_index(kind):
    if kind == "ivfpq":
        return jax_ann.build_ivfpq_index(X, n_lists=6, m_subspaces=7, n_bits=5, seed=0)
    return jax_ann.build_ivf_index(X, n_lists=6, seed=0)


def _carried(jindex):
    cls = ann.IVFPQIndex if isinstance(jindex, jax_ann.IVFPQIndex) else ann.IVFIndex
    return cls(*(torch.from_numpy(np.array(a)) for a in jindex))


@pytest.mark.parametrize("nq", [13, 3])
@pytest.mark.parametrize("kind", ["ivfflat", "ivfpq"])
@pytest.mark.parametrize("shape", MESHES)
def test_ann_search_sharded_matches_jax_on_its_index(shape, kind, nq):
    jindex = _jax_index(kind)
    q = Q[:nq]
    got = ann.ann_search_sharded(port_mesh(shape), _carried(jindex), torch.from_numpy(q), 4, 3)
    want = jax_ann.ann_search_sharded(jax_mesh(shape), jindex, jnp.asarray(q), k=4, n_probe=3)
    _hold(f"{shape}/{kind}", got, want, 1e-10)
    single = ann.dispatch_search(_carried(jindex))(_carried(jindex), torch.from_numpy(q), 4, 3)
    _hold("single device", got, single, 1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["ivfflat", "ivfpq"])
@pytest.mark.parametrize("shape", MESHES)
def test_the_mesh_built_index_is_the_single_device_build(shape, kind, dtype):
    items = torch.from_numpy(X.astype(dtype))
    if kind == "ivfpq":
        build = functools.partial(ann.build_ivfpq_index, items, 6, 7, n_bits=5, seed=2, kmeans_iters=4, pq_iters=4)
    else:
        build = functools.partial(ann.build_ivf_index, items, 6, seed=2, kmeans_iters=4)
    ours, single = build(mesh=port_mesh(shape)), build()
    tol = 1e-10 if dtype == np.float64 else 1e-5
    for field, a, b in zip(single._fields, ours, single):
        if a.is_floating_point() and field != "list_mask":
            assert_close(field, a, b, rtol=tol, atol=tol)
        else:
            assert torch.equal(a, b), field


def test_the_mesh_quantizer_blocks_its_assignment_past_the_reference_rule(monkeypatch):
    from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

    items = torch.from_numpy(X)
    single = ann.build_ivf_index(items, 6, seed=1)
    monkeypatch.setattr(ann, "BLOCKED_ASSIGN_BYTES", 100)
    before = counter_value("ann.quantizer.blocked_assign")
    ours = ann.build_ivf_index(items, 6, seed=1, mesh=port_mesh((8, 1)))
    assert counter_value("ann.quantizer.blocked_assign") == before + 1
    assert torch.equal(ours.list_ids, single.list_ids)


ALGOS = {
    "ivfflat": {"nlist": 6, "nprobe": 3},
    "ivfpq": {"nlist": 6, "nprobe": 3, "M": 7, "n_bits": 5, "refine_ratio": 3},
    "brute": {},
    "brute_approx": {},
}


def _jax_ann(algo, metric, mesh=None):
    est = jax_neighbors.ApproximateNearestNeighbors(mesh=mesh).setK(4).setAlgorithm(algo)
    return est.setMetric(metric).setAlgoParams(ALGOS[algo]).setSeed(3).fit(X)


def _carry(jmodel):
    params = {p.name: v for p, v in jmodel.extractParamMap().items()}
    index = None if jmodel._index is None else {f: np.asarray(getattr(jmodel._index, f))
                                                for f in jmodel._index._fields}
    return interop.approximate_nearest_neighbors_model_from_numpy(
        np.asarray(jmodel.items), uid=jmodel.uid, params=params, index=index)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("shape", MESHES)
def test_the_ann_mesh_search_matches_jax_on_a_carried_model(shape, algo, metric):
    jmodel = _jax_ann(algo, metric)
    ours = _carry(jmodel).setMesh(port_mesh(shape))
    got = ours.kneighbors(torch.from_numpy(Q))
    want = jmodel.setMesh(jax_mesh(shape)).kneighbors(Q)
    _hold(f"{shape}/{algo}/{metric}", got, want, 1e-10)


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("shape", MESHES)
def test_the_ann_mesh_fit_is_the_single_device_fit(shape, algo):
    est = ApproximateNearestNeighbors(mesh=port_mesh(shape)).setK(4).setAlgorithm(algo)
    ours = est.setAlgoParams(ALGOS[algo]).setSeed(3).fit(torch.from_numpy(X))
    assert ours.mesh is not None
    single = ApproximateNearestNeighbors().setK(4).setAlgorithm(algo).setAlgoParams(ALGOS[algo]).setSeed(3)
    single = single.fit(torch.from_numpy(X))
    got, want = ours.kneighbors(torch.from_numpy(Q)), single.kneighbors(torch.from_numpy(Q))
    _hold(f"{shape}/{algo}", got, want, 1e-10)
    if algo == "brute":  # nothing drawn: the reference's mesh fit too
        _hold("jax", got, _jax_ann(algo, "euclidean", jax_mesh(shape)).kneighbors(Q), 1e-10)


# --- UMAP (12b, A.12b) -----------------------------------------------------------------

UM_N, UM_K, UM_DIM = 203, 6, 2


@functools.lru_cache(maxsize=None)
def _graphs(n):
    x = X[:n].astype(np.float32)
    k = min(UM_K, n - 1)
    jd, ji = jax_excluding_self(jnp.asarray(x), k, "euclidean")
    jgraph = jax_umap.fuzzy_simplicial_set(ji, jd)
    pgraph = umap.FuzzyGraph(*(torch.from_numpy(np.array(a)) for a in jgraph))
    y0 = np.random.default_rng(n).uniform(-10, 10, size=(n, UM_DIM)).astype(np.float32)
    return jgraph, pgraph, y0


LAYOUT = dict(neg_rate=3, learning_rate=1.0, repulsion=1.0, a=1.577, b=0.895)


def _jax_draws(n, n_local, k, neg_pool, n_epochs, dp, key):
    """The negatives JAX's sharded epoch draws: the pool from the unfolded
    key, or each shard's (n_local, k, neg_rate) from its folded key."""
    if neg_pool > 0:
        out = []
        for _ in range(n_epochs):
            key, k_neg = jax.random.split(key)
            out.append(torch.from_numpy(np.array(jax.random.randint(k_neg, (neg_pool,), 0, n))).long())
        return out
    keys = [jax.random.fold_in(key, i) for i in range(dp)]
    out = []
    for _ in range(n_epochs):
        epoch = []
        for i in range(dp):
            keys[i], k_neg = jax.random.split(keys[i])
            draw = jax.random.randint(k_neg, (n_local, k, LAYOUT["neg_rate"]), 0, n)
            epoch.append(torch.from_numpy(np.array(draw)).long().reshape(n_local * k, -1))
        out.append(epoch)
    return out


def _grid(n, spacing=1.5):
    """n points of a jittered square grid, any two at least 1.1 apart."""
    rng = np.random.default_rng(n + 1)
    side = int(np.ceil(np.sqrt(n)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)), axis=-1).reshape(-1, 2)[:n]
    pts = (cells - (side - 1) / 2.0) * spacing + rng.uniform(-0.2, 0.2, size=(n, 2))
    return pts[rng.permutation(n)].astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("neg_pool", [16, 0])
@pytest.mark.parametrize("shape", MESHES)
def test_the_sharded_epoch_matches_jax_with_its_draws(shape, neg_pool, n):
    """As ``tests/test_torch_umap.py``'s one-epoch tests: the pooled
    gradient ``rowsum(c)·y − c @ pool`` cancels in float32 for a row drawn
    into its own pool, so in pooled mode the layout starts from a jittered
    grid and the rows JAX draws into the pool weigh 0; the per-edge mode
    runs two epochs from a random layout."""
    jgraph, pgraph, y0 = _graphs(n)
    n_epochs, key = (1, jax.random.key(5)) if neg_pool else (2, jax.random.key(5))
    epoch, n_pad = umap._make_sharded_epoch_fn(port_mesh(shape), pgraph, n_epochs=n_epochs,
                                                neg_pool=neg_pool, **LAYOUT)
    k = int(pgraph.indices.shape[1])
    draws = _jax_draws(n, n_pad // shape[0], k, neg_pool, n_epochs, shape[0], key)
    if neg_pool:
        y0 = _grid(n)
        w = pgraph.weight.clone()
        w[torch.cat(draws).unique()] = 0.0
        pgraph = pgraph._replace(weight=w)
        jgraph = jgraph._replace(weight=jnp.asarray(w.numpy()))
        epoch, n_pad = umap._make_sharded_epoch_fn(port_mesh(shape), pgraph, n_epochs=n_epochs,
                                                    neg_pool=neg_pool, **LAYOUT)
    want = jax_umap.optimize_layout_sharded(jax_mesh(shape), jnp.asarray(y0), jgraph, key, n_epochs=n_epochs,
                                            neg_pool=neg_pool, **LAYOUT)
    y = torch.nn.functional.pad(torch.from_numpy(y0), (0, 0, 0, n_pad - n))
    for ep, neg in enumerate(draws):
        y = epoch(ep, y, neg)
    assert torch.all(y[n:] == 0)
    assert_close("sharded layout", y[:n], np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shape", MESHES)
def test_the_sharded_epoch_is_the_single_device_epoch(shape, n):
    _, pgraph, y0 = _graphs(n)
    kw = dict(n_epochs=4, neg_pool=16, **LAYOUT)
    single = umap._make_epoch_fn((n, UM_DIM), pgraph, None, move_other=True, **kw)
    sharded, n_pad = umap._make_sharded_epoch_fn(port_mesh(shape), pgraph, **kw)
    y = torch.from_numpy(y0)
    pool = torch.from_numpy(np.random.default_rng(3).integers(0, n, 16))
    for ep in range(2):
        want = single(ep, y, pool)
        got = sharded(ep, torch.nn.functional.pad(y, (0, 0, 0, n_pad - n)), pool)[:n]
        assert_close(f"epoch {ep}", got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
        y = want


@pytest.mark.parametrize("shape", MESHES)
def test_optimize_layout_sharded_draws_the_single_device_pool(shape):
    _, pgraph, y0 = _graphs(UM_N)
    kw = dict(n_epochs=1, neg_pool=16, **LAYOUT)
    got = umap.optimize_layout_sharded(port_mesh(shape), torch.from_numpy(y0), pgraph,
                                       torch.Generator().manual_seed(4), **kw)
    want = umap.optimize_layout(torch.from_numpy(y0), pgraph, torch.Generator().manual_seed(4), **kw)
    assert_close("one epoch", got, want, rtol=1e-6, atol=1e-5)
    per_edge = dict(kw, neg_pool=0)
    a = umap.optimize_layout_sharded(port_mesh(shape), torch.from_numpy(y0), pgraph, None, seed=9, **per_edge)
    b = umap.optimize_layout_sharded(port_mesh(shape), torch.from_numpy(y0), pgraph, None, seed=9, **per_edge)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", MESHES)
def test_the_mesh_knn_graph_is_the_single_device_graph(shape):
    x = torch.from_numpy(X[:101].astype(np.float32))
    d_s, i_s = _knn_excluding_self(x, 8, "euclidean", port_mesh(shape))
    d_u, i_u = _knn_excluding_self(x, 8, "euclidean")
    _hold("graph", (d_s, i_s), (d_u, i_u), 1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_a_mesh_umap_fit_separates_the_blobs_as_the_single_device_fit(shape, monkeypatch):
    monkeypatch.setenv("TPUML_UMAP_SCATTER", "xla")
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(size=(40, 8)) + off for off in (0.0, 10.0)])
    est = dict(n=8, epochs=60)
    ours = UMAP(mesh=port_mesh(shape)).setNNeighbors(est["n"]).setNEpochs(est["epochs"]).setSeed(0).fit(x)
    single = UMAP().setNNeighbors(est["n"]).setNEpochs(est["epochs"]).setSeed(0).fit(x)
    emb = ours.embedding
    labels = np.repeat([0, 1], 40)
    c0, c1 = emb[labels == 0].mean(0), emb[labels == 1].mean(0)
    assert np.linalg.norm(c0 - c1) > 2 * np.mean(np.linalg.norm(emb[labels == 0] - c0, axis=1))
    t_mesh = trustworthiness(torch.from_numpy(x), torch.from_numpy(emb), 5)
    t_single = trustworthiness(torch.from_numpy(x), torch.from_numpy(single.embedding), 5)
    assert t_mesh > 0.85 and abs(t_mesh - t_single) <= 0.03


# --- DBSCAN --------------------------------------------------------------------------


def _blobs(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [rng.normal(size=(45, 3)) * 0.2 + c for c in ([0, 0, 0], [3, 3, 0], [0, 3, 3])]
        + [rng.uniform(-2, 5, size=(10, 3))])


@pytest.mark.parametrize("block", [(2048, 8192), (16, 32)])
@pytest.mark.parametrize("n", [145, 5])
@pytest.mark.parametrize("shape", MESHES)
def test_dbscan_labels_sharded_matches_jax(shape, n, block):
    x = _blobs(0)[:n]
    got = dbscan.dbscan_labels_sharded(port_mesh(shape), torch.from_numpy(x), 0.7, 4,
                                       block_q=block[0], block_i=block[1])
    want = jax_dbscan.dbscan_labels_sharded(jax_mesh(shape), x, 0.7, 4, block_q=block[0], block_i=block[1])
    for g, w, name in zip(got, want, ("labels", "core")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    single = dbscan.dbscan_labels(torch.from_numpy(x), 0.7, 4, return_sweeps=True)
    sharded = dbscan.dbscan_labels_sharded(port_mesh(shape), x, 0.7, 4, return_sweeps=True)
    assert sharded[2] == single[2]
    _same("single device", sharded[:2], single[:2])


def test_a_dbscan_chain_propagates_on_the_mesh():
    x = np.stack([np.arange(400) * 0.5, np.zeros(400)], axis=1)
    labels, core = dbscan.dbscan_labels_sharded(port_mesh((8, 1)), x, 0.6, 2)
    assert torch.all(core) and torch.all(labels == 0)


@pytest.mark.parametrize("shape", MESHES)
def test_the_dbscan_mesh_estimator_matches_jax(shape):
    x = _blobs(1)
    ours = DBSCAN(mesh=port_mesh(shape)).setEps(0.7).setMinSamples(4).fit(x)
    want = JaxDBSCAN(mesh=jax_mesh(shape)).setEps(0.7).setMinSamples(4).fit(x)
    assert np.array_equal(ours.labels_, want.labels_) and np.array_equal(ours.core_mask_, want.core_mask_)
    assert len(set(ours.labels_[ours.labels_ >= 0])) == 3


# --- forests -------------------------------------------------------------------------


def _forest_task(kind, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    if kind == "variance":
        y = (2 * x[:, 0] - x[:, 2] + 0.1 * rng.normal(size=n)).astype(np.float32)
        yc = y - y.mean()
        rs = np.stack([np.ones_like(yc), yc, yc * yc], 1).astype(np.float32)
    else:
        rs = np.eye(2, dtype=np.float32)[(x[:, 0] + 0.5 * x[:, 1] > 0).astype(int)]
    return x, rs


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["gini", "entropy", "variance"])
@pytest.mark.parametrize("shape", MESHES)
def test_grow_forest_sharded_matches_jax_with_its_draws(shape, kind, n):
    x, rs = _forest_task(kind, n)
    T, depth, B = 4, 3, 8
    k_sample, k_feat = jax.random.split(jax.random.key(n))
    w = np.array(jax_trees.sample_weights(k_sample, T, n, 1.0, True))
    edges = jax_trees.quantize_features(jnp.asarray(x), B)
    xb = jax_trees.bin_features(jnp.asarray(x), edges)
    kw = dict(max_depth=depth, n_bins=B, impurity=kind, feat_subset=4)
    want = jax_trees.grow_forest_sharded(jax_mesh(shape), xb, jnp.asarray(rs), jnp.asarray(w),
                                         edges.astype(jnp.float32), k_feat, **kw)
    uniforms = [torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(k_feat, level), (T, 2 ** level, 6))))
                for level in range(depth)]
    args = (torch.from_numpy(np.array(xb)), torch.from_numpy(rs), torch.from_numpy(w),
            torch.from_numpy(np.array(edges)))
    got = trees.grow_forest_sharded(port_mesh(shape), *args, uniforms, **kw)
    single = trees.grow_forest(*args, uniforms, **kw)
    for field in trees.Forest._fields:
        g, s, wv = getattr(got, field), getattr(single, field), np.asarray(getattr(want, field))
        if kind == "gini" or field in ("feature", "threshold", "is_leaf"):
            assert np.array_equal(g.numpy(), wv), field
        elif kind == "entropy":
            assert_close(field, g, wv, rtol=1e-6, atol=1e-6)
        else:
            assert_close(field, g, wv, rtol=1e-4, atol=1e-5)
        if kind != "variance":
            assert torch.equal(g, s), field


@pytest.mark.parametrize("shape", MESHES)
def test_the_forest_mesh_estimators_are_the_single_device_fits(shape):
    from spark_rapids_ml_tpu_torch.classification import RandomForestClassifier
    from spark_rapids_ml_tpu_torch.regression import RandomForestRegressor

    rng = np.random.default_rng(3)
    x = rng.normal(size=(203, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(float)
    ours = RandomForestClassifier(mesh=port_mesh(shape)).setNumTrees(5).setMaxDepth(4).setSeed(3).fit((x, y))
    single = RandomForestClassifier().setNumTrees(5).setMaxDepth(4).setSeed(3).fit((x, y))
    _same("classifier", ours._forest, single._forest)
    assert np.array_equal(ours.predict(x), single.predict(x))
    y_reg = 2.0 * x[:, 0] - x[:, 2]
    est = RandomForestRegressor().setNumTrees(8).setMaxDepth(6).setFeatureSubsetStrategy("all").setSeed(1)
    reg = est.copy().setMesh(port_mesh(shape)).fit((x, y_reg))
    rmse = np.sqrt(np.mean((reg.predict(x) - y_reg) ** 2))
    rmse_single = np.sqrt(np.mean((est.fit((x, y_reg)).predict(x) - y_reg) ** 2))
    assert rmse < 0.6 and abs(rmse - rmse_single) <= 0.01 * rmse_single
