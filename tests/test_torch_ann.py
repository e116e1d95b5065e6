"""The port's IVF-Flat / IVF-PQ (``ops/ann.py``), ``assign_clusters_blocked``
(``ops/kmeans.py``) and ``ApproximateNearestNeighbors`` against the JAX
package's, on the same numpy inputs.

The quantizer's draws are threefry in JAX and cannot be reproduced in
torch, so the searches are held on the reference's index carried across:
the same indices, distances within 1e-10 (float64). The port's own build
is held to what the reference's tests ask of any build: exact at full
probe, the recall bars of ``tests/test_ann.py`` at partial probe, ADC
distances that are the index's own quantized distances, and the packing
bit for bit given the same list labels.
"""

import functools
import pickle

import cloudpickle
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu import neighbors as jax_neighbors
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.models import approximate_nearest_neighbors as jax_ann_model
from spark_rapids_ml_tpu.ops import ann as jax_ann
from spark_rapids_ml_tpu.ops import kmeans as jax_kmeans
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.core.data import DataFrame
from spark_rapids_ml_tpu_torch.models import approximate_nearest_neighbors as ann_model
from spark_rapids_ml_tpu_torch.neighbors import ApproximateNearestNeighbors, ApproximateNearestNeighborsModel
from spark_rapids_ml_tpu_torch.ops import ann, knn
from spark_rapids_ml_tpu_torch.ops import kmeans as port_kmeans
from spark_rapids_ml_tpu_torch.utils.testing import assert_close
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

N, D, NQ = 300, 8, 25
RNG = np.random.default_rng(31)
ITEMS = RNG.standard_normal((N, D)) + 0.2
QUERIES = RNG.standard_normal((NQ, D))


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def recall(approx_idx, exact_idx):
    approx_idx, exact_idx = np.asarray(approx_idx), np.asarray(exact_idx)
    hits = sum(len(set(a.tolist()) & set(e.tolist())) for a, e in zip(approx_idx, exact_idx))
    return hits / exact_idx.size


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_ivf(n_lists, dtype=np.float64):
    return jax_ann.build_ivf_index(ITEMS.astype(dtype), n_lists=n_lists, seed=0)


@functools.lru_cache(maxsize=None)
def _jax_ivfpq(n_lists, m, n_bits=6):
    return jax_ann.build_ivfpq_index(ITEMS, n_lists=n_lists, m_subspaces=m, n_bits=n_bits, seed=0)


def _carried(jindex):
    cls = ann.IVFPQIndex if isinstance(jindex, jax_ann.IVFPQIndex) else ann.IVFIndex
    return cls(*(_t(a) for a in jindex))


def _hold(name, got, want, rtol=1e-10):
    gd, gi = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in got)
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    assert gi.dtype == np.int32, name
    assert np.array_equal(gi, wi), f"{name}: indices differ in {np.sum(gi != wi)} places"
    finite = np.isfinite(wd)
    assert np.array_equal(finite, np.isfinite(gd)), name
    assert_close(f"{name} distances", gd[finite], wd[finite], rtol=rtol, atol=1e-12)


# --- packing -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_lists", [1, 7, 16])
def test_pack_lists_is_the_reference_packing(n_lists, dtype):
    jindex = _jax_ivf(n_lists, dtype)
    ids = np.asarray(jindex.list_ids)
    labels = np.empty(N, dtype=np.int64)
    for lid in range(n_lists):
        labels[ids[lid][ids[lid] >= 0]] = lid
    lists, mask, list_ids = ann._pack_lists(ITEMS.astype(dtype), labels, n_lists)
    for got, want in ((lists, jindex.lists), (mask, jindex.list_mask), (list_ids, jindex.list_ids)):
        want = np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# --- searches on a carried index -----------------------------------------------------


@pytest.mark.parametrize("block_q", [7, 1024])
@pytest.mark.parametrize("k", [5, 60])
@pytest.mark.parametrize("n_probe", [1, 3, 10])
def test_ivf_search_on_the_reference_index(n_probe, k, block_q):
    jindex = _jax_ivf(10)
    got = ann.ivf_search(_carried(jindex), torch.from_numpy(QUERIES), k, n_probe, block_q=block_q)
    want = jax_ann.ivf_search(jindex, jnp.asarray(QUERIES), k=k, n_probe=n_probe, block_q=block_q)
    _hold(f"ivf probe {n_probe} k {k}", got, want)


@pytest.mark.parametrize("n_probe", [1, 4, 8])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_ivfpq_search_on_the_reference_index(m, n_probe):
    jindex = _jax_ivfpq(8, m)
    got = ann.ivfpq_search(_carried(jindex), torch.from_numpy(QUERIES), 10, n_probe, block_q=16)
    want = jax_ann.ivfpq_search(jindex, jnp.asarray(QUERIES), k=10, n_probe=n_probe, block_q=16)
    _hold(f"ivfpq M {m} probe {n_probe}", got, want)


def test_dispatch_search():
    assert ann.dispatch_search(_carried(_jax_ivf(4))) is ann.ivf_search
    assert ann.dispatch_search(_carried(_jax_ivfpq(4, 2))) is ann.ivfpq_search


@pytest.mark.parametrize("block_q", [4, 1024])
@pytest.mark.parametrize("k", [1, 5])
def test_refine_exact_matches_the_reference(k, block_q):
    cand = RNG.integers(0, N, size=(NQ, 12)).astype(np.int32)
    cand[::3, -4:] = -1  # fill slots stay at +inf
    got = ann_model._refine_exact(torch.from_numpy(QUERIES), torch.from_numpy(ITEMS), torch.from_numpy(cand), k,
                                  block_q=block_q)
    want = jax_ann_model._refine_exact(jnp.asarray(QUERIES), jnp.asarray(ITEMS), jnp.asarray(cand), k,
                                       block_q=block_q)
    _hold(f"refine k {k}", got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("block_rows", [7, 64, 65536])
def test_assign_clusters_blocked_matches_the_reference(block_rows, dtype):
    x, c = ITEMS.astype(dtype), ITEMS[:9].astype(dtype) + 0.01
    labels, d2 = port_kmeans.assign_clusters_blocked(torch.from_numpy(x), torch.from_numpy(c), block_rows=block_rows)
    jl, jd2 = jax_kmeans.assign_clusters_blocked(jnp.asarray(x), jnp.asarray(c), block_rows=block_rows)
    assert np.array_equal(labels.numpy(), np.asarray(jl))
    assert_close("blocked d2", d2, np.asarray(jd2), rtol=1e-10 if dtype == np.float64 else 1e-5, atol=1e-5)
    whole, _ = port_kmeans.assign_clusters(torch.from_numpy(x), torch.from_numpy(c))
    assert torch.equal(labels, whole)


def test_assign_clusters_blocked_keeps_the_first_minimum():
    x = torch.zeros((5, 2), dtype=torch.float64)
    c = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]], dtype=torch.float64)
    labels, d2 = port_kmeans.assign_clusters_blocked(x, c, block_rows=2)
    assert labels.tolist() == [0] * 5 and d2.tolist() == [1.0] * 5


def test_the_quantizer_blocks_its_assignment_past_the_reference_rule(monkeypatch):
    monkeypatch.setattr(ann, "BLOCKED_ASSIGN_BYTES", 4 * N * 6 - 1)
    before = counter_value("ann.quantizer.blocked_assign")
    blocked = ann.build_ivf_index(ITEMS, 6, seed=2)
    assert counter_value("ann.quantizer.blocked_assign") == before + 1
    monkeypatch.setattr(ann, "BLOCKED_ASSIGN_BYTES", 4 * N * 6)
    whole = ann.build_ivf_index(ITEMS, 6, seed=2)
    assert counter_value("ann.quantizer.blocked_assign") == before + 1
    assert all(torch.equal(a, b) for a, b in zip(blocked, whole))


# --- the port's own build -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_lists", [1, 5, 12])
def test_full_probe_is_exact(n_lists, dtype):
    items, q = torch.from_numpy(ITEMS.astype(dtype)), torch.from_numpy(QUERIES.astype(dtype))
    index = ann.build_ivf_index(items, n_lists, seed=0)
    d2, idx = ann.ivf_search(index, q, 5, n_lists)
    rd, ri = knn.knn(q, items, 5, metric="sqeuclidean")
    assert torch.equal(idx, ri)
    assert_close("full probe", d2, rd, rtol=1e-10 if dtype == np.float64 else 1e-5, atol=1e-6)


def _clustered(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, 8)) * 10
    items = (centers[rng.integers(0, 20, 2000)] + rng.normal(size=(2000, 8))).astype(np.float32)
    return items, items[rng.integers(0, 2000, 100)] + 0.01


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partial_probe_recall(seed):
    items, q = _clustered(seed)
    index = ann.build_ivf_index(items, 20, seed=seed)
    _, idx = ann.ivf_search(index, torch.from_numpy(q), 10, 5)
    _, ref = knn.knn(torch.from_numpy(q), torch.from_numpy(items), 10, metric="sqeuclidean")
    assert recall(idx, ref) >= 0.9


def test_index_covers_all_items():
    index = ann.build_ivf_index(ITEMS[:257], 7, seed=1)
    ids = index.list_ids.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(257))
    assert np.array_equal(index.list_mask.numpy() > 0, ids >= 0)
    assert index.list_ids.dtype == torch.int32 and index.lists.dtype == torch.float64


def test_unfilled_slots_are_minus_one():
    index = ann.build_ivf_index(ITEMS[:50] * 10, 10, seed=0)
    d2, idx = ann.ivf_search(index, torch.from_numpy(ITEMS[:3] * 10), 40, 1)
    assert (idx == -1).any() and torch.isinf(d2[idx == -1]).all()
    # The (inf, -1) slots come last and the real ones ascend.
    real = d2[idx >= 0]
    assert torch.isfinite(real).all()


def test_query_blocking_gives_the_same_neighbours():
    index = ann.build_ivf_index(ITEMS, 6, seed=0)
    a = ann.ivf_search(index, torch.from_numpy(QUERIES), 4, 3, block_q=4)
    b = ann.ivf_search(index, torch.from_numpy(QUERIES), 4, 3, block_q=1024)
    # The centroid product's rounding may follow the block's row count.
    assert torch.equal(a[1], b[1])
    assert_close("blocked queries", a[0], b[0], rtol=1e-12, atol=1e-14)


def test_the_build_is_deterministic_and_the_seed_matters():
    a = ann.build_ivf_index(ITEMS, 6, seed=3)
    b = ann.build_ivf_index(ITEMS, 6, seed=3)
    c = ann.build_ivf_index(ITEMS, 6, seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.centroids, c.centroids)


def test_a_tensor_builds_the_index_of_its_host_copy():
    from_tensor = ann.build_ivfpq_index(torch.from_numpy(ITEMS.astype(np.float32)), 5, 4, seed=1)
    from_host = ann.build_ivfpq_index(ITEMS.astype(np.float32), 5, 4, seed=1)
    assert all(torch.equal(x, y) for x, y in zip(from_tensor, from_host))


VALIDATION = {
    "n_lists_zero": lambda m: m.build_ivf_index(ITEMS[:20], 0),
    "n_lists_over": lambda m: m.build_ivf_index(ITEMS[:20], 21),
    "m_not_dividing": lambda m: m.build_ivfpq_index(ITEMS[:50], 4, 3),
    "n_bits_over": lambda m: m.build_ivfpq_index(ITEMS[:50], 4, 2, n_bits=9),
    "n_bits_zero": lambda m: m.build_ivfpq_index(ITEMS[:50], 4, 2, n_bits=0),
}


@pytest.mark.parametrize("case", list(VALIDATION))
def test_validation_messages_match_the_reference(case):
    with pytest.raises(ValueError) as ours:
        VALIDATION[case](ann)
    with pytest.raises(ValueError) as theirs:
        VALIDATION[case](jax_ann)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n_probe", [0, 5])
def test_n_probe_out_of_range_matches_the_reference(n_probe):
    jindex = _jax_ivf(4)
    with pytest.raises(ValueError) as ours:
        ann.ivf_search(_carried(jindex), torch.from_numpy(QUERIES), 3, n_probe)
    with pytest.raises(ValueError) as theirs:
        jax_ann.ivf_search(jindex, jnp.asarray(QUERIES), k=3, n_probe=n_probe)
    assert str(ours.value) == str(theirs.value)


def test_the_mesh_search_waits_for_its_slice():
    """Ported since: the mesh search of the reference's index returns its
    single-device neighbours, and a mesh build is the port's single-device
    build up to the order of its sums."""
    mesh = _mesh()
    jindex = _jax_ivf(4)
    q = torch.from_numpy(QUERIES)
    _hold("mesh search", ann.ann_search_sharded(mesh, _carried(jindex), q, 5, 2),
          jax_ann.ivf_search(jindex, jnp.asarray(QUERIES), k=5, n_probe=2))
    built = ann.build_ivf_index(torch.from_numpy(ITEMS), 4, mesh=mesh)
    single = ann.build_ivf_index(torch.from_numpy(ITEMS), 4)
    assert torch.equal(built.list_ids, single.list_ids)
    assert_close("centroids", built.centroids, single.centroids, rtol=1e-10, atol=1e-12)


def _mesh():
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((4, 2), devices=[torch.device("cpu")] * 8)


# --- IVF-PQ ---------------------------------------------------------------------------


def test_codes_are_uint8_and_widen_for_the_gathers():
    index = ann.build_ivfpq_index(ITEMS[:100], 4, 4, n_bits=8)
    assert index.codes.dtype == torch.uint8 and index.codebooks.shape == (4, 100, 2)
    index = ann.build_ivfpq_index(ITEMS, 4, 4, n_bits=8)
    assert index.codebooks.shape == (4, 256, 2) and int(index.codes.max()) > 1


def _adc_f64(index, q, idx):
    """The index's own ADC distance of each returned item, in float64."""
    ids = index.list_ids.numpy()
    where = {int(i): (l, j) for l, j in zip(*np.nonzero(ids >= 0)) for i in [ids[l, j]]}
    cents, books, codes = (t.numpy().astype(np.float64) for t in (index.centroids, index.codebooks, index.codes))
    m_sub, _, ds = books.shape
    out = np.zeros(idx.shape)
    for r in range(idx.shape[0]):
        for c in range(idx.shape[1]):
            l, j = where[int(idx[r, c])]
            res = (q[r] - cents[l]).reshape(m_sub, ds)
            out[r, c] = sum(np.sum((res[m] - books[m, int(codes[l, j, m])]) ** 2) for m in range(m_sub))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_adc_distances_are_the_index_quantized_distances(dtype):
    items, q = ITEMS.astype(dtype), QUERIES.astype(dtype)
    index = ann.build_ivfpq_index(items, 4, 4, n_bits=8, seed=1)
    d2, idx = ann.ivfpq_search(index, torch.from_numpy(q), 5, 4)
    assert_close("adc", d2, _adc_f64(index, q.astype(np.float64), idx.numpy()),
                 rtol=1e-10 if dtype == np.float64 else 1e-4, atol=1e-5)
    for r in range(NQ):  # within quantization error of the true distance (tests/test_ann.py)
        for c in range(5):
            true = np.sum((q[r] - items[idx[r, c]]) ** 2)
            assert abs(float(d2[r, c]) - true) < max(1.0, 0.5 * true)


def test_recall_probe_all():
    items, queries = RNG.normal(size=(400, 16)), RNG.normal(size=(25, 16))
    model = (ApproximateNearestNeighbors().setAlgorithm("ivfpq")
             .setAlgoParams({"nlist": 8, "nprobe": 8, "M": 8, "n_bits": 6}).setK(10).setSeed(0).fit(items))
    d_pq, i_pq = model.kneighbors(queries)
    _, i_true = knn.knn(torch.from_numpy(queries), torch.from_numpy(items), 10, metric="sqeuclidean")
    assert recall(i_pq, i_true) >= 0.7
    assert np.all(np.diff(d_pq, axis=1) >= -1e-5)


def test_refine_improves_recall():
    items, queries = RNG.normal(size=(600, 32)), RNG.normal(size=(40, 32))
    _, i_true = knn.knn(torch.from_numpy(queries), torch.from_numpy(items), 10, metric="sqeuclidean")

    def rec(params):
        m = ApproximateNearestNeighbors().setAlgorithm("ivfpq").setAlgoParams(params).setK(10).setSeed(0).fit(items)
        return recall(m.kneighbors(queries)[1], i_true)

    base = {"nlist": 6, "nprobe": 6, "M": 8, "n_bits": 4}
    r_plain, r_refined = rec(base), rec({**base, "refine_ratio": 8})
    assert r_refined >= r_plain + 0.05 and r_refined >= 0.85


@pytest.mark.parametrize("d", [7, 10, 16, 96, 128])
def test_m_auto_divides_like_the_reference(d):
    ours, theirs = ApproximateNearestNeighborsModel(), jax_neighbors.ApproximateNearestNeighborsModel()
    assert ours._effective_m(d) == theirs._effective_m(d) and d % ours._effective_m(d) == 0


def test_an_explicit_bad_m_raises():
    with pytest.raises(ValueError, match="not divisible"):
        ApproximateNearestNeighbors().setAlgorithm("ivfpq").setAlgoParams({"nlist": 4, "M": 3}).fit(ITEMS[:50])


# --- the estimator -----------------------------------------------------------------------

ALGOS = {
    "ivfflat": {"nlist": 6, "nprobe": 3},
    "ivfpq": {"nlist": 6, "nprobe": 3, "M": 4, "n_bits": 6, "refine_ratio": 2},
    "brute": {},
    "brute_approx": {},
}


def _jax_model(algo, metric="euclidean", k=5, id_col=None, data=None):
    est = jax_neighbors.ApproximateNearestNeighbors().setK(k).setAlgorithm(algo).setMetric(metric)
    est = est.setAlgoParams(ALGOS[algo]).setSeed(7)
    if id_col:
        est = est.setIdCol(id_col)
    return est.fit(ITEMS if data is None else data)


def _carry(jmodel):
    params = {p.name: v for p, v in jmodel.extractParamMap().items()}
    index = None if jmodel._index is None else {f: np.asarray(getattr(jmodel._index, f))
                                                for f in jmodel._index._fields}
    ids = None if jmodel.ids is None else jmodel.ids
    return interop.approximate_nearest_neighbors_model_from_numpy(
        np.asarray(jmodel.items), ids=ids, uid=jmodel.uid, params=params, index=index)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_the_estimator_on_a_carried_index_matches_the_reference(algo, metric):
    jmodel = _jax_model(algo, metric)
    ours = _carry(jmodel)
    assert ours.getAlgorithm() == algo and ours.getAlgoParams() == ALGOS[algo] and ours.getSeed() == 7
    got = ours.kneighbors(torch.from_numpy(QUERIES))
    assert isinstance(got[0], torch.Tensor) and got[0].dtype == torch.float64
    _hold(f"{algo}/{metric}", got, jmodel.kneighbors(QUERIES))
    d, idx = ours.kneighbors(QUERIES)  # host queries compute in float32
    assert d.dtype == np.float32 and recall(idx, np.asarray(jmodel.kneighbors(QUERIES)[1])) >= 0.95


@pytest.mark.parametrize("algo", list(ALGOS))
def test_the_estimator_builds_its_own_index(algo):
    model = ApproximateNearestNeighbors().setK(5).setAlgorithm(algo).setAlgoParams(
        {**ALGOS[algo], "nprobe": 6}).fit(ITEMS)
    d, idx = model.kneighbors(torch.from_numpy(QUERIES))
    _, exact = knn.knn(torch.from_numpy(QUERIES), torch.from_numpy(ITEMS), 5, metric="euclidean")
    # Every list probed: ivfflat and brute are exact, ivfpq refined twice over.
    assert recall(idx, exact) >= (0.6 if algo == "ivfpq" else 1.0)
    assert (model._index is None) == algo.startswith("brute")


def test_device_items_are_indexed_where_they_live():
    host = ApproximateNearestNeighbors().setK(5).setAlgoParams(ALGOS["ivfflat"]).fit(ITEMS.astype(np.float32))
    dev = ApproximateNearestNeighbors().setK(5).setAlgoParams(ALGOS["ivfflat"]).fit(
        torch.from_numpy(ITEMS.astype(np.float32)))
    assert all(torch.equal(a, b) for a, b in zip(host._index, dev._index))
    q = torch.from_numpy(QUERIES.astype(np.float32))
    assert all(torch.equal(a, b) for a, b in zip(host.kneighbors(q), dev.kneighbors(q)))


def test_defaults_and_auto_nlist():
    est = ApproximateNearestNeighbors()
    assert est.getK() == 5 and est.getAlgorithm() == "ivfflat" and est.getMetric() == "euclidean"
    model = est.fit(RNG.normal(size=(400, 4)))
    assert model._index.n_lists == 20 and model._effective_nprobe(20) == 2


def test_cosine_full_probe_is_brute_cosine():
    items = torch.from_numpy(ITEMS)  # a float64 tensor builds a float64 index
    ivf = ApproximateNearestNeighbors().setK(4).setMetric("cosine").setAlgoParams({"nlist": 4, "nprobe": 4}).fit(items)
    brute = ApproximateNearestNeighbors().setK(4).setMetric("cosine").setAlgorithm("brute").fit(items)
    q = torch.from_numpy(ITEMS[:15])
    (d, i), (db, ib) = ivf.kneighbors(q), brute.kneighbors(q)
    assert torch.equal(i, ib) and torch.equal(i[:, 0], torch.arange(15, dtype=torch.int32))
    assert_close("cosine", d, db, rtol=1e-10, atol=1e-12)


PARAM_ERRORS = {
    "algorithm": lambda p: p.ApproximateNearestNeighbors().setAlgorithm("hnsw"),
    "metric": lambda p: p.ApproximateNearestNeighbors().setMetric("manhattan"),
    "algo_params": lambda p: p.ApproximateNearestNeighbors().setAlgoParams({"bogus": 1}),
    "k_zero": lambda p: p.ApproximateNearestNeighbors().setK(0),
    "k_over_items": lambda p: p.ApproximateNearestNeighbors().setK(N + 1).fit(ITEMS),
    "kneighbors_k": lambda p: p.ApproximateNearestNeighbors().setAlgorithm("brute").fit(ITEMS).kneighbors(
        QUERIES, k=N + 1),
    "id_col_on_a_matrix": lambda p: p.ApproximateNearestNeighbors().setIdCol("rid").fit(ITEMS),
    "no_items": lambda p: p.ApproximateNearestNeighborsModel().kneighbors(QUERIES),
    "one_shot_generator": lambda p: p.ApproximateNearestNeighbors().fit(b for b in [ITEMS]),
    "streamed_ivf": lambda p: p.ApproximateNearestNeighbors().fit(lambda: iter([ITEMS])),
}


@pytest.mark.parametrize("case", list(PARAM_ERRORS))
def test_errors_match_the_reference(case):
    from spark_rapids_ml_tpu_torch import neighbors as port_neighbors

    def message(pkg):
        try:
            PARAM_ERRORS[case](pkg)
        except (ValueError, RuntimeError) as exc:
            return type(exc), str(exc)
        raise AssertionError("no error raised")

    assert message(port_neighbors) == message(jax_neighbors)


def test_ids_keep_minus_one_slots():
    frame = pd.DataFrame({"features": list(ITEMS * 10), "rid": np.arange(5000, 5000 + N)})
    params = {"nlist": 10, "nprobe": 1}
    jmodel = (jax_neighbors.ApproximateNearestNeighbors().setK(60).setIdCol("rid").setAlgoParams(params)
              .fit(frame))
    ours = _carry(jmodel)
    d, ids = ours.kneighbors_ids(torch.from_numpy(ITEMS[:5] * 10))
    jd, jids = jmodel.kneighbors_ids(ITEMS[:5] * 10)
    assert (ids == -1).any() and np.array_equal(ids, np.asarray(jids))


@pytest.mark.parametrize("kind", ["dataframe", "pandas"])
def test_transform_appends_the_reference_columns(kind):
    cols = {"features": list(ITEMS)}
    data, jdata = (DataFrame(cols), JaxDataFrame(cols)) if kind == "dataframe" else (pd.DataFrame(cols),) * 2
    jmodel = _jax_model("ivfflat", data=jdata)
    out, jout = _carry(jmodel).transform(data), jmodel.transform(jdata)
    assert list(out.columns) == list(jout.columns)
    col = (lambda f, c: f.select(c)) if kind == "dataframe" else (lambda f, c: list(f[c]))
    assert recall(np.stack(col(out, "ann_indices")), np.stack(col(jout, "ann_indices"))) >= 0.99


def test_a_streamed_brute_index_is_the_resident_one():
    blocks = [ITEMS[i:i + 64] for i in range(0, N, 64)]
    for algo in ("brute", "brute_approx"):
        streamed = ApproximateNearestNeighbors().setK(6).setAlgorithm(algo).fit(lambda: iter(blocks))
        resident = ApproximateNearestNeighbors().setK(6).setAlgorithm(algo).fit(torch.from_numpy(ITEMS))
        q = torch.from_numpy(QUERIES)
        assert all(torch.equal(a, b) for a, b in zip(streamed.kneighbors(q), resident.kneighbors(q)))
        theirs = jax_neighbors.ApproximateNearestNeighbors().setK(6).setAlgorithm(algo).fit(lambda: iter(blocks))
        _hold(f"streamed {algo}", streamed.kneighbors(q), theirs.kneighbors(jnp.asarray(QUERIES)))


def test_a_streamed_model_neither_pickles_nor_saves(tmp_path):
    ours = ApproximateNearestNeighbors().setAlgorithm("brute").fit(lambda: iter([ITEMS]))
    with pytest.raises(ValueError, match="does not pickle"):
        pickle.dumps(ours)
    with pytest.raises(ValueError, match="does not persist"):
        ours.write.overwrite().save(str(tmp_path / "m"))


def test_a_mesh_is_left_for_a_later_slice():
    """Ported since: every algorithm on a mesh (the estimator's, or one set
    on a fitted model) finds the single-device neighbours; a streamed
    index still refuses a mesh."""
    q = torch.from_numpy(QUERIES)
    for algo in ALGOS:
        est = ApproximateNearestNeighbors().setK(5).setAlgorithm(algo).setAlgoParams(ALGOS[algo])
        want = est.fit(ITEMS).kneighbors(q)
        _hold(f"mesh {algo}", est.copy().setMesh(_mesh()).fit(ITEMS).kneighbors(q), want)
        _hold(f"set mesh {algo}", est.fit(ITEMS).setMesh(_mesh()).kneighbors(q), want)
    with pytest.raises(ValueError, match="single-device"):
        ApproximateNearestNeighbors(mesh=_mesh()).setAlgorithm("brute").fit(lambda: iter([ITEMS]))


def test_a_pickled_model_rebuilds_the_same_index():
    model = ApproximateNearestNeighbors().setK(5).setAlgoParams(ALGOS["ivfflat"]).fit(ITEMS)
    back = cloudpickle.loads(cloudpickle.dumps(model))
    assert back._index is None
    q = torch.from_numpy(QUERIES)
    assert all(torch.equal(a, b) for a, b in zip(back.kneighbors(q), model.kneighbors(q)))


@pytest.mark.parametrize("algo", ["ivfflat", "ivfpq"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_save_load_both_ways(tmp_path, direction, algo):
    path = str(tmp_path / "ann")
    est = ApproximateNearestNeighbors().setK(4).setSeed(3).setAlgorithm(algo).setAlgoParams(ALGOS[algo])
    ours = est.fit(ITEMS)
    q = torch.from_numpy(QUERIES)
    if direction == "jax_to_port":
        _jax_model(algo).write.overwrite().save(path)
        loaded = ApproximateNearestNeighborsModel.load(path)
        assert loaded._index is None and loaded.getSeed() == 7
        # Rebuilt from the saved seed by the port: the port's own index.
        rebuilt = est.setSeed(7).fit(ITEMS)
        assert all(torch.equal(a, b) for a, b in zip(loaded.kneighbors(q, k=4), rebuilt.kneighbors(q)))
        return
    ours.write.overwrite().save(path)
    loader = jax_neighbors.ApproximateNearestNeighborsModel if direction == "port_to_jax" \
        else ApproximateNearestNeighborsModel
    loaded = loader.load(path)
    assert loaded.getAlgoParams() == ALGOS[algo] and loaded.getSeed() == 3 and loaded.getK() == 4
    assert np.array_equal(loaded.items, ITEMS)
    if direction == "port_to_port":
        assert all(torch.equal(a, b) for a, b in zip(loaded.kneighbors(q), ours.kneighbors(q)))
    else:  # the reference rebuilds its own index from the seed
        assert recall(loaded.kneighbors(QUERIES)[1], _jax_model(algo).kneighbors(QUERIES)[1]) >= 0.5


def test_interop_checks_the_index_fields():
    with pytest.raises(ValueError, match="index lacks"):
        interop.approximate_nearest_neighbors_model_from_numpy(ITEMS, index={"centroids": ITEMS[:2]})
