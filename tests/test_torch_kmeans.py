"""The port's KMeans slice against the JAX package: ``ops/kmeans.py``, the
estimator and model, ingest, data, persistence and interop.

Inputs are numpy from a seed and go through both packages (JAX x64 on the
CPU, as its own tests run). Tolerances:

- ``ops/kmeans.py`` in float64 (``assign_clusters``, ``lloyd_step``,
  ``lloyd``, ``block_suff_stats``, ``normalize_rows``): rtol 1e-10, atol
  1e-10 of the largest value (two BLAS sum orders of the same products);
  labels and iteration counts exactly.
- the estimator from the same ``setInitialModel`` centers: a float64
  tensor fits in float64 and is held at 1e-8 (centers) and 1e-10 (cost,
  relative); host numpy fits in the port's float32 default and the
  explicit ``fused`` route computes in float32, held at 1e-4 (centers)
  and 1e-5 (cost, relative) against the float64 reference.
- seeding cannot match JAX's threefry bits: held statistically, as
  tests/test_kmeans.py holds the reference (k distinct data rows; every
  planted center recovered within 1.0).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.clustering import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.core.data import extract_features as jax_extract_features
from spark_rapids_ml_tpu.core.data import extract_weights as jax_extract_weights
from spark_rapids_ml_tpu.ops import kmeans as jkm
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.clustering import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.core import ingest, persistence
from spark_rapids_ml_tpu_torch.core.data import DataFrame, extract_features, extract_weights
from spark_rapids_ml_tpu_torch.interop import kmeans_model_from_numpy
from spark_rapids_ml_tpu_torch.ops import kmeans as tkm
from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kk
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

F64 = {"rtol": 1e-10}


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _f64(want) -> dict:
    want = np.asarray(want)
    return {"rtol": 1e-10, "atol": 1e-10 * max(1.0, float(np.abs(want).max()))}


def make_blobs(seed, n=300, d=8, k=4, sep=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    labels = rng.integers(0, k, size=n)
    return centers[labels] + rng.normal(size=(n, d)), centers


def _pinned(x, k, seed=11):
    return x[np.random.default_rng(seed).choice(x.shape[0], k, replace=False)].copy()


# --- ops/kmeans.py, float64 -------------------------------------------------


@pytest.mark.parametrize("n,d,k", [(200, 5, 3), (1100, 16, 8), (37, 13, 7)])
def test_assign_clusters_matches_jax(n, d, k):
    x, _ = make_blobs(n, n=n, d=d, k=k)
    c = _pinned(x, k)
    jl, jd = jkm.assign_clusters(jnp.asarray(x), jnp.asarray(c))
    tl, td = tkm.assign_clusters(torch.from_numpy(x), torch.from_numpy(c))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert_close("assign_clusters d2", td, np.asarray(jd), **_f64(jd))


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_step_matches_jax(cosine, weighted):
    x, _ = make_blobs(3, n=500, d=6, k=5)
    if cosine:
        x = np.asarray(jkm.normalize_rows(jnp.asarray(x)))
    c = _pinned(x, 5)
    w = np.random.default_rng(4).uniform(0.0, 2.0, 500) if weighted else np.ones(500)
    x2 = (x * x).sum(axis=1)
    jc, jcost = jkm.lloyd_step(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), jnp.asarray(x2),
                               "highest", cosine=cosine)
    tc, tcost = tkm.lloyd_step(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c),
                               torch.from_numpy(x2), "highest", cosine=cosine)
    assert_close("lloyd_step centers", tc, np.asarray(jc), **_f64(jc))
    assert_close("lloyd_step cost", tcost, np.asarray(jcost), **F64)


@pytest.mark.parametrize("block_rows", [None, 128, 97])
@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_lloyd_matches_jax(block_rows, tol):
    x, _ = make_blobs(5, n=1100, d=16, k=8, sep=4.0)
    c = _pinned(x, 8)
    mask = np.ones(1100)
    jc, jcost, jit = jkm.lloyd(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(c), max_iter=15,
                               tol=tol, block_rows=block_rows)
    tc, tcost, tit = tkm.lloyd(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(c),
                               max_iter=15, tol=tol, block_rows=block_rows)
    assert tit == int(jit)
    assert_close("lloyd centers", tc, np.asarray(jc), **_f64(jc))
    assert_close("lloyd cost", tcost, np.asarray(jcost), **F64)


def test_lloyd_matches_the_numpy_oracle():
    """tests/test_kmeans.py's exact-Lloyd oracle, from the same init."""
    from test_kmeans import numpy_lloyd

    x, _ = make_blobs(7, n=200, d=5, k=3)
    init = _pinned(x, 3)
    ours, cost, _ = tkm.lloyd(torch.from_numpy(x), torch.ones(200, dtype=torch.float64),
                              torch.from_numpy(init), max_iter=50, tol=1e-6)
    theirs, ref_cost = numpy_lloyd(x, init, max_iter=50, tol=1e-6)
    assert_close("lloyd vs numpy", ours, theirs, rtol=0, atol=1e-6)
    assert float(cost) == pytest.approx(ref_cost, rel=1e-8)


def test_block_suff_stats_and_normalize_rows_match_jax():
    x, _ = make_blobs(9, n=300, d=7, k=4)
    c = _pinned(x, 4)
    for got, want in zip(tkm.block_suff_stats(torch.from_numpy(x), torch.from_numpy(c)),
                         jkm.block_suff_stats(jnp.asarray(x), jnp.asarray(c))):
        assert_close("block_suff_stats", got, np.asarray(want), **_f64(want))
    z = np.vstack([x, np.zeros((1, 7))])
    assert_close("normalize_rows", tkm.normalize_rows(torch.from_numpy(z)),
                 np.asarray(jkm.normalize_rows(jnp.asarray(z))), **F64)


def test_auto_block_rows_is_the_reference_rule():
    assert tkm._auto_block_rows(20_000_000, 100, None) == 20_000_001
    assert tkm._auto_block_rows(30_000_000, 100, None) == jkm._auto_block_rows(30_000_000, 100, 1, None)
    assert tkm._auto_block_rows(10, 3, 4) == 4


# --- seeding: statistics, not bits ------------------------------------------


@pytest.mark.parametrize("init", ["plusplus", "random"])
def test_seeding_picks_k_distinct_rows_of_positive_weight(init):
    x, _ = make_blobs(12, n=400, d=6, k=5)
    mask = np.ones(400)
    mask[::3] = 0.0
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(3)
    if init == "plusplus":
        c = tkm.kmeans_plusplus_init(xt, mt, gen, 5)
    else:
        c = tkm.random_init(xt, mt, gen, 5)
    rows = [int(np.flatnonzero((x == r).all(axis=1))[0]) for r in c.numpy()]
    assert len(set(rows)) == 5 and all(mask[r] > 0 for r in rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_fit_recovers_planted_blobs(seed):
    """tests/test_kmeans.py::test_recovers_separated_blobs's bar."""
    x, true_centers = make_blobs(seed)
    model = KMeans().setK(4).setSeed(seed).fit(x)
    jmodel = JaxKMeans().setK(4).setSeed(seed).fit(x)
    for c in true_centers:
        assert np.min(np.linalg.norm(model.clusterCenters() - c, axis=1)) < 1.0
    assert model.trainingCost == pytest.approx(jmodel.trainingCost, rel=1e-4)
    assert model.numIter >= 1


def test_seeding_is_repeatable_from_the_seed():
    x, _ = make_blobs(4)
    a = KMeans().setK(4).setSeed(9).fit(x).clusterCenters()
    b = KMeans().setK(4).setSeed(9).fit(x).clusterCenters()
    assert np.array_equal(a, b)


# --- the estimator against JAX KMeans from the same init ----------------------


def _pair(x, k, init, **params):
    est, jest = KMeans().setK(k).setInitialModel(init), JaxKMeans().setK(k).setInitialModel(init)
    for name, value in params.items():
        est.set(est.getParam(name), value)
        jest.set(jest.getParam(name), value)
    return est, jest


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_estimator_matches_jax(backend, measure):
    x, _ = make_blobs(21, n=1100, d=16, k=6, sep=4.0)
    x = x + 5.0
    init = _pinned(x, 6)
    est, jest = _pair(x, 6, init, distanceMeasure=measure, maxIter=15)
    est.setBackend(backend)
    want = jest.setBackend("xla").fit(x)
    got = est.fit(x)  # host numpy: float32 on the port
    assert got.numIter == want.numIter
    assert_close("centers (host, f32)", got.clusterCenters(), want.clusterCenters(), rtol=0, atol=1e-4)
    assert got.trainingCost == pytest.approx(want.trainingCost, rel=1e-5)
    if backend == "xla":
        exact = est.fit(torch.from_numpy(x))  # a float64 tensor stays float64
        assert_close("centers (f64 tensor)", exact.clusterCenters(), want.clusterCenters(),
                     rtol=0, atol=1e-8)
        assert exact.trainingCost == pytest.approx(want.trainingCost, rel=1e-10)


def test_estimator_weight_col_matches_jax():
    x, _ = make_blobs(23, n=600, d=5, k=4)
    w = np.random.default_rng(5).uniform(0.0, 3.0, 600)
    init = _pinned(x, 4)
    df = DataFrame({"features": list(x), "w": list(w)})
    jdf = JaxDataFrame({"features": list(x), "w": list(w)})
    est, jest = _pair(x, 4, init, weightCol="w", maxIter=20)
    got, want = est.fit(df), jest.fit(jdf)
    assert got.numIter == want.numIter
    assert_close("weighted centers", got.clusterCenters(), want.clusterCenters(), rtol=0, atol=1e-4)
    assert got.trainingCost == pytest.approx(want.trainingCost, rel=1e-5)
    with pytest.raises(ValueError, match="weightCol"):
        est.setBackend("fused").fit(df)
    with pytest.raises(ValueError, match="weightCol"):
        jest.setBackend("fused").fit(jdf)


def test_fused_route_runs_the_kernels_plain_versions(monkeypatch):
    x, _ = make_blobs(25, n=500, d=16, k=5)
    calls = []
    real = kk.assign_stats_plain
    monkeypatch.setattr(kk, "assign_stats_plain", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    KMeans().setK(5).setSeed(1).setBackend("fused").fit(x)
    assert calls  # d = 16, k = 5 is packable: K3's plain version, which is K2's
    assert kk.launches == {"assign_stats_fused": 0, "assign_stats_packed": 0, "seed_select": 0,
                           "seed_potentials": 0}


def test_resolve_backend_follows_the_reference_rules():
    est = KMeans().setK(4)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert est._resolve_backend(None, 10**9, d=16, k=100, dtype=torch.float32, device=cpu) == "xla"
    assert est._resolve_backend(None, 10**9, d=16, k=100, dtype=torch.float32, device=cuda) == "fused"
    assert est._resolve_backend(None, (1 << 22) - 1, d=16, k=100, dtype=torch.float32, device=cuda) == "xla"
    assert est._resolve_backend(None, 10**9, d=16, k=100, dtype=torch.float64, device=cuda) == "xla"
    assert est._resolve_backend(np.ones(3), 10**9, d=16, k=100, dtype=torch.float32, device=cuda) == "xla"
    assert est._resolve_backend(None, 10**9, d=1024, k=100, dtype=torch.float32, device=cuda) == "xla"
    assert est.setBackend("xla")._resolve_backend(None, 10**9, 16, 100, torch.float32, cuda) == "xla"
    est.setBackend("fused")
    assert est._resolve_backend(None, 10, d=16, k=4, dtype=torch.float64, device=cpu) == "fused"
    with pytest.raises(ValueError, match="shared-memory"):
        est._resolve_backend(None, 10, d=1024, k=100)
    assert JaxKMeans().setK(4)._resolve_backend(None, 10**9) == "xla"  # the reference off a TPU


def test_estimator_refuses_what_the_slice_leaves_out():
    x, _ = make_blobs(2, n=50)
    # A.7a (the streaming fit) arrived with the streaming slice.
    assert KMeans().setK(2).fit(lambda: iter([x])).clusterCenters().shape == (2, x.shape[1])
    # A.7d (the mesh) arrived with the distribution slice.
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    assert KMeans(mesh=mesh).setK(2).fit(x).clusterCenters().shape == (2, x.shape[1])
    # A.7e (the serving signature) arrived with the composition slice.
    assert KMeans().setK(2).fit(x).serving_signature().name == "kmeans.predict"
    with pytest.raises(ValueError, match="exceeds"):
        KMeans().setK(10).fit(x[:5])
    with pytest.raises(ValueError, match="k=3"):
        KMeans().setK(3).setInitialModel(x[:2]).fit(x)
    with pytest.raises(ValueError, match="features"):
        KMeans().setK(2).setInitialModel(x[:2, :3]).fit(x)


def test_params_surface_matches_jax():
    est, jest = KMeans(), JaxKMeans()
    # deployMode (gang fits) arrived with the distribution slice.
    assert sorted(p.name for p in est.params) == sorted(p.name for p in jest.params)
    for p in jest.params:
        if jest.hasDefault(p) and est.hasParam(p.name):
            assert est.getOrDefault(p.name) == jest.getOrDefault(p)
    with pytest.raises(ValueError):
        KMeans().setInitMode("zzz")
    with pytest.raises(ValueError):
        KMeans().setDistanceMeasure("manhattan")
    with pytest.raises((TypeError, ValueError)):
        KMeans().setK(1)
    with pytest.raises(ValueError, match="precision"):
        KMeans().setPrecision("fp8")
    with pytest.raises(ValueError, match="backend"):
        KMeans().setBackend("cuda")
    warm = KMeans().setK(3).setInitialModel(np.eye(3))
    assert np.array_equal(warm.copy()._initial_centers, np.eye(3))


# --- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted():
    x, _ = make_blobs(31, n=400, d=6, k=4)
    init = _pinned(x, 4)
    port_device.set_platform("cpu")
    try:
        model = KMeans().setK(4).setInitialModel(init).fit(torch.from_numpy(x))
    finally:
        port_device.set_platform("cuda")
    jmodel = JaxKMeans().setK(4).setInitialModel(init).fit(x)
    return x, model, jmodel


@pytest.mark.parametrize("container", ["ndarray", "tensor", "dataframe", "pandas"])
def test_predict_and_transform_match_jax(fitted, container):
    x, model, jmodel = fitted
    want = np.asarray(jmodel.predict(x))
    if container == "ndarray":
        got = model.predict(x)
        assert isinstance(got, np.ndarray)
        assert np.array_equal(model.transform(x), want)
    elif container == "tensor":
        got = model.predict(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
    elif container == "dataframe":
        out = model.setPredictionCol("cluster").transform(DataFrame({"features": list(x)}))
        got = np.asarray(out.select("cluster"))
        model.setPredictionCol("prediction")
    else:
        frame = pd.DataFrame({"features": list(x)})
        got = model.transform(frame)["prediction"].to_numpy()
    assert np.array_equal(got, want)


def test_predict_streams_a_large_host_matrix(fitted, monkeypatch):
    from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

    x, model, jmodel = fitted
    monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", "64")  # 400 rows -> 7 blocks
    blocks = counter_value("serving.stream.blocks")
    assert np.array_equal(model.predict(x), np.asarray(jmodel.predict(x)))
    assert counter_value("serving.stream.blocks") - blocks == 7


@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_compute_cost_matches_jax(measure):
    x, _ = make_blobs(33, n=300, d=5, k=3)
    init = _pinned(x, 3)
    model = KMeans().setK(3).setInitialModel(init).setDistanceMeasure(measure).fit(torch.from_numpy(x))
    jmodel = JaxKMeans().setK(3).setInitialModel(init).setDistanceMeasure(measure).fit(x)
    assert model.computeCost(x) == pytest.approx(jmodel.computeCost(x), rel=1e-10)
    assert model.computeCost(torch.from_numpy(x)) == pytest.approx(jmodel.computeCost(x), rel=1e-10)
    if measure == "cosine":
        assert model.computeCost(x) == pytest.approx(model.trainingCost, rel=1e-8)


def test_copy_keeps_fitted_state(fitted):
    _, model, _ = fitted
    twin = model.copy({model.predictionCol: "p"})
    assert np.array_equal(twin.clusterCenters(), model.clusterCenters())
    assert twin.getPredictionCol() == "p" and twin.trainingCost == model.trainingCost


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_a_model_saved_by_either_package_loads_in_the_other(fitted, tmp_path, direction):
    x, model, jmodel = fitted
    path = str(tmp_path / "km")
    if direction == "port_to_jax":
        model.setPredictionCol("cluster").write.overwrite().save(path)
        model.setPredictionCol("prediction")
        loaded = JaxKMeansModel.load(path)
        src_centers, src_cost, src_iter = model.clusterCenters(), model.trainingCost, model.numIter
        assert np.array_equal(np.asarray(loaded.predict(x)), model.predict(x))
    else:
        jmodel.setPredictionCol("cluster").write.overwrite().save(path)
        jmodel.setPredictionCol("prediction")
        loaded = KMeansModel.load(path)
        src_centers, src_cost, src_iter = jmodel.clusterCenters(), jmodel.trainingCost, jmodel.numIter
        assert np.array_equal(loaded.predict(x), np.asarray(jmodel.predict(x)))
    assert np.array_equal(loaded.clusterCenters(), src_centers)
    assert loaded.trainingCost == src_cost and loaded.numIter == src_iter
    assert loaded.getPredictionCol() == "cluster"


def test_save_rows_falls_back_to_npz(fitted, tmp_path, monkeypatch):
    _, model, _ = fitted
    monkeypatch.setattr(persistence, "_HAS_ARROW", False)
    path = str(tmp_path / "km_npz")
    model.write.overwrite().save(path)
    loaded = KMeansModel.load(path)
    assert np.array_equal(loaded.clusterCenters(), model.clusterCenters())


def test_kmeans_model_from_numpy_carries_a_jax_model(fitted):
    x, _, jmodel = fitted
    params = {p.name: v for p, v in jmodel.extractParamMap().items()}
    model = kmeans_model_from_numpy(jmodel.clusterCenters(), uid=jmodel.uid, params=params,
                                    training_cost=jmodel.trainingCost, num_iter=jmodel.numIter)
    assert model.uid == jmodel.uid and model.numIter == jmodel.numIter
    assert np.array_equal(model.predict(x), np.asarray(jmodel.predict(x)))
    with pytest.raises(ValueError, match="centers"):
        kmeans_model_from_numpy(np.zeros(3))


def test_fitted_state_stays_a_tensor_until_read(fitted):
    _, model, _ = fitted
    assert isinstance(model._centers_raw, torch.Tensor)
    centers = model.clusterCenters()
    assert isinstance(centers, np.ndarray) and centers.dtype == np.float64
    assert isinstance(model.trainingCost, float) and isinstance(model.numIter, int)


# --- ingest, data ------------------------------------------------------------


def test_prepare_rows_keeps_tensors_and_places_host_rows():
    x = np.arange(12.0).reshape(4, 3)
    t = torch.from_numpy(x)
    prep = ingest.prepare_rows(t)
    assert prep.x is t and prep.mask.dtype == torch.float64 and (prep.n_true, prep.d_true) == (4, 3)
    host = ingest.prepare_rows(x)
    assert host.x.dtype == ingest.default_dtype() == torch.float32
    assert torch.equal(host.x, t.float()) and torch.equal(host.mask, torch.ones(4))
    ints = ingest.prepare_rows(torch.arange(6).reshape(2, 3))
    assert ints.x.dtype == torch.float32
    weighted = ingest.prepare_rows([x[:2], x[2:]], dtype=torch.float64, weights=[1.0, 0.0, 2.0, 3.0])
    assert torch.equal(weighted.mask, torch.tensor([1.0, 0.0, 2.0, 3.0], dtype=torch.float64))
    with pytest.raises(ValueError, match="weight vector"):
        ingest.prepare_rows(x, weights=[1.0])
    with pytest.raises(ValueError, match="2-D"):
        ingest.prepare_rows(torch.zeros(3))
    assert ingest.matrix_like(torch.zeros(3)).shape == (1, 3)
    assert isinstance(ingest.matrix_like([[1.0, 2.0]]), np.ndarray)


def test_extract_features_and_weights_match_jax():
    x = np.arange(8.0).reshape(4, 2)
    frame = pd.DataFrame({"a": x[:, 0], "b": x[:, 1], "id": [0, 1, 2, 3]})
    assert np.array_equal(extract_features(frame, "features", drop="id"),
                          jax_extract_features(frame, "features", drop="id"))
    df = DataFrame({"features": list(x), "w": [1.0, 2.0, 0.0, 1.0]})
    assert extract_features(df, "features") is df.select("features")
    assert np.array_equal(extract_weights(df, "w"),
                          jax_extract_weights(JaxDataFrame({"w": [1.0, 2.0, 0.0, 1.0]}), "w"))
    assert extract_weights(df, None) is None
    with pytest.raises(TypeError, match="named columns"):
        extract_weights(x, "w")
    with pytest.raises(ValueError, match="non-negative"):
        extract_weights(DataFrame({"w": [1.0, -1.0]}), "w")
    with pytest.raises(ValueError, match="positive"):
        extract_weights(DataFrame({"w": [0.0, 0.0]}), "w")
