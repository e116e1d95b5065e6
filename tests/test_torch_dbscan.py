"""The port's DBSCAN (``ops/dbscan.py``, ``models/dbscan.py``) against the
JAX package's, on the same numpy inputs in float64, and against the
reference's sklearn bars (``tests/test_dbscan.py``).

Tolerances: none. Labels, core masks and sweep counts are integers and
must be equal; the fitted rows round-trip bitwise through save/load.
"""

import pickle

import cloudpickle
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import DBSCAN as SkDBSCAN

from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.models import dbscan as jax_model
from spark_rapids_ml_tpu.ops import dbscan as jax_ops
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.clustering import DBSCAN, DBSCANModel
from spark_rapids_ml_tpu_torch.core.data import DataFrame
from spark_rapids_ml_tpu_torch.ops import dbscan as ops


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def blobs(seed, centers, n_per=60, scale=0.08):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(c, scale, size=(n_per, len(c))) for c in centers])
    return pts[rng.permutation(len(pts))]


def planted(n, d=3, k=5, seed=0, spread=4.0, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    return centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * noise


def chain(n, spacing=0.5, offset=0.0):
    return np.stack([np.arange(n) * spacing, np.full(n, offset)], axis=1)


def same_partition(a, b):
    """Labels agree as set partitions (noise = -1 matching exactly)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a == -1, b == -1)
    mapping = {}
    for x, y in zip(a, b):
        if x == -1:
            continue
        if x in mapping:
            assert mapping[x] == y
        else:
            assert y not in mapping.values()
            mapping[x] = y


def _both(x, eps, min_pts, **kw):
    jl, jc, js = jax_ops.dbscan_labels(x, eps, min_pts, return_sweeps=True, **kw)
    pl, pc, ps = ops.dbscan_labels(torch.from_numpy(x), eps, min_pts, return_sweeps=True, **kw)
    return (np.asarray(jl), np.asarray(jc), int(js)), (pl.numpy(), pc.numpy(), ps)


def _hold(theirs, ours):
    assert ours[0].dtype == np.int32 and ours[1].dtype == bool
    assert np.array_equal(ours[0], theirs[0]), f"labels differ in {np.sum(ours[0] != theirs[0])} rows"
    assert np.array_equal(ours[1], theirs[1]), "core masks differ"
    assert ours[2] == theirs[2], f"sweeps {ours[2]} != {theirs[2]}"


# --- ops ------------------------------------------------------------------

CASES = {
    "blobs": (planted(700), 0.6, 5),
    "blobs_wide": (planted(500, d=16, k=8, spread=6.0), 2.0, 8),
    "tight_eps": (planted(600, seed=3), 0.3, 4),
    "with_noise": (np.concatenate([planted(400, seed=4), np.random.default_rng(4).uniform(20, 40, (30, 3))]), 0.6, 5),
}
BLOCKS = [(2048, 8192), (64, 100), (33, 70), (50, 7), (500, 1)]


@pytest.mark.parametrize("blocks", BLOCKS, ids=lambda b: f"q{b[0]}_i{b[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_dbscan_labels_match_the_reference(case, blocks):
    x, eps, min_pts = CASES[case]
    bq, bi = blocks
    theirs, ours = _both(x, eps, min_pts, block_q=bq, block_i=bi)
    _hold(theirs, ours)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("min_pts", [1, 3, 9])
def test_core_point_mask_matches_the_reference(case, min_pts):
    x, eps, _ = CASES[case]
    want = np.asarray(jax_ops.core_point_mask(x, eps, min_pts, block_q=64, block_i=128))
    got = ops.core_point_mask(torch.from_numpy(x), eps, min_pts, block_q=64, block_i=128)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 97, 255, 1001])
def test_ragged_row_counts(n):
    x = planted(n, seed=n)
    theirs, ours = _both(x, 0.7, 3, block_q=64, block_i=96)
    _hold(theirs, ours)


@pytest.mark.parametrize("keep", [0.3, 0.7, 1.0])
def test_row_mask_matches_the_reference(keep):
    x = planted(400, seed=9)
    mask = (np.random.default_rng(9).uniform(size=400) < keep).astype(np.float64)
    theirs, ours = _both(x, 0.6, 4, row_mask=mask, block_q=128, block_i=256)
    _hold(theirs, ours)
    assert np.all(ours[0][mask == 0] == -1) and not np.any(ours[1][mask == 0])


def test_all_noise():
    x = np.random.default_rng(5).uniform(0, 100, size=(40, 3))
    theirs, ours = _both(x, 0.01, 3)
    _hold(theirs, ours)
    assert np.all(ours[0] == -1) and not ours[1].any() and ours[2] == 1


def test_one_cluster():
    x = np.random.default_rng(6).normal(0, 0.05, size=(100, 4))
    theirs, ours = _both(x, 0.5, 5)
    _hold(theirs, ours)
    assert np.all(ours[0] == 0) and ours[1].all()


@pytest.mark.parametrize("blocks", [(2048, 8192), (256, 512)])
def test_a_2000_point_chain(blocks):
    theirs, ours = _both(chain(2000), 0.6, 2, block_q=blocks[0], block_i=blocks[1])
    _hold(theirs, ours)
    assert np.all(ours[0] == 0) and ours[1].all() and ours[2] <= 4


def test_two_chains_stay_apart():
    x = np.concatenate([chain(512), chain(512, offset=10.0)])
    theirs, ours = _both(x, 0.6, 2)
    _hold(theirs, ours)
    assert set(np.unique(ours[0])) == {0, 512}


def test_a_float32_tensor_stays_float32():
    x = planted(300, seed=2).astype(np.float32)
    jl, jc = jax_ops.dbscan_labels(x, 0.6, 5)
    pl, pc = ops.dbscan_labels(torch.from_numpy(x), 0.6, 5)
    assert np.array_equal(pl.numpy(), np.asarray(jl)) and np.array_equal(pc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed", range(4))
def test_compress_labels_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 300
    labels = np.where(rng.uniform(size=n) < 0.8, rng.integers(0, n, n), ops._INT_MAX).astype(np.int32)
    core = rng.uniform(size=n) < 0.7
    want = np.asarray(jax_ops._compress_labels(labels, core, n))
    got = ops._compress_labels(torch.from_numpy(labels), torch.from_numpy(core), n)
    assert np.array_equal(got.numpy(), want)


def test_min_core_neighbor_label_and_counts_match_the_reference():
    from spark_rapids_ml_tpu.ops.linalg import _dot_precision
    from spark_rapids_ml_tpu_torch.ops.precision import make_dot

    x = planted(350, seed=11)
    valid = np.ones(350, bool)
    eps_sq = 0.6 ** 2
    core = np.array(jax_ops.core_point_mask(x, 0.6, 5))
    labels = np.where(core, np.arange(350), ops._INT_MAX).astype(np.int32)
    prec = _dot_precision("highest")
    want_counts = np.asarray(jax_ops._eps_neighbor_counts(x, valid, eps_sq, 64, 128, prec))[:350]
    want_min = np.asarray(jax_ops._min_core_neighbor_label(x, valid, core, labels, eps_sq, 64, 128, prec))
    xt, dot = torch.from_numpy(x), make_dot("highest")
    eps_t = torch.tensor(eps_sq, dtype=torch.float64)
    got_counts = ops._eps_neighbor_counts(xt, None, eps_t, 64, 128, dot)
    got_min = ops._min_core_neighbor_label(xt, None, torch.from_numpy(core), torch.from_numpy(labels), eps_t,
                                           64, 128, dot)
    assert got_counts.dtype == torch.int32 and np.array_equal(got_counts.numpy(), want_counts)
    assert got_min.dtype == torch.int32 and np.array_equal(got_min.numpy(), want_min)


@pytest.mark.parametrize("seed", range(3))
def test_relabel_consecutive_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    labels = rng.choice([-1, 3, 17, 40, 41, 99], size=200).astype(np.int32)
    assert np.array_equal(ops.relabel_consecutive(labels), jax_model.relabel_consecutive(labels))
    assert np.array_equal(ops.relabel_consecutive(np.full(5, -1)), np.full(5, -1))


def test_the_sharded_route_names_its_item():
    """The sharded route runs on one process's mesh (labels and core mask
    as on one device) and names its item in a gang of several processes."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, make_mesh

    x = np.concatenate([np.zeros((3, 2)), np.full((2, 2), 5.0)])
    labels, core = ops.dbscan_labels_sharded(make_mesh((4, 1), devices=[torch.device("cpu")] * 4), x, 0.5, 2)
    assert labels.tolist() == [0, 0, 0, 3, 3] and core.all()
    gang = np.empty((1, 1), dtype=object)
    gang[0, 0] = torch.device("cpu")
    with pytest.raises(NotImplementedError, match=r"A\.9, item 18 \(gang\)"):
        ops.dbscan_labels_sharded(Mesh(gang, processes=2), x, 0.5, 2)


# --- the reference's sklearn bars ------------------------------------------


def test_core_mask_matches_sklearn():
    x = blobs(7, [[0, 0], [3, 3], [6, 0]])
    sk = SkDBSCAN(eps=0.3, min_samples=8).fit(x)
    sk_core = np.zeros(len(x), bool)
    sk_core[sk.core_sample_indices_] = True
    assert np.array_equal(ops.core_point_mask(torch.from_numpy(x), 0.3, 8).numpy(), sk_core)


@pytest.mark.parametrize("extra_noise", [0, 10])
def test_labels_match_sklearn(extra_noise):
    x = blobs(7, [[0, 0], [3, 3], [6, 0]])
    if extra_noise:
        x = np.concatenate([x, np.random.default_rng(1).uniform(10, 20, size=(extra_noise, 2))])
    sk = SkDBSCAN(eps=0.3, min_samples=8).fit(x)
    labels, _ = ops.dbscan_labels(torch.from_numpy(x), 0.3, 8)
    same_partition(ops.relabel_consecutive(labels.numpy()), sk.labels_)
    assert np.sum(labels.numpy() == -1) >= extra_noise


def test_chain_parity_with_sklearn():
    t = np.linspace(0, 10, 200)
    x = np.stack([t, np.zeros_like(t)], axis=1) + np.random.default_rng(7).normal(0, 0.005, (200, 2))
    sk = SkDBSCAN(eps=0.12, min_samples=3).fit(x)
    labels, _ = ops.dbscan_labels(torch.from_numpy(x), 0.12, 3)
    same_partition(ops.relabel_consecutive(labels.numpy()), sk.labels_)


# --- estimator and model ---------------------------------------------------

X_EST = blobs(3, [[0, 0], [3, 3], [6, 0]], n_per=50)
NEW = np.array([[0.05, 0.0], [3.02, 2.97], [50.0, 50.0], [6.1, 0.05], [1.5, 1.5]])


def _inputs(kind, frame_cls):
    if kind == "numpy":
        return X_EST
    if kind == "tensor":
        return torch.from_numpy(X_EST)
    if kind == "list":
        return [X_EST[:70], X_EST[70:]]
    if kind == "dataframe":
        return frame_cls({"features": list(X_EST)})
    return pd.DataFrame({"features": list(X_EST)})


KINDS = ("numpy", "tensor", "list", "dataframe", "pandas")


def _fit_pair(kind="numpy", eps=0.3, min_samples=8):
    ours = DBSCAN().setEps(eps).setMinSamples(min_samples).fit(_inputs(kind, DataFrame))
    theirs = jax_model.DBSCAN().setEps(eps).setMinSamples(min_samples).fit(_inputs(kind, JaxDataFrame))
    return ours, theirs


@pytest.mark.parametrize("kind", KINDS)
def test_estimator_matches_the_reference(kind):
    ours, theirs = _fit_pair(kind)
    assert np.array_equal(ours.labels_, theirs.labels_) and ours.labels_.dtype == np.int32
    assert np.array_equal(ours.core_mask_, theirs.core_mask_)
    assert np.array_equal(ours.core_sample_indices_, theirs.core_sample_indices_)
    assert np.array_equal(ours.fitted, np.asarray(theirs.fitted)) and ours.fitted.dtype == np.float64
    same_partition(ours.labels_, SkDBSCAN(eps=0.3, min_samples=8).fit(X_EST).labels_)


def test_host_input_computes_in_float64_and_a_tensor_keeps_its_dtype():
    model = DBSCAN().setEps(0.3).setMinSamples(8).fit(X_EST.astype(np.float32))
    assert isinstance(model._fitted_raw, np.ndarray) and model._fitted_raw.dtype == np.float64
    x32 = torch.from_numpy(X_EST.astype(np.float32))
    model32 = DBSCAN().setEps(0.3).setMinSamples(8).fit(x32)
    assert model32._fitted_raw is x32 and model32.fitted.dtype == np.float64
    assert np.array_equal(model32.labels_, model.labels_)


@pytest.mark.parametrize("kind", KINDS)
def test_transform_of_the_fitted_rows_returns_their_labels(kind):
    ours, theirs = _fit_pair(kind)
    got = ours.transform(_inputs(kind, DataFrame))
    want = theirs.transform(_inputs(kind, JaxDataFrame))
    if kind == "dataframe":
        got, want = got.select("prediction"), want.select("prediction")
    elif kind == "pandas":
        got, want = got["prediction"].tolist(), want["prediction"].tolist()
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(np.asarray(got), ours.labels_)


@pytest.mark.parametrize("fit_kind", ["numpy", "tensor"])
@pytest.mark.parametrize("query_kind", ["numpy", "tensor64", "tensor32"])
def test_transform_of_new_rows_matches_the_reference(fit_kind, query_kind):
    ours, theirs = _fit_pair(fit_kind)
    q = {"numpy": NEW, "tensor64": torch.from_numpy(NEW),
         "tensor32": torch.from_numpy(NEW.astype(np.float32))}[query_kind]
    got = ours.transform(q)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    assert np.array_equal(got, theirs.transform(NEW))
    assert got[2] == -1 and got[0] == ours.labels_[np.argmin(np.linalg.norm(X_EST, axis=1))]


def test_transform_with_no_core_points_is_all_noise():
    model = DBSCAN().setEps(0.01).setMinSamples(3).fit(np.random.default_rng(0).uniform(0, 100, (30, 2)))
    assert np.array_equal(model.transform(NEW), np.full(len(NEW), -1))


def test_copy_and_pickle_keep_the_fitted_state():
    ours, _ = _fit_pair("tensor")
    for other in (ours.copy(), pickle.loads(cloudpickle.dumps(ours))):
        assert other.uid == ours.uid and other.getEps() == 0.3 and other.getMinSamples() == 8
        assert np.array_equal(other.labels_, ours.labels_)
        assert np.array_equal(other.core_mask_, ours.core_mask_)
        assert np.array_equal(other.fitted, ours.fitted)
        assert np.array_equal(other.transform(NEW), ours.transform(NEW))
    assert isinstance(pickle.loads(cloudpickle.dumps(ours))._fitted_raw, np.ndarray)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_save_load_both_ways(tmp_path, direction):
    ours, theirs = _fit_pair("numpy", eps=0.35, min_samples=6)
    path = str(tmp_path / "dbscan")
    saver, loader = {
        "port_to_jax": (ours, jax_model.DBSCANModel),
        "jax_to_port": (theirs, DBSCANModel),
        "port_to_port": (ours, DBSCANModel),
    }[direction]
    saver.write.overwrite().save(path)
    loaded = loader.load(path)
    assert loaded.uid == saver.uid and loaded.getEps() == 0.35 and loaded.getMinSamples() == 6
    assert np.array_equal(np.asarray(loaded.labels_), ours.labels_)
    assert np.array_equal(np.asarray(loaded.core_mask_), ours.core_mask_)
    assert np.array_equal(np.asarray(loaded.fitted), X_EST)
    assert np.array_equal(np.asarray(loaded.transform(NEW)), ours.transform(NEW))


def test_interop_carries_the_reference_model():
    theirs = jax_model.DBSCAN().setEps(0.3).setMinSamples(8).fit(X_EST)
    params = {p.name: v for p, v in theirs.extractParamMap().items()}
    ours = interop.dbscan_model_from_numpy(np.asarray(theirs.fitted), theirs.labels_, theirs.core_mask_,
                                           uid=theirs.uid, params=params)
    assert ours.uid == theirs.uid and ours.getEps() == 0.3 and ours.getMinSamples() == 8
    assert np.array_equal(ours.transform(NEW), theirs.transform(NEW))
    assert np.array_equal(ours.transform(X_EST), theirs.labels_)
    with pytest.raises(ValueError, match="labels and core_mask"):
        interop.dbscan_model_from_numpy(X_EST, theirs.labels_[:5], theirs.core_mask_)


def test_defaults_match_the_reference():
    ours, theirs = DBSCAN(), jax_model.DBSCAN()
    for name in ("eps", "minSamples", "metric", "featuresCol", "predictionCol"):
        assert ours.getOrDefault(name) == theirs.getOrDefault(name), name
    assert (ours.getEps(), ours.getMinSamples(), ours.getMetric()) == (0.5, 5, "euclidean")


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("call", [
    lambda m: m.DBSCAN().setEps(-1.0),
    lambda m: m.DBSCAN().setEps(0.0),
    lambda m: m.DBSCAN().setMinSamples(0),
    lambda m: m.DBSCAN().setMetric("manhattan"),
], ids=["negative_eps", "zero_eps", "zero_min_samples", "metric"])
def test_errors_match_the_reference(call):
    import spark_rapids_ml_tpu_torch.models.dbscan as port_model

    assert _message(lambda: call(port_model)) == _message(lambda: call(jax_model))


def test_a_mesh_names_its_item():
    """Ported since: ``setMesh`` and ``mesh=`` fit over the mesh, with the
    single-device labels and core mask."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((8, 1), devices=[torch.device("cpu")] * 8)
    single = DBSCAN().setEps(0.6).setMinSamples(5).fit(X_EST)
    for est in (DBSCAN().setMesh(mesh), DBSCAN(mesh=mesh)):
        model = est.setEps(0.6).setMinSamples(5).fit(X_EST)
        assert np.array_equal(model.labels_, single.labels_)
        assert np.array_equal(model.core_mask_, single.core_mask_)


def test_cuda_platform_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_device.set_platform("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        DBSCAN().fit(X_EST)
