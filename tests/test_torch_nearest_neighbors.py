"""The port's ``NearestNeighbors`` / ``NearestNeighborsModel``
(``models/nearest_neighbors.py``) against the JAX package's, on the same
numpy inputs: every in-memory input kind, ids, transform, the streamed
index, pickling, save/load in both directions and the error paths.

Tolerances: host queries compute in float32 in the port (float64 in the
reference under x64): the same indices (no near-ties in the data) and
distances within 1e-5 relative. float64 tensor queries: the same indices
and distances within 1e-10.
"""

import pickle

import cloudpickle
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu import neighbors as jax_neighbors
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop, native
from spark_rapids_ml_tpu_torch.core.data import DataFrame, HostArrayBlockReader
from spark_rapids_ml_tpu_torch.neighbors import NearestNeighbors, NearestNeighborsModel
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

METRICS = ("euclidean", "sqeuclidean", "cosine")
N, D, NQ, K = 200, 6, 15, 5


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


RNG = np.random.default_rng(21)
ITEMS = RNG.standard_normal((N, D)) + 0.3
QUERIES = RNG.standard_normal((NQ, D))
IDS = np.arange(1000, 1000 + N)


def _hold(name, got, want, tight: bool):
    gd, gi = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in got)
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    assert gi.dtype == np.int32, name
    assert np.array_equal(gi, wi), f"{name}: indices differ in {np.sum(gi != wi)} places"
    assert_close(f"{name} distances", gd, wd, rtol=1e-10 if tight else 1e-5, atol=1e-12 if tight else 1e-6)


def _inputs(kind, frame_cls, pkg_tensor):
    """(dataset, queries) of one input kind, for one package."""
    if kind == "numpy":
        return ITEMS, QUERIES
    if kind == "tensor":
        return pkg_tensor(ITEMS), pkg_tensor(QUERIES)
    if kind == "dataframe":
        return frame_cls({"features": list(ITEMS), "rid": list(IDS)}), QUERIES
    if kind == "pandas_column":
        return pd.DataFrame({"features": list(ITEMS), "rid": IDS}), QUERIES
    frame = pd.DataFrame(ITEMS, columns=[f"c{i}" for i in range(D)])
    frame["rid"] = IDS
    return frame, QUERIES


KINDS = ("numpy", "tensor", "dataframe", "pandas_column", "pandas_bare")


def _fit_both(kind, metric="euclidean", k=K, id_col=None):
    ours_data, ours_q = _inputs(kind, DataFrame, torch.from_numpy)
    theirs_data, theirs_q = _inputs(kind, JaxDataFrame, jnp.asarray)
    ours = NearestNeighbors().setK(k).setMetric(metric)
    theirs = jax_neighbors.NearestNeighbors().setK(k).setMetric(metric)
    if id_col:
        ours, theirs = ours.setIdCol(id_col), theirs.setIdCol(id_col)
    return ours.fit(ours_data), theirs.fit(theirs_data), ours_q, theirs_q


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", KINDS)
def test_fit_kneighbors_matches_the_reference(kind, metric):
    id_col = "rid" if kind in ("dataframe", "pandas_column", "pandas_bare") else None
    ours, theirs, q_ours, q_theirs = _fit_both(kind, metric, id_col=id_col)
    got = ours.kneighbors(q_ours)
    assert isinstance(got[0], torch.Tensor) == (kind == "tensor")
    _hold(f"{kind}/{metric}", got, theirs.kneighbors(q_theirs), tight=kind == "tensor")


@pytest.mark.parametrize("query", ["numpy", "tensor32", "tensor64"])
@pytest.mark.parametrize("items", ["numpy", "tensor32", "tensor64"])
def test_host_in_numpy_out_tensor_in_tensor_out(items, query):
    as_kind = {"numpy": lambda x: x, "tensor32": lambda x: torch.from_numpy(x.astype(np.float32)),
               "tensor64": torch.from_numpy}
    model = NearestNeighbors().setK(K).fit(as_kind[items](ITEMS))
    d, idx = model.kneighbors(as_kind[query](QUERIES))
    if query == "numpy":
        assert isinstance(d, np.ndarray) and d.dtype == np.float32 and idx.dtype == np.int32
    else:
        assert isinstance(d, torch.Tensor) and d.dtype == (torch.float64 if query == "tensor64" else torch.float32)
        assert idx.dtype == torch.int32 and d.device == idx.device == torch.device("cpu")
    want = jax_neighbors.NearestNeighbors().setK(K).fit(ITEMS).kneighbors(QUERIES)
    assert np.array_equal(np.asarray(idx), np.asarray(want[1]))


@pytest.mark.parametrize("k", [1, 10, N])
def test_k_override(k):
    ours, theirs, q, jq = _fit_both("tensor")
    _hold(f"k={k}", ours.kneighbors(q, k=k), theirs.kneighbors(jq, k=k), tight=True)


@pytest.mark.parametrize("kind", ["dataframe", "pandas_column", "pandas_bare"])
def test_ids_match_the_reference(kind):
    ours, theirs, q, jq = _fit_both(kind, id_col="rid")
    d, ids = ours.kneighbors_ids(q)
    jd, jids = theirs.kneighbors_ids(jq)
    assert np.array_equal(ids, np.asarray(jids))
    assert np.array_equal(ours.ids, IDS)
    d_t, ids_t = ours.kneighbors_ids(torch.from_numpy(QUERIES))
    assert isinstance(d_t, torch.Tensor) and np.array_equal(ids_t, np.asarray(jids))


def test_string_ids():
    names = np.array([f"row{i}" for i in range(N)])
    model = NearestNeighbors().setK(2).setIdCol("rid").fit(DataFrame({"features": list(ITEMS), "rid": list(names)}))
    theirs = jax_neighbors.NearestNeighbors().setK(2).setIdCol("rid").fit(
        JaxDataFrame({"features": list(ITEMS), "rid": list(names)}))
    assert np.array_equal(model.kneighbors_ids(ITEMS[:4])[1], theirs.kneighbors_ids(ITEMS[:4])[1])


def test_without_ids_kneighbors_ids_is_kneighbors():
    model = NearestNeighbors().setK(K).fit(ITEMS)
    d, idx = model.kneighbors_ids(QUERIES)
    assert np.array_equal(idx, model.kneighbors(QUERIES)[1])


@pytest.mark.parametrize("kind", ["dataframe", "pandas_column"])
def test_transform_appends_the_reference_columns(kind):
    ours, theirs, _, _ = _fit_both(kind)
    data, _ = _inputs(kind, DataFrame, torch.from_numpy)
    jdata, _ = _inputs(kind, JaxDataFrame, jnp.asarray)
    out, jout = ours.transform(data), theirs.transform(jdata)
    assert list(out.columns) == list(jout.columns)
    col = (lambda f, c: f.select(c)) if kind == "dataframe" else (lambda f, c: list(f[c]))
    assert np.array_equal(np.stack(col(out, "knn_indices")), np.stack(col(jout, "knn_indices")))
    # Each row finds itself: a float32 self-distance is ‖x‖² − 2·x·x + ‖x‖²,
    # which rounds to a few ulps of ‖x‖², so squares are held to that floor.
    floor = 1e-6 * float(np.max(np.sum(ITEMS ** 2, axis=1)))
    assert_close("transform distances", np.stack(col(out, "knn_distances")).astype(np.float64) ** 2,
                 np.stack(col(jout, "knn_distances")) ** 2, rtol=1e-5, atol=floor)


def test_transform_of_a_matrix_is_kneighbors():
    model = NearestNeighbors().setK(K).fit(ITEMS)
    d, idx = model.transform(QUERIES)
    assert np.array_equal(idx, model.kneighbors(QUERIES)[1])


def _sources(tmp_path):
    path = str(tmp_path / "items.npy")
    np.save(path, ITEMS)
    blocks = [ITEMS[i:i + 64] for i in range(0, N, 64)]
    return {
        "factory": lambda: iter(blocks),
        "host_reader": HostArrayBlockReader(ITEMS, block_rows=64),
        "npy_reader": native.NpyBlockReader(path, block_rows=64),
    }


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("source", ["factory", "host_reader", "npy_reader"])
def test_streamed_index_matches_the_reference(tmp_path, source, metric):
    ours = NearestNeighbors().setK(K).setMetric(metric).fit(_sources(tmp_path)[source])
    blocks = [ITEMS[i:i + 64] for i in range(0, N, 64)]
    theirs = jax_neighbors.NearestNeighbors().setK(K).setMetric(metric).fit(lambda: iter(blocks))
    q = torch.from_numpy(QUERIES)
    _hold(f"{source}/{metric}", ours.kneighbors(q), theirs.kneighbors(jnp.asarray(QUERIES)), tight=True)
    resident = NearestNeighbors().setK(K).setMetric(metric).fit(torch.from_numpy(ITEMS))
    assert all(torch.equal(a, b) for a, b in zip(ours.kneighbors(q), resident.kneighbors(q)))


def test_streamed_k_is_checked_against_the_stream():
    model = NearestNeighbors().setK(K).fit(lambda: iter([ITEMS[:3]]))
    with pytest.raises(ValueError, match="k=5 exceeds streamed item count 3"):
        model.kneighbors(QUERIES)


def _message(fn):
    try:
        fn()
    except (ValueError, RuntimeError, KeyError) as exc:
        return type(exc), str(exc)
    raise AssertionError("no error raised")


ERRORS = {
    "bad_metric": lambda p: p.NearestNeighbors().setMetric("manhattan"),
    "k_over_items": lambda p: p.NearestNeighbors().setK(N + 1).fit(ITEMS),
    "id_col_on_a_matrix": lambda p: p.NearestNeighbors().setIdCol("rid").fit(ITEMS),
    "missing_id_col": lambda p: p.NearestNeighbors().setIdCol("nope").fit(
        pd.DataFrame({"features": list(ITEMS)})),
    "kneighbors_k_zero": lambda p: p.NearestNeighbors().setK(3).fit(ITEMS).kneighbors(QUERIES, k=0),
    "kneighbors_k_over": lambda p: p.NearestNeighbors().setK(3).fit(ITEMS).kneighbors(QUERIES, k=N + 1),
    "no_items": lambda p: p.NearestNeighborsModel().kneighbors(QUERIES),
    "one_shot_generator": lambda p: p.NearestNeighbors().fit(b for b in [ITEMS]),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_the_reference(case):
    from spark_rapids_ml_tpu_torch import neighbors as port_neighbors

    assert _message(lambda: ERRORS[case](port_neighbors)) == _message(lambda: ERRORS[case](jax_neighbors))


def test_a_mesh_is_left_for_a_later_slice():
    """Ported since: a mesh on the estimator or on a fitted model searches
    the sharded index and finds the single-device neighbours; a streamed
    index still refuses a mesh, as in the reference."""
    mesh = make_mesh((4, 2), devices=[torch.device("cpu")] * 8)
    want_d, want_i = NearestNeighbors().setK(K).fit(ITEMS).kneighbors(QUERIES)
    for model in (NearestNeighbors(mesh=mesh).setK(K).fit(ITEMS),
                  NearestNeighbors().setK(K).fit(ITEMS).setMesh(mesh)):
        d, idx = model.kneighbors(QUERIES)
        assert np.array_equal(idx, want_i)
        assert_close("mesh distances", d, want_d, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="single-device"):
        NearestNeighbors(mesh=object()).fit(lambda: iter([ITEMS]))


def test_the_cuda_platform_without_a_card_raises(monkeypatch):
    model = NearestNeighbors().setK(K).fit(ITEMS)
    port_device.set_platform("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        model.kneighbors(QUERIES)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_a_resident_model_pickles(kind):
    ours, _, q, _ = _fit_both(kind)
    back = cloudpickle.loads(cloudpickle.dumps(ours))
    assert isinstance(back.items, np.ndarray) and np.array_equal(back.items, ITEMS)
    assert np.array_equal(np.asarray(back.kneighbors(QUERIES)[1]), np.asarray(ours.kneighbors(QUERIES)[1]))


@pytest.mark.parametrize("dumps", [pickle.dumps, cloudpickle.dumps])
def test_a_streamed_model_does_not_pickle(dumps):
    ours = NearestNeighbors().fit(lambda: iter([ITEMS]))
    theirs = jax_neighbors.NearestNeighbors().fit(lambda: iter([ITEMS]))
    with pytest.raises(ValueError) as got:
        dumps(ours)
    with pytest.raises(ValueError) as want:
        dumps(theirs)
    assert str(got.value) == str(want.value)


def test_a_streamed_model_does_not_save(tmp_path):
    ours = NearestNeighbors().fit(lambda: iter([ITEMS]))
    theirs = jax_neighbors.NearestNeighbors().fit(lambda: iter([ITEMS]))
    assert _message(lambda: ours.write.overwrite().save(str(tmp_path / "a"))) == \
        _message(lambda: theirs.write.overwrite().save(str(tmp_path / "b")))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_save_load_both_ways(tmp_path, direction):
    frame = {"features": list(ITEMS), "rid": list(IDS)}
    ours = NearestNeighbors().setK(4).setMetric("cosine").setIdCol("rid").fit(DataFrame(frame))
    theirs = jax_neighbors.NearestNeighbors().setK(4).setMetric("cosine").setIdCol("rid").fit(JaxDataFrame(frame))
    path = str(tmp_path / "nn")
    saver, loader = {
        "port_to_jax": (ours, jax_neighbors.NearestNeighborsModel),
        "jax_to_port": (theirs, NearestNeighborsModel),
        "port_to_port": (ours, NearestNeighborsModel),
    }[direction]
    saver.write.overwrite().save(path)
    loaded = loader.load(path)
    assert loaded.getK() == 4 and loaded.getMetric() == "cosine" and loaded.getIdCol() == "rid"
    assert np.array_equal(loaded.items, ITEMS) and np.array_equal(loaded.ids, IDS)
    assert np.array_equal(np.asarray(loaded.kneighbors_ids(QUERIES)[1]), np.asarray(ours.kneighbors_ids(QUERIES)[1]))


def test_interop_carries_the_reference_model():
    theirs = jax_neighbors.NearestNeighbors().setK(6).setMetric("sqeuclidean").fit(ITEMS)
    params = {p.name: v for p, v in theirs.extractParamMap().items()}
    ours = interop.nearest_neighbors_model_from_numpy(np.asarray(theirs.items), uid=theirs.uid, params=params)
    assert ours.uid == theirs.uid and ours.getK() == 6 and ours.getMetric() == "sqeuclidean"
    _hold("interop", ours.kneighbors(torch.from_numpy(QUERIES)), theirs.kneighbors(jnp.asarray(QUERIES)), tight=True)
    with pytest.raises(ValueError, match=r"ids must be \(200,\)"):
        interop.nearest_neighbors_model_from_numpy(ITEMS, ids=IDS[:3])
