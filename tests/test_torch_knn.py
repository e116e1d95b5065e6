"""The port's exact kNN (``ops/knn.py``) and ``_knn_excluding_self``
against the JAX package's, on the same numpy inputs.

Tolerances: indices exact; distances rtol 1e-5 in float32 (the two
packages' GEMMs round differently) and 1e-10 in float64. Ties go to the
lower item index in both (duplicate rows make exact ties). The distance
to an exact duplicate is ‖q‖² − 2·q·x + ‖x‖², a float32 cancellation
that either package may round to 0 or to a few ulps of ‖x‖²: there the
squared distances are held within 1e-6 of max ‖x‖².
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models.umap import _knn_excluding_self as jax_knn_excluding_self
from spark_rapids_ml_tpu.ops.knn import knn as jax_knn
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.models.umap import _knn_excluding_self
from spark_rapids_ml_tpu_torch.ops import knn as port_knn
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

METRICS = ("euclidean", "sqeuclidean", "cosine")
RTOL = {np.float32: 1e-5, np.float64: 1e-10}


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _data(nq, n, d, dtype, seed, dups=0):
    rng = np.random.default_rng(seed)
    items = rng.standard_normal((n, d)) + 0.5
    if dups:
        items[-dups:] = items[:dups]  # exact duplicates: ties at every distance
    queries = np.concatenate([rng.standard_normal((nq - dups, d)), items[:dups]]) if dups else \
        rng.standard_normal((nq, d))
    return queries.astype(dtype), items.astype(dtype)


def _both(queries, items, k, **kw):
    mask = kw.pop("item_mask", None)
    jd, ji = jax_knn(jnp.asarray(queries), jnp.asarray(items), k,
                     None if mask is None else jnp.asarray(mask), **kw)
    pd_, pi = port_knn.knn(torch.from_numpy(queries), torch.from_numpy(items), k,
                           None if mask is None else torch.from_numpy(mask), **kw)
    return (np.asarray(jd), np.asarray(ji)), (pd_.numpy(), pi.numpy())


def _hold(name, want, got, dtype):
    (jd, ji), (pd_, pi) = want, got
    assert pi.dtype == np.int32 and pd_.dtype == dtype
    assert np.array_equal(pi, ji), f"{name}: indices differ in {np.sum(pi != ji)} places"
    finite = np.isfinite(jd)
    assert np.array_equal(finite, np.isfinite(pd_)), name
    assert_close(f"{name} distances", pd_[finite], jd[finite], rtol=RTOL[dtype], atol=1e-6 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block_items", [None, 64])
@pytest.mark.parametrize("metric", METRICS)
def test_knn_matches_jax(metric, block_items, dtype):
    queries, items = _data(70, 300, 12, dtype, seed=1)
    want, got = _both(queries, items, 10, metric=metric, block_items=block_items)
    _hold(f"{metric} block={block_items}", want, got, dtype)


@pytest.mark.parametrize("metric", METRICS)
def test_masked_items_match_jax(metric):
    queries, items = _data(40, 90, 6, np.float32, seed=2)
    mask = np.ones(90, dtype=np.float32)
    mask[::3] = 0.0
    want, got = _both(queries, items, 8, metric=metric, item_mask=mask, block_items=32)
    _hold(f"masked {metric}", want, got, np.float32)
    assert not np.isin(got[1], np.arange(0, 90, 3)).any()


def test_k_beyond_the_real_items_leaves_inf_and_minus_one():
    queries, items = _data(5, 12, 4, np.float64, seed=3)
    mask = np.zeros(12)
    mask[:4] = 1.0
    want, got = _both(queries, items, 6, item_mask=mask, metric="sqeuclidean")
    _hold("k > real items", want, got, np.float64)
    assert (got[1][:, 4:] == -1).all() and np.isinf(got[0][:, 4:]).all()


@pytest.mark.parametrize("k", [1, 200])
def test_k_of_one_and_of_every_item(k):
    queries, items = _data(30, 200, 7, np.float32, seed=4)
    want, got = _both(queries, items, k, metric="sqeuclidean", block_items=48)
    _hold(f"k={k}", want, got, np.float32)
    if k == 200:
        assert all(sorted(row) == list(range(200)) for row in got[1].tolist())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block_items", [None, 50])
def test_ties_go_to_the_lower_index(dtype, block_items):
    queries, items = _data(40, 160, 5, dtype, seed=5, dups=20)
    want, got = _both(queries, items, 6, metric="sqeuclidean", block_items=block_items)
    _hold("duplicates", want, got, dtype)
    # A duplicated query finds its first copy before its second.
    first = got[1][-20:, 0]
    assert np.array_equal(first, np.arange(20))


def test_brute_approx_is_exact():
    queries, items = _data(30, 120, 8, np.float32, seed=6)
    exact = port_knn.knn(torch.from_numpy(queries), torch.from_numpy(items), 5)
    approx = port_knn.knn(torch.from_numpy(queries), torch.from_numpy(items), 5, approx=True)
    assert torch.equal(exact[1], approx[1]) and torch.equal(exact[0], approx[0])
    want, _ = _both(queries, items, 5, approx=True)  # exact on the reference's CPU too
    assert np.array_equal(want[1], exact[1].numpy())


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("dups", [0, 15])
def test_knn_excluding_self_matches_jax(metric, dups):
    _, x = _data(max(dups, 1), 150, 9, np.float32, seed=7, dups=dups)
    jd, ji = jax_knn_excluding_self(jnp.asarray(x), 10, metric)
    pd_, pi = _knn_excluding_self(torch.from_numpy(x), 10, metric)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    floor = 1e-6 * float(np.max(np.sum(x.astype(np.float64) ** 2, axis=1)))
    assert_close("excluding self", pd_ ** 2, np.asarray(jd) ** 2, rtol=1e-5, atol=floor)
    assert not (pi.numpy() == np.arange(150)[:, None]).any()


def test_refusals_and_waiting_routes():
    q = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="k must be"):
        port_knn.knn(q, q, 4)
    with pytest.raises(ValueError, match="unknown metric"):
        port_knn.knn(q, q, 1, metric="manhattan")
    with pytest.raises(ValueError, match="exceeds streamed item count 3"):
        port_knn.knn_host_streamed(q, [q.numpy()], 4)
    # The sharded search runs on a mesh of this process's positions; a mesh
    # that says it spans more processes than the gang has is refused.
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    xs, mask = port_knn.shard_items(q.numpy(), mesh)
    with pytest.raises(ValueError, match="unknown metric"):
        port_knn.knn_sharded(q, xs, mask, mesh, 1, metric="manhattan")
    d, idx = port_knn.knn_sharded(q, xs, mask, mesh, 3)
    assert torch.equal(idx, torch.tensor([[0, 1, 2]] * 3, dtype=torch.int32)) and torch.all(d == 0)
    for call in (lambda: port_knn.shard_items(q, _gang_mesh()),
                 lambda: port_knn.knn_sharded(q, xs, mask, _gang_mesh(), 1)):
        with pytest.raises(ValueError, match=r"spans 2 processes but this gang has 1"):
            call()


def _gang_mesh():
    """A one-position mesh that says it spans two processes (this process
    is in no gang)."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

    devices = np.empty((1, 1), dtype=object)
    devices[0, 0] = torch.device("cpu")
    return Mesh(devices, processes=2)


def test_auto_block_items_is_the_reference_rule():
    from spark_rapids_ml_tpu.ops.knn import _auto_block_items as jax_rule

    for nq, n in [(1, 10), (50_000, 50_000), (10, 10**6), (10**6, 10**6), (2000, 3000)]:
        assert port_knn._auto_block_items(nq, n) == jax_rule(nq, n)
