"""The port's streamed kNN (``ops/knn.py``: ``_merge_block_topk``,
``knn_host_streamed``) against the JAX package's, on the same numpy
inputs.

Tolerances: float64 queries give the same indices and distances within
1e-10; float32 the same indices (the data has no near-ties) and
distances within 1e-5 relative. The streamed result does not depend on
how the items are cut into blocks: it equals the port's resident
``knn`` bit for bit in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import knn as jax_knn
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import native
from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader, iter_stream_blocks
from spark_rapids_ml_tpu_torch.ops import knn as port_knn
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

METRICS = ("euclidean", "sqeuclidean", "cosine")
RTOL = {np.float32: 1e-5, np.float64: 1e-10}
N, D, NQ, K = 600, 12, 30, 7

#: Block row counts: ragged, with empty blocks, and narrower than k.
LAYOUTS = {
    "ragged": [250, 250, 100],
    "empty": [0, 300, 0, 300, 0],
    "narrow": [5] * 8 + [560],
}


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _corpus(dtype=np.float64):
    rng = np.random.default_rng(5)
    items = rng.standard_normal((N, D)) + 0.25
    queries = rng.standard_normal((NQ, D))
    return queries.astype(dtype), items.astype(dtype)


def _cut(items, sizes):
    starts = np.concatenate([[0], np.cumsum(sizes)])
    return [items[a:b] for a, b in zip(starts[:-1], starts[1:])]


def _hold(name, got, want, dtype):
    (pd_, pi), (jd, ji) = got, want
    pd_, pi, jd, ji = pd_.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji)
    assert pi.dtype == np.int32 and pd_.dtype == dtype, name
    assert np.array_equal(pi, ji), f"{name}: indices differ in {np.sum(pi != ji)} places"
    finite = np.isfinite(jd)  # unfilled slots read (inf, -1) in both
    assert np.array_equal(finite, np.isfinite(pd_)), name
    assert_close(f"{name} distances", pd_[finite], jd[finite], rtol=RTOL[dtype], atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("metric", METRICS)
def test_streamed_matches_the_reference(metric, layout, dtype):
    queries, items = _corpus(dtype)
    blocks = _cut(items, LAYOUTS[layout])
    got = port_knn.knn_host_streamed(torch.from_numpy(queries), blocks, K, metric=metric)
    want = jax_knn.knn_host_streamed(jnp.asarray(queries), blocks, K, metric=metric)
    _hold(f"{metric}/{layout}", got, want, dtype)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("metric", METRICS)
def test_streamed_is_the_resident_search(metric, layout):
    queries, items = _corpus()
    q = torch.from_numpy(queries)
    sd, si = port_knn.knn_host_streamed(q, _cut(items, LAYOUTS[layout]), K, metric=metric)
    rd, ri = port_knn.knn(q, torch.from_numpy(items), K, metric=metric)
    assert torch.equal(si, ri) and torch.equal(sd, rd)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("start", [0, 1000])
def test_merge_block_topk_matches_the_reference(start, dtype, approx):
    queries, items = _corpus(dtype)
    q_sq = np.sum(queries * queries, axis=1)
    first, second = items[:4], items[4:200]  # the first block is narrower than k
    state_t = (torch.full((NQ, K), float("inf"), dtype=torch.from_numpy(queries).dtype),
               torch.full((NQ, K), -1, dtype=torch.int32))
    state_j = (jnp.full((NQ, K), jnp.inf, dtype=queries.dtype), jnp.full((NQ, K), -1, dtype=jnp.int32))
    for offset, blk in ((start, first), (start + 4, second)):
        state_t = port_knn._merge_block_topk(
            *state_t, torch.from_numpy(queries), torch.from_numpy(q_sq), torch.from_numpy(blk), offset, K,
            approx=approx)
        state_j = jax_knn._merge_block_topk(
            *state_j, jnp.asarray(queries), jnp.asarray(q_sq), jnp.asarray(blk), jnp.int32(offset), K,
            approx=approx)
        _hold(f"merge at {offset}", state_t, state_j, dtype)


def _sources(items, tmp_path):
    path = str(tmp_path / "items.npy")
    np.save(path, items)
    blocks = _cut(items, [128] * 4 + [88])
    return {
        "list": blocks,
        "factory": lambda: iter(blocks),
        "host_reader": HostArrayBlockReader(items, block_rows=128),
        "npy_reader": native.NpyBlockReader(path, block_rows=128),
    }


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("source", ["list", "factory", "host_reader", "npy_reader"])
def test_every_source_kind(tmp_path, source, metric):
    queries, items = _corpus()
    src = _sources(items, tmp_path)[source]
    blocks = src if isinstance(src, list) else iter_stream_blocks(src)
    got = port_knn.knn_host_streamed(torch.from_numpy(queries), blocks, K, metric=metric)
    want = jax_knn.knn(jnp.asarray(queries), jnp.asarray(items), K, metric=metric)
    _hold(f"{source}/{metric}", got, want, np.float64)


def test_float32_blocks_widen_to_float64_queries():
    queries, items = _corpus()
    d64, i64 = port_knn.knn_host_streamed(torch.from_numpy(queries), _cut(items.astype(np.float32), [300, 300]), K)
    want = jax_knn.knn(jnp.asarray(queries), jnp.asarray(items.astype(np.float32).astype(np.float64)), K)
    _hold("f32 blocks", (d64, i64), want, np.float64)


@pytest.mark.parametrize("k,sizes", [(5, [3]), (7, [2, 0, 4]), (1, [0, 0])])
def test_k_over_the_streamed_count_raises_like_the_reference(k, sizes):
    queries, _ = _corpus()
    blocks = [np.ones((s, D)) for s in sizes]
    with pytest.raises(ValueError) as ours:
        port_knn.knn_host_streamed(torch.from_numpy(queries), blocks, k)
    with pytest.raises(ValueError) as theirs:
        jax_knn.knn_host_streamed(jnp.asarray(queries), blocks, k)
    assert str(ours.value) == str(theirs.value) == f"k={k} exceeds streamed item count {sum(sizes)}"


def test_unknown_metric_raises_like_the_reference():
    queries, items = _corpus()
    with pytest.raises(ValueError, match="unknown metric 'manhattan'"):
        port_knn.knn_host_streamed(torch.from_numpy(queries), [items], K, metric="manhattan")
    with pytest.raises(ValueError, match="unknown metric 'manhattan'"):
        jax_knn.knn_host_streamed(jnp.asarray(queries), [items], K, metric="manhattan")


def test_blocks_are_copied_one_ahead():
    from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

    queries, items = _corpus()
    before = counter_value("fit.stream.prefetched")
    port_knn.knn_host_streamed(torch.from_numpy(queries), _cut(items, LAYOUTS["empty"]), K)
    # Five blocks hand on four after their successor was prepared.
    assert counter_value("fit.stream.prefetched") - before == 4
