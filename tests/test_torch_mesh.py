"""The port's mesh fabric against the JAX package's, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``;
the port side on ``make_mesh(shape, devices=[cpu] * 8)`` (torch has no
virtual devices, so a device repeats). Placement is held to the
reference exactly — padding and mask included — for ``shard_rows``,
``shard_rows_from_partitions``, ``weights_as_mask`` and the mesh branches
of ``prepare_rows`` (the cases of ``tests/test_multiprocess.py`` and
``tests/test_distributed.py``); ``ShiftedMoments`` to 1e-12 on the same
blocks; the mesh covariances in float64 to 1e-12, padded rows included;
the mesh errors word for word.
"""

import importlib
import pickle

import jax
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.core import ingest as jingest
from spark_rapids_ml_tpu.core import membudget as jmb
from spark_rapids_ml_tpu.core.moments import ShiftedMoments as JaxMoments
from spark_rapids_ml_tpu.parallel import distributed_cov as jdc
from spark_rapids_ml_tpu.parallel import mesh as jmesh
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.core import ingest as tingest
from spark_rapids_ml_tpu_torch.core import membudget as tmb
from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments
from spark_rapids_ml_tpu_torch.parallel import collectives
from spark_rapids_ml_tpu_torch.parallel import distributed_cov as tdc
from spark_rapids_ml_tpu_torch.parallel import mesh as tmesh
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

# ``ops`` re-exports a function named ``covariance`` in the reference.
jcov = importlib.import_module("spark_rapids_ml_tpu.ops.covariance")
tcov = importlib.import_module("spark_rapids_ml_tpu_torch.ops.covariance")

CPU = torch.device("cpu")
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def port_mesh(shape):
    return tmesh.make_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


def jax_mesh(shape):
    return jmesh.make_mesh(shape)


def _rows(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d))


# --- make_mesh ----------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shape_reads_like_the_reference(shape):
    ours, theirs = port_mesh(shape), jax_mesh(shape)
    assert ours.shape == dict(theirs.shape)
    assert ours.axis_names == tuple(theirs.axis_names)
    assert ours.devices.shape == theirs.devices.shape
    assert tmesh.model_axis_size(ours) == jmesh.model_axis_size(theirs)


def test_default_mesh_is_every_device_on_the_data_axis():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.first_device == CPU
    assert tmesh.make_mesh(devices=[CPU] * 8).shape == dict(jmesh.make_mesh().shape)
    assert tmesh.single_device_mesh().shape == dict(jmesh.single_device_mesh().shape)


@pytest.mark.parametrize("shape", [(3, 3), (8, 2), (16, 1)])
def test_make_mesh_errors_match_the_reference(shape):
    with pytest.raises(ValueError) as ours:
        tmesh.make_mesh(shape, devices=[CPU] * 8)
    with pytest.raises(ValueError) as theirs:
        jmesh.make_mesh(shape)
    assert str(ours.value) == str(theirs.value)


def test_a_one_axis_mesh_has_model_axis_one():
    ours = tmesh.Mesh(np.array([CPU] * 8, dtype=object), (tmesh.DATA_AXIS,))
    theirs = jax.sharding.Mesh(np.array(jax.devices()), (jmesh.DATA_AXIS,))
    assert ours.shape == dict(theirs.shape)
    assert tmesh.model_axis_size(ours) == jmesh.model_axis_size(theirs) == 1
    xs = tmesh.shard_rows(_rows(0, 13, 4), ours)
    assert (xs.n, xs.shape) == (13, (16, 4))


def test_the_mesh_needs_a_card_on_cuda():
    port_device.set_platform("cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="set_platform"):
        tmesh.make_mesh()


# --- placement ------------------------------------------------------------

PLACEMENTS = {
    # tests/test_multiprocess.py:46-73 and tests/test_distributed.py:34-60
    "1003x12_three_parts": (1003, 12, [100, 700]),
    "65x7_two_parts": (65, 7, [30]),
    "37x5_one_part": (37, 5, []),
    "13x4_one_part": (13, 4, []),
    "203x7_four_parts": (203, 7, [1, 50, 51]),
    "8x3_exact": (8, 3, [4]),
}


def _split(x, cuts):
    return np.split(x, cuts) if cuts else [x]


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_shard_rows_from_partitions_places_like_the_reference(case, shape):
    n, d, cuts = PLACEMENTS[case]
    x = _rows(1, n, d)
    ours = tmesh.shard_rows_from_partitions(_split(x, cuts), port_mesh(shape))
    jx, jm, jn = jmesh.shard_rows_from_partitions(_split(x, cuts), jax_mesh(shape))
    got_x, got_m = ours.numpy()
    np.testing.assert_array_equal(got_x, np.asarray(jx))
    np.testing.assert_array_equal(got_m, np.asarray(jm))
    assert (ours.n, ours.d, ours.shape) == (jn, d, tuple(jx.shape))
    assert sum(ours.valid) == n


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_shard_rows_is_the_one_partition_case(shape):
    x = _rows(2, 37, 5)
    ours = tmesh.shard_rows(x, port_mesh(shape))
    jx, jm, jn = jmesh.shard_rows(x, jax_mesh(shape))
    np.testing.assert_array_equal(ours.numpy()[0], np.asarray(jx))
    np.testing.assert_array_equal(ours.numpy()[1], np.asarray(jm))
    assert ours.n == jn == 37


def test_shards_sit_on_their_positions_and_sum_to_the_rows():
    mesh = port_mesh((4, 2))
    xs = tmesh.shard_rows(_rows(3, 19, 7), mesh)
    assert len(xs.blocks) == 4 and all(len(row) == 2 for row in xs.blocks)
    assert (xs.rows_per, xs.cols_per, xs.d_pad) == (5, 4, 8)
    assert xs.valid == [5, 5, 5, 4] and xs.offsets == [0, 5, 10, 15]
    assert torch.equal(torch.cat([xs.local_rows(i) for i in range(4)]), torch.from_numpy(_rows(3, 19, 7)))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_device_array_rows_on_mesh_places_like_the_reference(shape):
    x = _rows(4, 64, 8)
    ours = tmesh.device_array_rows_on_mesh(torch.from_numpy(x), port_mesh(shape), shard_features=True)
    theirs = jmesh.device_array_rows_on_mesh(jax.numpy.asarray(x), jax_mesh(shape), shard_features=True)
    np.testing.assert_array_equal(ours.numpy()[0], np.asarray(theirs))


@pytest.mark.parametrize("rows,cols,shard_features", [(13, 8, False), (16, 7, True)])
def test_device_array_rows_on_mesh_errors_match_the_reference(rows, cols, shard_features):
    x = _rows(5, rows, cols)
    with pytest.raises(ValueError) as ours:
        tmesh.device_array_rows_on_mesh(torch.from_numpy(x), port_mesh((4, 2)), shard_features=shard_features)
    with pytest.raises(ValueError) as theirs:
        jmesh.device_array_rows_on_mesh(jax.numpy.asarray(x), jax_mesh((4, 2)), shard_features=shard_features)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("n_rows", [16, 24])
def test_weights_as_mask_matches_the_reference(shape, n_rows):
    w = np.random.default_rng(6).uniform(0.5, 2.0, size=13)
    ours = tmesh.weights_as_mask(w, n_rows, np.float64, port_mesh(shape))
    theirs = jmesh.weights_as_mask(w, n_rows, np.float64, jax_mesh(shape))
    np.testing.assert_array_equal(torch.cat(ours).numpy(), np.asarray(theirs))
    flat = tmesh.weights_as_mask(w, n_rows, np.float64)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jmesh.weights_as_mask(w, n_rows, np.float64)))


# --- ingest -------------------------------------------------------------

INGEST = {
    "host_partitions": lambda x: [x[:30], x[30:]],
    "host_matrix": lambda x: x,
    "tensor": lambda x: torch.from_numpy(x),
}


def _jax_input(x, kind):
    if kind == "tensor":
        return jax.numpy.asarray(x)
    return INGEST[kind](x)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("kind", list(INGEST))
def test_prepare_rows_on_a_mesh_matches_the_reference(kind, shape, weighted):
    x = _rows(7, 61, 7)
    w = np.random.default_rng(8).uniform(0.1, 3.0, size=61) if weighted else None
    ours = tingest.prepare_rows(INGEST[kind](x), mesh=port_mesh(shape), dtype=torch.float64, weights=w)
    theirs = jingest.prepare_rows(_jax_input(x, kind), mesh=jax_mesh(shape), dtype=np.float64, weights=w)
    got_x, got_m = ours.x.numpy()
    np.testing.assert_array_equal(got_x, np.asarray(theirs.x))
    np.testing.assert_array_equal(got_m, np.asarray(theirs.mask))
    assert (ours.n_true, ours.d_true) == (theirs.n_true, theirs.d_true)
    assert ours.x.weighted == weighted


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_prepare_labels_on_a_mesh_follow_the_rows(shape):
    x = _rows(9, 61, 7)
    y = np.arange(61.0)
    prep = tingest.prepare_rows(x, mesh=port_mesh(shape), dtype=torch.float64)
    ys = tingest.prepare_labels(y, prep.n_true, dtype=torch.float64, rows=prep.x)
    jprep = jingest.prepare_rows(x, mesh=jax_mesh(shape), dtype=np.float64)
    jys = jingest.prepare_labels(y, int(jprep.x.shape[0]), n_true=61, mesh=jax_mesh(shape), dtype=np.float64)
    np.testing.assert_array_equal(torch.cat(ys).numpy(), np.asarray(jys))
    with pytest.raises(ValueError, match="label vector has 60 entries"):
        tingest.prepare_labels(y[:60], prep.n_true, dtype=torch.float64, rows=prep.x)


@pytest.mark.parametrize("shape", [None, (8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_padded_input_bytes_prices_the_mesh_padding(shape, dtype):
    ours = tmb.padded_input_bytes(203, 7, dtype, None if shape is None else port_mesh(shape))
    theirs = jmb.padded_input_bytes(203, 7, dtype, None if shape is None else jax_mesh(shape))
    assert ours == theirs


def test_a_mesh_fit_passes_the_memory_gate(monkeypatch):
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1000")
    guard = tmb.fit_memory_guard("pca", _rows(10, 500, 8), can_stream=True, mesh=port_mesh((8, 1)))
    jguard = jmb.fit_memory_guard("pca", _rows(10, 500, 8), can_stream=True, mesh=jax_mesh((8, 1)))
    assert guard.degrade is jguard.degrade is False


# --- ShiftedMoments -----------------------------------------------------


def _blocks(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(loc=5.0, size=(m, 6)) for m in (7, 1, 12, 0, 9)]


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shifted_moments_match_the_reference(seed, center):
    blocks = _blocks(seed)
    ours, theirs = ShiftedMoments(6), JaxMoments(6)
    for b in blocks[:3]:
        ours.add_block(b)
        theirs.add_block(b)
    other, jother = ShiftedMoments(6), JaxMoments(6)
    for b in blocks[3:]:
        other.add_block(b)
        jother.add_block(b)
    ours.merge(other)
    theirs.merge(jother)
    for got, want in zip(ours.finalize(center=center), theirs.finalize(center=center)):
        assert_close("moments", got, want, rtol=1e-12, atol=1e-12)
    full = np.concatenate(blocks)
    want_cov = np.cov(full, rowvar=False) if center else full.T @ full / (full.shape[0] - 1)
    assert_close("cov", ours.finalize(center=center)[0], want_cov, rtol=1e-12, atol=1e-12)


def test_shifted_moments_pickle_and_refuse_what_the_reference_refuses():
    m = ShiftedMoments(6).add_block(_blocks(3)[0])
    back = pickle.loads(pickle.dumps(m))
    np.testing.assert_array_equal(back.gram, m.gram)
    assert back.n_rows == m.n_rows
    for fn in (lambda cls: cls(6).add_block(np.zeros((3, 5))),
               lambda cls: cls(6).merge(cls(5)),
               lambda cls: cls(6).add_block(np.zeros((1, 6))).finalize()):
        with pytest.raises(ValueError) as ours:
            fn(ShiftedMoments)
        with pytest.raises(ValueError) as theirs:
            fn(JaxMoments)
        assert str(ours.value) == str(theirs.value)


# --- mesh covariance ------------------------------------------------------

COV_CASES = {
    # tests/test_distributed.py's shapes, and heavy padding
    "200x12": (200, 12),
    "100x10": (100, 10),
    "64x8": (64, 8),
    "19x5": (19, 5),
    "203x7": (203, 7),
}


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("case", list(COV_CASES))
def test_distributed_mean_and_covariance_matches_jax(case, shape, center):
    x = _rows(11, *COV_CASES[case]) + 3.0
    xs = tmesh.shard_rows(x, port_mesh(shape))
    mean, cov = tdc.distributed_mean_and_covariance(xs, None, port_mesh(shape), center=center)
    jx, jm, _ = jmesh.shard_rows(x, jax_mesh(shape))
    jmean, jc = jdc.distributed_mean_and_covariance(jx, jm, jax_mesh(shape), center=center)
    assert_close("mean", mean, np.asarray(jmean), rtol=1e-12, atol=1e-12)
    assert_close("cov", cov, np.asarray(jc), rtol=1e-12, atol=1e-12)
    d = x.shape[1]
    if center:
        assert_close("cov vs numpy", cov[:d, :d], np.cov(x, rowvar=False), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("case", list(COV_CASES))
def test_distributed_covariance_shard_map_matches_jax(case, shape):
    x = _rows(12, *COV_CASES[case])
    xs = tmesh.shard_rows(x, port_mesh(shape))
    mean, cov = tdc.distributed_covariance_shard_map(xs, None, port_mesh(shape))
    jx, jm, _ = jmesh.shard_rows(x, jax_mesh(shape))
    jmean, jc = jdc.distributed_covariance_shard_map(jx, jm, jax_mesh(shape))
    assert_close("mean", mean, np.asarray(jmean), rtol=1e-12, atol=1e-12)
    assert_close("cov", cov, np.asarray(jc), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_a_weighted_mask_weighs_like_the_reference(shape):
    x = _rows(13, 61, 6)
    w = np.random.default_rng(14).uniform(0.2, 2.0, size=61)
    prep = tingest.prepare_rows(x, mesh=port_mesh(shape), dtype=torch.float64, weights=w)
    jprep = jingest.prepare_rows(x, mesh=jax_mesh(shape), dtype=np.float64, weights=w)
    for fn, jfn in ((tdc.distributed_mean_and_covariance, jdc.distributed_mean_and_covariance),
                    (tdc.distributed_covariance_shard_map, jdc.distributed_covariance_shard_map)):
        mean, cov = fn(prep.x, None, port_mesh(shape))
        jmean, jc = jfn(jprep.x, jprep.mask, jax_mesh(shape))
        assert_close("weighted mean", mean, np.asarray(jmean), rtol=1e-12, atol=1e-12)
        assert_close("weighted cov", cov, np.asarray(jc), rtol=1e-12, atol=1e-12)


def test_padded_rows_do_not_pollute():
    x = _rows(15, 19, 5)  # 19 rows pad to 24 on eight shards
    xs = tmesh.shard_rows(x, port_mesh((8, 1)))
    xs.blocks[-1][0][-5:] = 1e6  # pad rows: never read
    _, cov = tdc.distributed_mean_and_covariance(xs, None, port_mesh((8, 1)))
    assert_close("cov", cov, np.cov(x, rowvar=False), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("center", [True, False])
def test_streamed_mesh_covariance_matches_jax(shape, center):
    x = _rows(16, 203, 7) + 2.0
    blocks = [x[:50], x[50:51], x[51:]]
    mean, cov, n = tcov.streaming_mean_and_covariance_mesh(iter(blocks), port_mesh(shape), center=center)
    jmean, jc, jn = jcov.streaming_mean_and_covariance_mesh(iter(blocks), jax_mesh(shape), center=center)
    assert n == jn == 203
    assert_close("mean", mean, jmean, rtol=1e-12, atol=1e-12)
    assert_close("cov", cov, jc, rtol=1e-12, atol=1e-12)
    # The (1, 1) mesh is the single-device scan, bit for bit.
    one = tcov.streaming_mean_and_covariance_mesh(iter(blocks), port_mesh((1, 1)), center=center)
    single = tcov.streaming_mean_and_covariance(iter(blocks), center=center, device=CPU)
    np.testing.assert_array_equal(one[1], single[1])


# --- collectives outside a gang -----------------------------------------


def test_collectives_outside_a_gang():
    assert (collectives.process_count(), collectives.process_index(), collectives.in_gang()) == (1, 0, False)
    a, b = torch.arange(4.0), torch.ones(4)
    assert collectives.psum_data([a]) is a
    assert torch.equal(collectives.psum_data([a, b]), a + b)
    assert torch.equal(collectives.all_gather_model([a[None], b[None]]), torch.cat([a, b])[None])
    assert torch.equal(collectives.allreduce_slots(a), a[None])
    with pytest.raises(ValueError, match="at least one"):
        collectives.psum_data([])
