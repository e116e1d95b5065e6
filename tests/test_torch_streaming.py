"""The port's streaming PCA routes, against the JAX package and the oracle.

A streaming source is a one-shot block iterator, a zero-argument iterator
factory, or a block reader with ``iter_blocks`` (``HostArrayBlockReader``,
``ArrowBlockReader`` over parquet). The port's pieces are held against
their JAX twins on the same numpy blocks:

- ``core/data.py`` stream helpers and readers, ``core/serving.py``
  ``prefetch_blocks``: exact equality;
- ``ops/covariance.py`` ``streaming_mean_and_covariance``,
  ``finalize_shifted_gram`` and ``welford_merge``: 1e-10;
- streaming ``PCA`` fits: components 1e-8 elementwise, explained variance
  1e-10 against JAX (float64 both), and the oracle's 1e-5; ``dd`` is
  native float64 in the port, held to the oracle at 1e-8 and to JAX's
  double-float emulation at 1e-5;
- the streaming transform: 1e-10 against JAX's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import numpy_pca_oracle
from spark_rapids_ml_tpu.core import data as jdata
from spark_rapids_ml_tpu.core import serving as jserving
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.linalg.row_matrix import RowMatrix as JaxRowMatrix
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.core import data as tdata
from spark_rapids_ml_tpu_torch.core import serving as tserving
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.linalg.row_matrix import RowMatrix
from spark_rapids_ml_tpu_torch.ops import covariance as tcov
from spark_rapids_ml_tpu_torch.utils.testing import assert_close, seeded_matrix
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

# The JAX package's ``ops/__init__`` exports a function named ``covariance``.
jcov = importlib.import_module("spark_rapids_ml_tpu.ops.covariance")

PC_TOL = 1e-8
EV_TOL = 1e-10
ORACLE_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _data(n: int = 600, d: int = 12, seed: int = 0) -> np.ndarray:
    return seeded_matrix(n, d, seed, scales=np.linspace(3.0, 0.3, d), offset=1.5)


def _blocks(x: np.ndarray, cuts=(100, 101, 350)):
    """Ragged row blocks with an empty block in the middle."""
    edges = [0, *cuts, x.shape[0]]
    out = [x[a:b] for a, b in zip(edges[:-1], edges[1:])]
    return out[:2] + [np.zeros((0, x.shape[1]))] + out[2:]


class _Reader:
    """A minimal block reader: ``iter_blocks`` and a ``dtype``."""

    def __init__(self, blocks, dtype=np.float64):
        self.blocks, self.dtype = blocks, dtype

    def iter_blocks(self):
        return iter(self.blocks)


def _write_parquet(path, x: np.ndarray, packed: bool):
    import pyarrow as pa
    import pyarrow.parquet as pq

    if packed:
        flat = pa.array(x.ravel())
        table = pa.table({"features": pa.FixedSizeListArray.from_arrays(flat, x.shape[1]),
                          "label": np.arange(x.shape[0], dtype=np.float64)})
    else:
        table = pa.table({f"f{j}": x[:, j] for j in range(x.shape[1])} | {
            "label": np.arange(x.shape[0], dtype=np.float64)})
    pq.write_table(table, str(path), row_group_size=97)
    return str(path)


# --- core/data.py -----------------------------------------------------------


def test_stream_kinds_match_jax():
    x = _data(20, 3)

    def needs_args(a):
        return iter([x])

    def factory():
        return iter([x])

    cases = [iter([x]), factory, _Reader([x]), needs_args, [x], x, torch.from_numpy(x), int]
    for case in cases:
        assert tdata.is_streaming_source(case) == jdata.is_streaming_source(case), case
        assert tdata.is_reiterable_stream(case) == jdata.is_reiterable_stream(case), case
    assert tdata.is_reiterable_stream(factory) and not tdata.is_reiterable_stream(iter([x]))
    assert not tdata.is_streaming_source(needs_args)  # a callable that needs arguments


def test_peek_and_iter_stream_blocks_match_jax():
    x = _data(30, 5)
    blocks = [np.zeros((0, 0)), x[:4], x[4:]]
    assert tdata.peek_stream_width(lambda: iter(blocks)) == jdata.peek_stream_width(
        lambda: iter(blocks)) == 5
    reader = _Reader(blocks)
    assert [b.shape for b in tdata.iter_stream_blocks(reader)] == [
        b.shape for b in jdata.iter_stream_blocks(reader)]
    gen = iter(blocks)
    assert tdata.iter_stream_blocks(gen) is gen
    for peek in (tdata.peek_stream_width, jdata.peek_stream_width):
        with pytest.raises(ValueError, match="no rows"):
            peek(lambda: iter([np.zeros((0, 5))]))
    for it in (tdata.iter_stream_blocks, jdata.iter_stream_blocks):
        with pytest.raises(TypeError, match="not a streaming block source"):
            it(x)


@pytest.mark.parametrize("kind", ["float32", "float64", "rows", "sparse", "one_row"])
def test_peek_stream_width_reads_every_block_kind_as_jax_does(kind):
    """The width of the first non-empty block, after an empty one, whatever
    the block's kind; the same as the JAX package's probe."""
    import scipy.sparse as sp

    x = _data(8, 7)
    first = {"float32": x.astype(np.float32), "float64": x, "rows": [list(r) for r in x],
             "sparse": sp.csr_matrix(x), "one_row": x[0]}[kind]
    blocks = [np.zeros((0, 3)), first, x]
    assert tdata.peek_stream_width(lambda: iter(blocks)) == jdata.peek_stream_width(
        lambda: iter(blocks)) == 7


def test_peek_stream_width_reads_an_array_by_its_shape(monkeypatch):
    """A 2-D array block is not densified to read its width."""
    def refuse(*args, **kwargs):
        raise AssertionError("the width probe densified an array block")

    monkeypatch.setattr(tdata, "_block_to_dense", refuse)
    x = _data(8, 7).astype(np.float32)
    assert tdata.peek_stream_width(lambda: iter([x[:0], x])) == 7


def test_upload_block_keeps_float32_and_casts_on_request():
    """Without a dtype a float32 block stays float32 and anything else is
    float64; with one the host block is cast before the copy. The tensor
    holds the host block's values, and an empty block stays empty."""
    x = _data(6, 4)
    host, dev = tserving.upload_block(x.astype(np.float32), CPU)
    assert host.dtype == np.float32 and dev.dtype == torch.float32
    host, dev = tserving.upload_block([list(r) for r in x], CPU)
    assert host.dtype == np.float64 and np.array_equal(dev.numpy(), x)
    host, dev = tserving.upload_block(x, CPU, torch.float32)
    assert host.dtype == np.float32 and np.array_equal(dev.numpy(), x.astype(np.float32))
    host, dev = tserving.upload_block([], CPU)
    assert host.shape[0] == 0 and dev.shape[0] == 0


def test_as_partitions_refuses_a_stream():
    x = _data(10, 3)
    with pytest.raises(ValueError, match="pass it to fit"):
        tdata.as_partitions(lambda: iter([x]))
    with pytest.raises(ValueError, match="pass it to fit"):
        tdata.as_matrix(iter([x]))


@pytest.mark.parametrize("knob", [None, "7", "1"])
def test_fit_block_rows_matches_jax(knob, monkeypatch):
    if knob is None:
        monkeypatch.delenv(tdata.FIT_BLOCK_ROWS_ENV, raising=False)
    else:
        monkeypatch.setenv(tdata.FIT_BLOCK_ROWS_ENV, knob)
    assert tdata.fit_block_rows() == jdata.fit_block_rows()
    x = _data(20, 3)
    ours, theirs = tdata.HostArrayBlockReader(x), jdata.HostArrayBlockReader(x)
    assert ours.block_rows == theirs.block_rows
    assert [b.shape for b in ours.iter_blocks()] == [b.shape for b in theirs.iter_blocks()]


@pytest.mark.parametrize("knob", ["0", "abc"])
def test_fit_block_rows_rejects_what_jax_rejects(knob, monkeypatch):
    monkeypatch.setenv(tdata.FIT_BLOCK_ROWS_ENV, knob)
    for fn in (tdata.fit_block_rows, jdata.fit_block_rows):
        with pytest.raises(ValueError):
            fn()


def test_host_array_block_reader_matches_jax():
    x = _data(103, 4).astype(np.float32)
    ours, theirs = tdata.HostArrayBlockReader(x, block_rows=10), jdata.HostArrayBlockReader(x, 10)
    got, want = list(ours.iter_blocks()), list(theirs.iter_blocks())
    assert len(got) == len(want) == 11
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.float32
    assert list(ours.iter_blocks())[0].base is x  # views, no copy
    for reader in (tdata.HostArrayBlockReader, jdata.HostArrayBlockReader):
        with pytest.raises(ValueError, match="2-D"):
            reader(np.zeros(5))


@pytest.mark.parametrize("packed", [False, True], ids=["columns", "vector column"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_arrow_block_reader_matches_jax(tmp_path, packed, dtype):
    x = _data(250, 5).astype(dtype)
    path = _write_parquet(tmp_path / "x.parquet", x, packed)
    ours = tdata.ArrowBlockReader(path, exclude=["label"], block_rows=64)
    theirs = jdata.ArrowBlockReader(path, exclude=["label"], block_rows=64)
    got, want = list(ours.iter_blocks()), list(theirs.iter_blocks())
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(np.concatenate(got), x)
    assert ours.dtype == theirs.dtype == np.dtype(dtype)
    assert ours.num_rows() == 250
    assert np.array_equal(ours.read_column("label"), theirs.read_column("label"))
    assert tdata.infer_input_dtype(ours) == jdata.infer_input_dtype(theirs) == np.dtype(dtype)
    with pytest.raises(KeyError):
        tdata.ArrowBlockReader(path, columns=["nope"])


def test_infer_input_dtype_reads_a_reader_dtype_as_jax_does():
    for dt in (np.float32, np.float64, np.int64):
        reader = _Reader([], dtype=dt)
        got, want = tdata.infer_input_dtype(reader), jdata.infer_input_dtype(reader)
        assert (got is None and want is None) or np.dtype(got) == np.dtype(want)


# --- core/serving.py --------------------------------------------------------


def test_prefetch_blocks_is_the_plain_loop_one_ahead():
    seen = []

    def prepare(b):
        seen.append(b)
        return b * 10

    before = counter_value("fit.stream.prefetched")
    out = []
    for v in tserving.prefetch_blocks(iter([1, 2, 3, 4]), prepare):
        out.append((v, len(seen)))
    # Block k comes out after block k+1 was prepared (the last one alone).
    assert out == [(10, 2), (20, 3), (30, 4), (40, 4)]
    assert out == [(v, n) for v, n in zip(jserving.prefetch_blocks(iter([1, 2, 3, 4]), lambda b: b * 10),
                                          [2, 3, 4, 4])]
    assert counter_value("fit.stream.prefetched") - before == 3
    assert list(tserving.prefetch_blocks(iter([]), prepare)) == []


# --- ops/covariance.py ------------------------------------------------------


@pytest.mark.parametrize("center", [True, False], ids=["centered", "uncentered"])
@pytest.mark.parametrize("precision", ["highest", "dd"])
def test_streaming_mean_and_covariance_matches_jax(center, precision):
    x = _data(500, 9, 3) + 100.0  # a large offset: the shift earns its keep
    blocks = _blocks(x)
    mean, cov, n = tcov.streaming_mean_and_covariance(iter(blocks), center=center, device=CPU,
                                                      precision=precision)
    jmean, jcov_, jn = jcov.streaming_mean_and_covariance(iter(blocks), center=center)
    assert n == jn == 500
    assert_close("mean", mean, np.asarray(jmean), rtol=1e-10, atol=0)
    assert_close("cov", cov, np.asarray(jcov_), rtol=0, atol=1e-10 * np.abs(jcov_).max())
    if center:
        b = x - x.mean(axis=0)
        assert_close("cov vs numpy", cov, b.T @ b / 499, rtol=0, atol=1e-10 * np.abs(cov).max())


def test_finalize_shifted_gram_matches_jax():
    rng = np.random.default_rng(4)
    shift, s = rng.standard_normal(6), rng.standard_normal(6)
    g = rng.standard_normal((6, 6))
    gram = g @ g.T + 50.0 * np.eye(6)
    for center in (True, False):
        ours = tcov.finalize_shifted_gram(shift, torch.from_numpy(gram), torch.from_numpy(s), 40, center)
        theirs = jcov.finalize_shifted_gram(shift, jnp.asarray(gram), s, 40, center)
        for a, b in zip(ours[:2], theirs[:2]):
            assert_close("finalize", a, np.asarray(b), rtol=1e-10, atol=1e-12)
        assert ours[2] == theirs[2] == 40


def test_shifted_block_scan_needs_two_rows():
    for blocks in ([], [np.zeros((0, 3))], [np.ones((1, 3))]):
        with pytest.raises(ValueError, match="at least 2 rows"):
            tcov.streaming_mean_and_covariance(iter(blocks), device=CPU)
        with pytest.raises(ValueError, match="at least 2 rows"):
            jcov.streaming_mean_and_covariance(iter(blocks))


def test_welford_merge_matches_jax():
    x = _data(90, 4, 5)
    a, b = x[:31], x[31:]

    def stats(mod, blk, dev):
        init = mod.welford_init(4) if dev is None else mod.welford_init(4, device=dev)
        arr = jnp.asarray(blk) if dev is None else torch.from_numpy(blk)
        return mod.welford_add_block(init, arr)

    ours = tcov.welford_merge(stats(tcov, a, CPU), stats(tcov, b, CPU))
    theirs = jcov.welford_merge(stats(jcov, a, None), stats(jcov, b, None))
    for got, want in zip(ours, theirs):
        assert_close("welford_merge", got, np.asarray(want), rtol=1e-12, atol=1e-12)
    assert_close("merged mean", ours[1], x.mean(axis=0), rtol=1e-12, atol=0)


# --- linalg/row_matrix.py ---------------------------------------------------


def test_row_matrix_stream_learns_its_shape_in_the_pass():
    x = _data(80, 6, 6)
    mats = (RowMatrix(lambda: iter(_blocks(x, (20, 50)))), JaxRowMatrix(lambda: iter(_blocks(x, (20, 50)))))
    for mat in mats:
        with pytest.raises(RuntimeError, match="unknown until a fit pass"):
            mat.num_rows
        with pytest.raises(RuntimeError, match="unknown until a fit pass"):
            mat.num_cols
        with pytest.raises(RuntimeError, match="compute_covariance"):
            mat.column_means()
    cov = mats[0].compute_covariance()
    jcov_ = mats[1].compute_covariance()
    assert (mats[0].num_rows, mats[0].num_cols) == (mats[1].num_rows, mats[1].num_cols) == (80, 6)
    assert cov.dtype == torch.float64
    assert_close("cov", cov, np.asarray(jcov_), rtol=0, atol=1e-12)


def test_row_matrix_stream_guards():
    x = _data(30, 4, 7)
    for Mat in (RowMatrix, JaxRowMatrix):
        with pytest.raises(ValueError, match="no streaming path"):
            Mat(lambda: iter([x]), backend="pallas")
    packed = RowMatrix(lambda: iter([x]), use_gemm=False).compute_covariance()
    assert_close("packed stream cov", packed, np.cov(x.T), rtol=0, atol=1e-12)
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    meshed = RowMatrix(lambda: iter([x[:11], x[11:]]), mesh=mesh).compute_covariance()
    assert_close("mesh stream cov", meshed, np.cov(x.T), rtol=0, atol=1e-12)


# --- models/pca.py: streaming fits and transform -----------------------------


def _source(kind: str, x: np.ndarray, tmp_path, pkg):
    blocks = _blocks(x)
    if kind == "generator":
        return iter(blocks)
    if kind == "factory":
        return lambda: iter(blocks)
    if kind == "host reader":
        return pkg.HostArrayBlockReader(x, block_rows=77)
    if kind == "arrow reader":
        path = tmp_path / "x.parquet"
        if not path.exists():
            _write_parquet(path, x, packed=True)
        return pkg.ArrowBlockReader(str(path), exclude=["label"], block_rows=77)
    raise AssertionError(kind)


@pytest.mark.parametrize("center", [True, False], ids=["centered", "uncentered"])
@pytest.mark.parametrize("kind", ["generator", "factory", "host reader", "arrow reader"])
def test_streaming_fit_matches_jax_and_the_oracle(kind, center, tmp_path):
    x = _data(600, 12, 8)
    model = PCA().setK(4).setMeanCentering(center).fit(_source(kind, x, tmp_path, tdata))
    jmodel = JaxPCA().setK(4).setMeanCentering(center).fit(_source(kind, x, tmp_path, jdata))
    assert model.pc.shape == (12, 4)
    assert_close("components", model.pc, jmodel.pc, rtol=0, atol=PC_TOL)
    assert_close("explained variance", model.explainedVariance, jmodel.explainedVariance,
                 rtol=0, atol=EV_TOL)
    if center:
        want_pc, want_ev = numpy_pca_oracle(x, 4)
        assert_close("components vs oracle", model.pc, want_pc, rtol=0, atol=ORACLE_TOL)
        assert_close("variance vs oracle", model.explainedVariance, want_ev, rtol=0, atol=ORACLE_TOL)


@pytest.mark.parametrize("solver", ["auto", "full", "topk"])
@pytest.mark.parametrize("kind", ["generator", "factory"])
def test_streaming_dd_fit_is_native_float64(kind, solver, tmp_path):
    x = _data(400, 10, 9) + 1e3  # a large offset: the shift keeps float64 exact
    model = PCA().setK(3).setPrecision("dd").setEigenSolver(solver).fit(_source(kind, x, tmp_path, tdata))
    jmodel = JaxPCA().setK(3).setPrecision("dd").setEigenSolver(solver).fit(_source(kind, x, tmp_path, jdata))
    want_pc, want_ev = numpy_pca_oracle(x, 3)
    assert_close("dd components vs oracle", model.pc, want_pc, rtol=0, atol=PC_TOL)
    assert_close("dd variance vs oracle", model.explainedVariance, want_ev, rtol=0, atol=EV_TOL)
    assert_close("dd components vs jax", model.pc, jmodel.pc, rtol=0, atol=ORACLE_TOL)
    assert_close("dd variance vs jax", model.explainedVariance, jmodel.explainedVariance,
                 rtol=0, atol=ORACLE_TOL)


def test_streaming_fit_errors_match_jax():
    x = _data(30, 5, 10)
    for Est in (PCA, JaxPCA):
        with pytest.raises(ValueError, match="k must be in"):
            Est().setK(6).fit(lambda: iter([x]))
        with pytest.raises(ValueError, match="at least 2 rows"):
            Est().setK(1).fit(iter([x[:1]]))
        with pytest.raises(ValueError, match="covarianceBackend='pallas'"):
            Est().setK(2).setCovarianceBackend("pallas").fit(lambda: iter([x]))
        with pytest.raises(ValueError, match="covarianceBackend='pallas'"):
            Est().setK(2).setCovarianceBackend("pallas").fit(iter([x]))


def test_streaming_transform_matches_jax(tmp_path):
    x = _data(300, 12, 11)
    model = PCA().setK(4).fit(x)
    jmodel = JaxPCA().setK(4).fit(x)
    blocks = _blocks(x)
    out = model.transform(lambda: iter(blocks))
    assert not isinstance(out, (list, np.ndarray))  # a generator, block by block
    got = list(out)
    want = list(jmodel.transform(lambda: iter(blocks)))
    assert [g.shape for g in got] == [w.shape for w in want] == [(100, 4), (1, 4), (199, 4)]
    for g, w in zip(got, want):
        assert_close("streamed transform", g, w, rtol=0, atol=1e-10)
    reader_out = np.concatenate(list(model.transform(tdata.HostArrayBlockReader(x, 64))))
    assert_close("reader transform", reader_out, np.asarray(jmodel.transform(x)), rtol=0, atol=1e-10)
    assert list(model.transform(iter([np.zeros((0, 12))]))) == []
