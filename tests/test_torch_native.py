"""The port's native host runtime (``native.py``) and the packed PCA route.

``native.py`` builds ``native/src/tpuml_host.cpp`` with g++ into
``build/native_host/`` and binds it with ctypes. Held here:

- ``SprAccumulator`` against numpy float64 (centred and raw, merged,
  1-row blocks, d = 1, empty blocks): 1e-12 relative to the largest entry;
- ``csr_to_dense`` and ``center_scale_f32``: exact against numpy;
- ``NpyBlockReader`` over a ``.npy`` file: exact against ``np.load``;
- three processes that load the library at once leave one loadable
  library, and nothing is written into the reference's package;
- ``PCA().setUseGemm(False)`` on host partitions and streams, by the
  native and the device route, against the JAX package's packed route
  and the numpy oracle: components 1e-8 (sign-aligned), explained
  variance 1e-10 (``dd``: the oracle's bars, and 1e-5 from JAX's
  double-float emulation). The JAX package's own native library is never built
  here: its loader state is set so it takes its XLA packed route;
- KMeans, linear and logistic fits over ``NpyBlockReader`` equal their
  fits over ``HostArrayBlockReader`` of the same blocks, bitwise.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spark_rapids_ml_tpu.native as jnative
from conftest import numpy_pca_oracle
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import native
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.linalg.row_matrix import RowMatrix
from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram_packed
from spark_rapids_ml_tpu_torch.ops.linalg import _triu_indices_packed, triu_to_full
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

REPO = Path(__file__).resolve().parents[1]
PC_TOL = 1e-8
EV_TOL = 1e-10


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture(autouse=True)
def jax_packed_route(monkeypatch):
    """The JAX package's loader must not build its library (a g++ build
    into its package directory): mark it tried and absent, so its packed
    route is the XLA one."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_attempted", True)


@pytest.fixture
def no_native(monkeypatch):
    """The port with its library absent: the device packed route."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", True)


def _rows(n=240, d=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) * np.linspace(4.0, 0.5, d) + rng.uniform(-3, 3, d)


def _close(got, want, tol=1e-12):
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# --- SprAccumulator -------------------------------------------------------------


def test_the_library_builds_into_the_port_build_dir():
    assert native.available(), native.build_error()
    path = native.library_path()
    assert path.is_file() and path.parent.parent == native.BUILD_DIR
    assert native.BUILD_DIR == REPO / "build" / "native_host"
    assert native.build_error() is None
    assert native.get_lib().tpuml_abi_version() == native.ABI_VERSION


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("cuts", [(), (1, 2, 3), (0, 0, 120), (239,)])
def test_spr_accumulator_matches_numpy(center, cuts):
    x = _rows()
    acc = native.SprAccumulator(x.shape[1])
    for blk in np.split(x, list(cuts)):
        acc.add_block(blk)  # empty blocks add nothing
    cov, mean = acc.finalize(center=center)
    want = np.cov(x.T) if center else x.T @ x / (x.shape[0] - 1)
    _close(cov, want)
    _close(mean, x.mean(axis=0))
    assert acc.n_rows == x.shape[0]


def test_spr_merge_of_two_shifts_matches_numpy():
    x = _rows(300, 5, 1)
    a = native.SprAccumulator(5).add_block(x[:100])
    b = native.SprAccumulator(5).add_block(x[100:] + 0.0)
    cov, mean = a.merge(b).finalize()
    _close(cov, np.cov(x.T))
    _close(mean, x.mean(axis=0))
    empty = native.SprAccumulator(5)
    cov_e, _ = empty.merge(native.SprAccumulator(5).add_block(x)).finalize()
    _close(cov_e, np.cov(x.T))


def test_spr_one_column_and_one_row_blocks():
    x = _rows(50, 1, 2)
    acc = native.SprAccumulator(1)
    for r in range(50):
        acc.add_block(x[r:r + 1])
    cov, _ = acc.finalize()
    _close(cov, np.atleast_2d(np.var(x[:, 0], ddof=1)))


def test_spr_refusals():
    with pytest.raises(ValueError, match="1..65535"):
        native.SprAccumulator(65536)
    acc = native.SprAccumulator(3)
    with pytest.raises(ValueError, match=r"\(rows, 3\)"):
        acc.add_block(np.zeros((2, 4)))
    acc.add_block(np.ones((1, 3)))
    with pytest.raises(ValueError, match="at least 2 rows"):
        acc.finalize()


def test_packed_layout_matches_the_reference():
    from spark_rapids_ml_tpu.ops.linalg import _triu_indices_packed as jtriu
    from spark_rapids_ml_tpu.ops.linalg import triu_to_full as jtriu_to_full

    for n in (1, 2, 5, 9):
        np.testing.assert_array_equal(np.stack(_triu_indices_packed(n)), np.stack(jtriu(n)))
    x = _rows(30, 6, 3)
    mean = x.mean(axis=0)
    packed = centered_gram_packed(torch.from_numpy(x), torch.from_numpy(mean))
    assert packed.shape == (21,)
    full = triu_to_full(packed).numpy()
    np.testing.assert_array_equal(full, full.T)
    _close(full, (x - mean).T @ (x - mean))
    np.testing.assert_allclose(full, np.asarray(jtriu_to_full(packed.numpy())), rtol=1e-13)
    with pytest.raises(ValueError, match="not triangular"):
        triu_to_full(torch.zeros(5))


# --- csr_to_dense, center_scale_f32, trace ranges --------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_to_dense_is_exact(dtype):
    m = sp.random(40, 9, density=0.3, format="csr", random_state=4, dtype=np.float64)
    out = native.csr_to_dense(m.indptr, m.indices, m.data, 9, dtype=dtype)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, m.toarray().astype(dtype))


def test_csr_to_dense_refuses_a_bad_column():
    with pytest.raises(ValueError, match="bad column index"):
        native.csr_to_dense([0, 1], [9], [1.0], 3)


def test_center_scale_f32_is_exact():
    x = _rows(33, 4, 5)
    mean = x.mean(axis=0)
    out = native.center_scale_f32(x, mean, 0.25)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ((x - mean) * 0.25).astype(np.float32))


def test_numpy_routes_without_the_library(no_native):
    m = sp.random(10, 5, density=0.4, format="csr", random_state=1)
    np.testing.assert_array_equal(native.csr_to_dense(m.indptr, m.indices, m.data, 5), m.toarray())
    x = _rows(8, 3)
    np.testing.assert_array_equal(native.center_scale_f32(x, x.mean(0), 2.0),
                                  ((x - x.mean(0)) * 2.0).astype(np.float32))
    native.trace_push("nothing")
    native.trace_pop()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.SprAccumulator(3)


def test_trace_ranges_push_and_pop():
    native.trace_push("packed cov")
    native.trace_pop()


# --- NpyBlockReader --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block_rows", [1, 7, 100, 1000])
def test_npy_block_reader_matches_np_load(tmp_path, dtype, block_rows):
    x = _rows(100, 6, 6).astype(dtype)
    path = tmp_path / "x.npy"
    np.save(path, x)
    with native.NpyBlockReader(str(path), block_rows=block_rows) as reader:
        assert reader.shape == (100, 6) and np.dtype(reader.dtype) == dtype
        blocks = list(reader.iter_blocks())
        again = list(reader.iter_blocks())  # re-iterable
        np.testing.assert_array_equal(reader.read_block(13, 5), np.load(path)[13:18])
    assert [b.shape[0] for b in blocks] == [min(block_rows, 100 - i) for i in range(0, 100, block_rows)]
    np.testing.assert_array_equal(np.concatenate(blocks), np.load(path))
    np.testing.assert_array_equal(np.concatenate(again), x)
    assert reader._handle is None  # the context manager closed it


def test_npy_block_reader_refusals(tmp_path):
    bad = tmp_path / "ints.npy"
    np.save(bad, np.arange(10).reshape(5, 2))
    with pytest.raises(ValueError, match="float32/float64"):
        native.NpyBlockReader(str(bad))
    with pytest.raises(ValueError, match="cannot open"):
        native.NpyBlockReader(str(tmp_path / "missing.npy"))
    good = tmp_path / "x.npy"
    np.save(good, np.zeros((4, 2)))
    with pytest.raises(ValueError, match="block_rows"):
        native.NpyBlockReader(str(good), block_rows=0)
    reader = native.NpyBlockReader(str(good))
    reader.close()
    with pytest.raises(ValueError, match="closed"):
        reader.read_block(0, 1)


# --- the build ------------------------------------------------------------------


_LOAD = """
import sys
from pathlib import Path
from spark_rapids_ml_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
lib = native.get_lib()
print(native.library_path() if lib is not None else "FAILED " + str(native.build_error()))
"""


def test_three_processes_build_one_library(tmp_path):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin:/usr/local/bin"}
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1, paths
    built = [p for p in tmp_path.rglob("*") if p.is_file() and p.name != ".lock"]
    assert [p.name for p in built] == [native.LIB_NAME]
    assert ctypes.CDLL(str(built[0])).tpuml_abi_version() == 1
    assert not list((REPO / "spark_rapids_ml_tpu" / "native").glob("*.so.*.tmp"))


def test_a_failed_build_is_reported(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", "")
    assert native.get_lib() is None and not native.available()
    assert "g++ was not found" in native.build_error()
    with pytest.raises(RuntimeError, match="g\\+\\+ was not found"):
        native.NpyBlockReader("x.npy")


# --- the packed PCA route ---------------------------------------------------------


def _aligned_err(pc, want):
    pc, want = np.asarray(pc), np.asarray(want)
    signs = np.where(np.sum(pc * want, axis=0) < 0, -1.0, 1.0)
    return float(np.abs(pc * signs - want).max())


def _hold(model, ref, oracle):
    for want_pc, want_ev in ((ref.pc, ref.explainedVariance), oracle):
        assert _aligned_err(model.pc, want_pc) <= PC_TOL
        np.testing.assert_allclose(model.explainedVariance, want_ev, rtol=0, atol=EV_TOL)


def _raw_oracle(x, k):
    """The uncentred twin of the oracle: eigenpairs of xᵀx / (n − 1)."""
    v, w, _ = np.linalg.svd(x.T @ x / (x.shape[0] - 1))
    w = np.clip(w, 0, None)
    return v[:, :k], (w / w.sum())[:k]


def _source(kind, x, tmp_path):
    parts = [x[:90], x[90:91], x[91:]]
    if kind == "partitions":
        return parts, parts
    if kind == "iterator":
        return iter(parts), iter(parts)
    if kind == "factory":
        return (lambda: iter(parts)), (lambda: iter(parts))
    path = tmp_path / "x.npy"
    np.save(path, x)
    return native.NpyBlockReader(str(path), block_rows=64), _JaxNpy(x, 64)


class _JaxNpy:
    """The same blocks as a block reader for the JAX package (whose own
    NpyBlockReader would need its native library)."""

    def __init__(self, x, rows):
        self.x, self.rows, self.dtype = x, rows, x.dtype

    def iter_blocks(self):
        for i in range(0, self.x.shape[0], self.rows):
            yield self.x[i:i + self.rows]


@pytest.mark.parametrize("route", ["native", "device"])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("kind", ["partitions", "iterator", "factory", "npy"])
def test_packed_pca_matches_jax_and_the_oracle(request, route, center, kind, tmp_path):
    x = _rows(240, 7, 8)
    ours, theirs = _source(kind, x, tmp_path)  # an open reader keeps its library
    if route == "device":
        request.getfixturevalue("no_native")
    counter = f"pca.packed.{route}"
    before = counter_value(counter)
    model = PCA().setK(3).setUseGemm(False).setMeanCentering(center).fit(ours)
    assert counter_value(counter) == before + 1
    ref = JaxPCA().setK(3).setUseGemm(False).setMeanCentering(center).fit(theirs)
    _hold(model, ref, numpy_pca_oracle(x, 3) if center else _raw_oracle(x, 3))


@pytest.mark.parametrize("route", ["native", "device"])
def test_packed_pca_dd(request, route):
    if route == "device":
        request.getfixturevalue("no_native")
    x = _rows(200, 6, 9)
    parts = [x[:70], x[70:]]
    model = PCA().setK(2).setUseGemm(False).setPrecision("dd").fit(parts)
    ref = JaxPCA().setK(2).setUseGemm(False).setPrecision("dd").fit(parts)
    oracle = numpy_pca_oracle(x, 2)
    assert _aligned_err(model.pc, oracle[0]) <= PC_TOL
    np.testing.assert_allclose(model.explainedVariance, oracle[1], rtol=0, atol=EV_TOL)
    # dd is native float64 in the port and the double-float emulation in JAX
    # (without its library): held to each other at the emulation's 1e-5.
    assert _aligned_err(model.pc, ref.pc) <= 1e-5
    np.testing.assert_allclose(model.explainedVariance, ref.explainedVariance, rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", ["native", "device"])
def test_packed_route_refusals_match_jax(request, route):
    if route == "device":
        request.getfixturevalue("no_native")
    x = _rows(30, 5, 10)
    for cls in (PCA, JaxPCA):
        with pytest.raises(ValueError, match="useGemm=True"):
            cls().setK(2).setCovarianceBackend("pallas").setUseGemm(False).fit(x)
    with pytest.raises(ValueError, match="consumes host"):
        RowMatrix(torch.from_numpy(x), use_gemm=False)
    wide = np.zeros((3, 65536))
    wide[1, 0] = 1.0
    msgs = []
    for cls in (PCA, JaxPCA):
        with pytest.raises(ValueError, match="caps features at 65535") as err:
            cls().setK(1).setSolver("covariance").setUseGemm(False).fit(wide)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    if route == "native":
        with pytest.raises(ValueError, match="caps features at 65535"):
            PCA().setK(1).setSolver("covariance").setUseGemm(False).fit(lambda: iter([wide]))


# --- streams over NpyBlockReader ------------------------------------------------


def _npy(tmp_path, x, rows):
    path = tmp_path / "x.npy"
    np.save(path, x)
    return native.NpyBlockReader(str(path), block_rows=rows), HostArrayBlockReader(x, block_rows=rows)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kmeans_over_npy_equals_the_host_reader(tmp_path, dtype):
    x = _rows(300, 4, 11).astype(dtype)
    npy, host = _npy(tmp_path, x, 64)
    a = KMeans().setK(3).setSeed(2).fit(npy)
    b = KMeans().setK(3).setSeed(2).fit(host)
    np.testing.assert_array_equal(a.clusterCenters(), b.clusterCenters())
    assert a.trainingCost == b.trainingCost and a.numIter == b.numIter


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linear_over_npy_equals_the_host_reader(tmp_path, dtype):
    x = _rows(300, 4, 12).astype(dtype)
    y = x @ np.arange(1.0, 5.0) + 0.1
    npy, host = _npy(tmp_path, x, 50)
    a = LinearRegression().setRegParam(0.1).fit((npy, y))
    b = LinearRegression().setRegParam(0.1).fit((host, y))
    np.testing.assert_array_equal(a.coefficients, b.coefficients)
    assert a.intercept == b.intercept


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_logistic_over_npy_equals_the_host_reader(tmp_path, dtype):
    x = _rows(300, 4, 13).astype(dtype)
    y = (x[:, 0] - x[:, 1] > 0).astype(np.float64)
    npy, host = _npy(tmp_path, x, 80)
    a = LogisticRegression().setRegParam(0.01).setMaxIter(10).fit((npy, y))
    b = LogisticRegression().setRegParam(0.01).setMaxIter(10).fit((host, y))
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(a.intercepts, b.intercepts)
    assert a.numIter == b.numIter
