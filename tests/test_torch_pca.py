"""The port's PCA slice end to end, against the JAX package and the oracle.

``PCA().fit`` → ``RowMatrix`` → covariance (plain torch, or kernel K1's
CPU route under ``covarianceBackend="pallas"``) → eigensolve → explained
variance, then ``PCAModel.transform``. Inputs are numpy from a seed and go
through both packages; the JAX side runs as its own tests run it (x64 on
the CPU, the Pallas kernel in interpret mode). Tolerances:

- the reference 3×5 dataset against ``numpy_pca_oracle``: absTol 1e-5,
  the reference suite's bar (PCASuite.scala:71);
- random data against the JAX fit: components 1e-8 elementwise (both
  sign-flipped the same way), explained variance 1e-10;
- transforms against the JAX transform: 1e-10 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import numpy_pca_oracle
from spark_rapids_ml_tpu.core.data import DataFrame as JaxDataFrame
from spark_rapids_ml_tpu.core.data import Vectors as JaxVectors
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.feature import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.core import persistence
from spark_rapids_ml_tpu_torch.core.data import DataFrame, Vectors
from spark_rapids_ml_tpu_torch.feature import PCA, PCAModel
from spark_rapids_ml_tpu_torch.interop import pca_model_from_numpy
from spark_rapids_ml_tpu_torch.linalg.row_matrix import RowMatrix
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1
from spark_rapids_ml_tpu_torch.utils.testing import assert_close, seeded_matrix

ABS_TOL = 1e-5
PC_TOL = 1e-8
EV_TOL = 1e-10


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _data(n: int = 600, d: int = 12, seed: int = 0) -> np.ndarray:
    return seeded_matrix(n, d, seed, scales=np.linspace(3.0, 0.3, d), offset=1.5)


def _configure(est, **params):
    for name, value in params.items():
        est.set(est.getParam(name), value)
    return est


def test_reference_dataset_matches_oracle_and_jax():
    """The 3×5 dataset of PCASuite.scala:42-46 (conftest.py REFERENCE_DATA).
    With 3 centered rows the covariance has rank 2: the informative
    components are held to the oracle, the null-space one structurally."""
    rows = [Vectors.sparse(5, [], []), Vectors.sparse(5, [1, 3], [1.0, 7.0]),
            Vectors.dense(2.0, 0.0, 3.0, 4.0, 5.0)]
    jrows = [JaxVectors.sparse(5, [], []), JaxVectors.sparse(5, [1, 3], [1.0, 7.0]),
             JaxVectors.dense(2.0, 0.0, 3.0, 4.0, 5.0)]
    x = np.stack([r.toArray() for r in rows])
    for solver in ("full", "auto"):
        model = (PCA().setK(3).setInputCol("features").setOutputCol("out")
                 .setEigenSolver(solver).fit(DataFrame({"features": rows})))
        jmodel = (JaxPCA().setK(3).setInputCol("features").setOutputCol("out")
                  .setEigenSolver(solver).fit(JaxDataFrame({"features": jrows})))
        want_pc, want_ev = numpy_pca_oracle(x, 3)
        assert_close("pc vs oracle", model.pc[:, :2], want_pc[:, :2], rtol=0, atol=ABS_TOL)
        assert_close("ev vs oracle", model.explainedVariance, want_ev, rtol=0, atol=ABS_TOL)
        assert_close("pc vs jax", model.pc[:, :2], jmodel.pc[:, :2], rtol=0, atol=PC_TOL)
        assert_close("ev vs jax", model.explainedVariance, jmodel.explainedVariance, rtol=0, atol=EV_TOL)
        b = x - x.mean(axis=0)
        assert_close("null-space component", b @ model.pc[:, 2], np.zeros(3), rtol=0, atol=ABS_TOL)
        assert_close("orthonormal", model.pc.T @ model.pc, np.eye(3), rtol=0, atol=ABS_TOL)


@pytest.mark.parametrize("center", [True, False], ids=["centered", "uncentered"])
@pytest.mark.parametrize("solver", ["full", "auto", "topk"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("container", ["partitions", "tensor"])
def test_fit_matches_jax(container, backend, solver, center):
    x = _data()
    params = dict(k=4, covarianceBackend=backend, eigenSolver=solver, meanCentering=center)
    if container == "partitions":
        ours, theirs = [np.ascontiguousarray(p) for p in np.array_split(x, 3)], np.array_split(x, 3)
    else:
        ours, theirs = torch.from_numpy(x), jnp.asarray(x)
    k1.reset_launches()
    model = _configure(PCA(), **params).fit(ours)
    jmodel = _configure(JaxPCA(), **params).fit(theirs)
    assert k1.launches == 0  # the CPU route never launches the kernel
    assert model.pc.shape == (12, 4)
    assert_close("components", model.pc, jmodel.pc, rtol=0, atol=PC_TOL)
    assert_close("explained variance", model.explainedVariance, jmodel.explainedVariance,
                 rtol=0, atol=EV_TOL)


def _degenerate(case: str) -> np.ndarray:
    if case == "ones":
        return np.ones((20, 5))
    x = _data(40, 6, 8)
    x[:, 2] = -1.25
    return x


@pytest.mark.parametrize("solver", ["auto", "full"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", ["ones", "constant column"])
def test_fit_on_a_zero_covariance_direction_matches_jax(case, backend, solver):
    """Constant data has a zero covariance: the default solver's CholeskyQR
    fails as in the reference, which promotes to the full solve; both
    packages give explained variance [0, 0]."""
    x = _degenerate(case)
    params = dict(k=2, covarianceBackend=backend, eigenSolver=solver)
    model = _configure(PCA(), **params).fit(torch.from_numpy(x))
    jmodel = _configure(JaxPCA(), **params).fit(jnp.asarray(x))
    assert_close("explained variance", model.explainedVariance, jmodel.explainedVariance,
                 rtol=0, atol=EV_TOL)
    assert_close("components", model.pc, jmodel.pc, rtol=0, atol=PC_TOL)
    if case == "ones":
        assert np.array_equal(model.explainedVariance, [0.0, 0.0])
    else:
        assert_close("constant column", model.pc[2], np.zeros(2), rtol=0, atol=ABS_TOL)


@pytest.mark.parametrize("solver", ["auto", "full"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fit_on_nan_data_gives_nan_as_jax_does(backend, solver):
    x = _data(30, 5, 9)
    x[4, 3] = np.nan
    params = dict(k=2, covarianceBackend=backend, eigenSolver=solver)
    model = _configure(PCA(), **params).fit(torch.from_numpy(x))
    jmodel = _configure(JaxPCA(), **params).fit(jnp.asarray(x))
    for name in ("pc", "explainedVariance"):
        assert np.all(np.isnan(getattr(jmodel, name))), f"reference {name} is not NaN"
        assert np.all(np.isnan(getattr(model, name))), f"{name} is not NaN"


def test_fit_on_a_tensor_stays_on_its_device_until_read():
    x = torch.from_numpy(_data())
    model = PCA().setK(3).fit(x)
    assert isinstance(model._pc_raw, torch.Tensor) and model._pc_np is None
    assert model.pc.dtype == np.float64 and model._pc_np is not None


def test_float32_tensor_computes_in_float32():
    x = _data().astype(np.float32)
    for backend in ("xla", "pallas"):
        model = PCA().setK(3).setCovarianceBackend(backend).fit(torch.from_numpy(x))
        assert model._pc_raw.dtype == torch.float32
        jmodel = JaxPCA().setK(3).setCovarianceBackend(backend).fit(jnp.asarray(x))
        assert_close(f"f32 components ({backend})", model.pc, jmodel.pc, rtol=0, atol=1e-4)


def test_host_svd_route_matches_jax():
    x = _data()
    model = PCA().setK(4).setUseCuSolverSVD(False).fit(list(np.array_split(x, 2)))
    jmodel = JaxPCA().setK(4).setUseCuSolverSVD(False).fit(list(np.array_split(x, 2)))
    assert_close("host SVD components", model.pc, jmodel.pc, rtol=0, atol=PC_TOL)
    assert_close("host SVD variance", model.explainedVariance, jmodel.explainedVariance,
                 rtol=0, atol=EV_TOL)


def test_transform_matches_jax_for_every_container():
    x = _data(200, 12, 3)
    model = PCA().setK(4).setInputCol("features").setOutputCol("proj").fit(DataFrame({"features": list(x)}))
    jmodel = JaxPCA().setK(4).setInputCol("features").setOutputCol("proj").fit(
        JaxDataFrame({"features": list(x)}))
    want = np.asarray(jmodel.transform(x))
    out_df = model.transform(DataFrame({"features": list(x)}))
    assert_close("DataFrame transform", np.stack(out_df.select("proj")), want, rtol=0, atol=1e-10)
    assert_close("ndarray transform", model.transform(x), want, rtol=0, atol=1e-10)
    assert_close("partitioned transform", model.transform(list(np.array_split(x, 3))), want,
                 rtol=0, atol=1e-10)
    tensor_model = PCA().setK(4).fit(x)
    got_t = tensor_model.transform(torch.from_numpy(x))
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float64
    want_t = np.asarray(JaxPCA().setK(4).fit(x).transform(jnp.asarray(x)))
    assert_close("tensor transform", got_t, want_t, rtol=0, atol=1e-10)
    assert_close("one-row tensor transform", tensor_model.transform(torch.from_numpy(x[0])),
                 want_t[:1], rtol=0, atol=1e-10)
    empty = model.transform([np.zeros((0, 12))])
    assert empty.shape == (0, 4)


def test_k_and_row_count_errors():
    x = _data(20, 5, 4)
    with pytest.raises((TypeError, ValueError)):
        PCA().setK(0)
    for data in (x, torch.from_numpy(x)):
        for backend in ("xla", "pallas"):
            with pytest.raises(ValueError, match="k must be in"):
                PCA().setK(6).setCovarianceBackend(backend).fit(data)
    for data in (x[:1], torch.from_numpy(x[:1])):
        for backend in ("xla", "pallas"):
            with pytest.raises(ValueError, match="at least 2 rows"):
                PCA().setK(2).setCovarianceBackend(backend).fit(data)
    with pytest.raises(ValueError, match="2-D"):
        PCA().setK(1).fit(torch.zeros(5))


def test_routes_of_later_slices_raise_not_implemented():
    """The randomized, wide ``auto`` and streaming routes arrived with the
    streaming/sketch slice and ``useGemm=False`` with the packed route, and
    now fit; a mesh still raises, naming its item."""
    x = _data(30, 6, 5)
    assert PCA().setK(2).setSolver("randomized").fit(x).pc.shape == (6, 2)
    wide = np.random.default_rng(5).standard_normal((12, 4096))
    assert PCA().setK(2).fit(wide).pc.shape == (4096, 2)
    assert PCA().setK(2).fit(iter([x[:10], x[10:]])).pc.shape == (6, 2)
    assert PCA().setK(2).fit(lambda: iter([x])).pc.shape == (6, 2)
    assert PCA().setK(2).setUseGemm(False).fit(x).pc.shape == (6, 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        PCA(mesh=object()).setK(2).fit(x)
    out = list(PCA().setK(2).fit(x).transform(iter([x])))
    assert len(out) == 1 and out[0].shape == (30, 2)


def test_reference_guards_are_kept():
    x = _data(30, 6, 6)
    with pytest.raises(ValueError, match="useGemm=True"):
        PCA().setK(2).setCovarianceBackend("pallas").setUseGemm(False).fit(x)
    with pytest.raises(ValueError, match="own kernels"):
        PCA().setK(2).setCovarianceBackend("pallas").setPrecision("dd").fit(x)
    with pytest.raises(ValueError, match="dd"):
        PCA().setK(2).setPrecision("dd").fit(torch.from_numpy(x))
    with pytest.raises(ValueError, match="covarianceBackend"):
        PCA().setCovarianceBackend("mosaic")
    with pytest.raises(ValueError, match="precision"):
        PCA().setPrecision("tf32")


def test_float64_precision_requests_resolve_to_native_float64():
    x = _data()
    assert RowMatrix.resolve("auto", input_dtype=np.float64) == "highest"
    assert RowMatrix.resolve("auto", input_dtype=np.float64, backend="pallas") == "highest"
    parts = np.array_split(x, 2)
    want_pc, want_ev = numpy_pca_oracle(x, 4)
    for solver in ("auto", "full", "topk"):
        dd = PCA().setK(4).setPrecision("dd").setEigenSolver(solver).fit(parts)
        jdd = JaxPCA().setK(4).setPrecision("dd").setEigenSolver(solver).fit(parts)
        # Native float64 meets the float64 oracle to rounding; the JAX
        # package's double-float emulation is held to the oracle's 1e-5.
        assert_close(f"dd components vs oracle ({solver})", dd.pc, want_pc, rtol=0, atol=PC_TOL)
        assert_close(f"dd variance vs oracle ({solver})", dd.explainedVariance, want_ev,
                     rtol=0, atol=EV_TOL)
        assert_close(f"dd components vs jax dd ({solver})", dd.pc, jdd.pc, rtol=0, atol=ABS_TOL)
        assert_close(f"dd variance vs jax dd ({solver})", dd.explainedVariance,
                     jdd.explainedVariance, rtol=0, atol=ABS_TOL)


def test_backend_aliases_store_the_reference_spelling():
    assert PCA().setCovarianceBackend("cuda").getCovarianceBackend() == "pallas"
    assert PCA().setCovarianceBackend("torch").getCovarianceBackend() == "xla"
    # The estimator-only deployMode (gang fits) waits for the distribution slice.
    assert {p.name for p in PCA().params} == {p.name for p in JaxPCA().params} - {"deployMode"}
    assert {p.name for p in PCAModel().params} == {p.name for p in JaxPCAModel().params}


def test_pca_model_from_numpy_matches_the_jax_model():
    x = _data(150, 12, 7)
    jmodel = JaxPCA().setK(3).setInputCol("features").setOutputCol("proj").fit(
        JaxDataFrame({"features": list(x)}))
    params = {p.name: v for p, v in jmodel.extractParamMap().items()}
    model = pca_model_from_numpy(jmodel.pc, jmodel.explainedVariance, uid=jmodel.uid, params=params)
    assert model.uid == jmodel.uid and model.getK() == 3 and model.getOutputCol() == "proj"
    assert np.array_equal(model.pc, jmodel.pc)
    want = np.stack(jmodel.transform(JaxDataFrame({"features": list(x)})).select("proj"))
    got = np.stack(model.transform(DataFrame({"features": list(x)})).select("proj"))
    assert_close("interop transform", got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="explained_variance"):
        pca_model_from_numpy(jmodel.pc, jmodel.explainedVariance[:2])


def test_models_saved_by_either_package_load_in_the_other(tmp_path):
    x = _data(120, 8, 8)
    jmodel = JaxPCA().setK(3).setInputCol("f").setCovarianceBackend("pallas").fit(x)
    jmodel.write.overwrite().save(str(tmp_path / "from_jax"))
    model = PCAModel.load(str(tmp_path / "from_jax"))
    assert model.uid == jmodel.uid and model.getInputCol() == "f"
    assert model.getCovarianceBackend() == "pallas"
    assert np.array_equal(model.pc, jmodel.pc)
    assert np.array_equal(model.explainedVariance, jmodel.explainedVariance)

    ours = PCA().setK(3).setOutputCol("o").fit(torch.from_numpy(x))
    ours.write.overwrite().save(str(tmp_path / "from_torch"))
    back = JaxPCAModel.load(str(tmp_path / "from_torch"))
    assert back.uid == ours.uid and back.getK() == 3 and back.getOutputCol() == "o"
    assert np.array_equal(back.pc, ours.pc)
    assert_close("loaded transform", np.asarray(back.transform(x)), ours.transform(x), rtol=0, atol=1e-12)


def test_save_without_pyarrow_round_trips_through_npz(tmp_path, monkeypatch):
    monkeypatch.setattr(persistence, "_HAS_ARROW", False)
    model = PCA().setK(2).fit(_data(40, 5, 9))
    model.write.overwrite().save(str(tmp_path / "m"))
    assert (tmp_path / "m" / "data" / "part-00000.npz").exists()
    loaded = PCAModel.load(str(tmp_path / "m"))
    assert np.array_equal(loaded.pc, model.pc) and loaded.getK() == 2
    with pytest.raises(FileExistsError):
        model.write.save(str(tmp_path / "m"))


def test_model_copy_and_pickle_keep_fitted_state():
    cloudpickle = pytest.importorskip("cloudpickle")  # the params hold lambdas, as the reference's do

    model = PCA().setK(2).setOutputCol("o").fit(torch.from_numpy(_data(40, 5, 10)))
    model.transform(torch.from_numpy(_data(3, 5, 11)))  # fills the device cache
    clone = model.copy()
    assert clone.getOutputCol() == "o" and np.array_equal(clone.pc, model.pc)
    revived = cloudpickle.loads(cloudpickle.dumps(model))
    assert isinstance(revived._pc_raw, np.ndarray) and revived._pc_dev_cache == {}
    assert np.array_equal(revived.pc, model.pc)
