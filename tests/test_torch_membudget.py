"""The port's fit memory guard (``core/membudget.py`` and its callers)
against the JAX package's.

- Pricing: ``padded_input_bytes`` and ``core/data.host_rows_shape`` equal
  the reference's (less its mesh terms), exactly.
- Admission, for all five families under ``TPUML_FIT_MEM_BUDGET``: the
  admit / degrade / reject decision, the ``fit.admission.*`` and
  ``degrade.events`` counters, the ``FitMemoryError`` text and the
  ``TPUML_FIT_DEGRADE=off`` switch equal the reference's on the same
  input. The JAX package prices KMeans in float32 here, as it does where
  x64 is off and as the port places KMeans rows; the other families price
  float64 in both.
- Degraded fits equal the JAX package's degraded fits at each family's
  streaming tolerance (PCA 1e-8 components and 1e-10 ratios; KMeans, which
  streams in float32 in the port, 1e-4; linear 1e-10; logistic 1e-10 with
  equal ``numIter``), and equal the port's explicit
  ``HostArrayBlockReader`` fits bit for bit.
- Recovery: an injected ``torch.OutOfMemoryError`` in the in-memory fit
  is recovered through the streaming route, equal to the degraded fit;
  repeated OOMs halve the block rows as the reference does, then raise;
  the failed attempt's tensors are gone when the fallback starts; other
  errors propagate untouched; ``Estimator.fit`` turns an escaped OOM into
  ``FitMemoryError``.
"""

import gc
import json
import warnings
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.core import data as jdata
from spark_rapids_ml_tpu.core import ingest as jingest
from spark_rapids_ml_tpu.core import membudget as jmb
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.manifold import UMAP as JaxUMAP
from spark_rapids_ml_tpu.models import umap as jumap_model
from spark_rapids_ml_tpu.observability import events as jevents
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinR
from spark_rapids_ml_tpu.robustness import degrade as jdegrade
from spark_rapids_ml_tpu.robustness import retry as jretry
from spark_rapids_ml_tpu.utils import tracing as jtracing
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.core import data as tdata
from spark_rapids_ml_tpu_torch.core import membudget as tmb
from spark_rapids_ml_tpu_torch.core import serving as tserving
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.manifold import UMAP
from spark_rapids_ml_tpu_torch.models import umap as tumap_model
from spark_rapids_ml_tpu_torch.observability import events as tevents
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.robustness import retry as tretry
from spark_rapids_ml_tpu_torch.robustness.degrade import DegradationWarning
from spark_rapids_ml_tpu_torch.utils import tracing as ttracing

COUNTERS = ("fit.admission.admitted", "fit.admission.degraded", "fit.admission.rejected",
            "fit.admission.declared", "degrade.events")


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for name in ("TPUML_FIT_MEM_BUDGET", "TPUML_FIT_DEGRADE", "TPUML_FIT_OOM_RETRIES",
                 "TPUML_FIT_BLOCK_ROWS", "TPUML_AUTOTUNE", "TPUML_EVENT_LOG"):
        monkeypatch.delenv(name, raising=False)
    # The reference reclaims by clearing jax's caches, which would make every
    # later test in this process compile again.
    monkeypatch.setattr(jmb, "_reclaim", lambda: None)


def _rows(n=160, d=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) * np.linspace(3.0, 0.5, d) + rng.uniform(-2, 2, d)


X = _rows()
Y_LIN = X @ np.linspace(1.0, 2.0, X.shape[1]) + 0.3
Y_LOG = ((X - X.mean(0)) / X.std(0) @ np.array([1.0, -1.0, 0.5, 0.0, 0.2]) > 0).astype(np.float64)


def _counts(tracing) -> dict:
    return {n: tracing.counter_value(n) for n in COUNTERS}


def _deltas(tracing, before) -> dict:
    return {k: tracing.counter_value(k) - v for k, v in before.items()}


# --- pricing --------------------------------------------------------------------


@pytest.mark.parametrize("n,d,dtype", [(1, 1, np.float32), (160, 5, np.float64), (1000, 3, np.float16),
                                       (7, 9, torch.float32), (7, 9, torch.float64)])
def test_padded_input_bytes_matches_the_reference(n, d, dtype):
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}.get(dtype, dtype)
    assert tmb.padded_input_bytes(n, d, dtype) == jmb.padded_input_bytes(n, d, np_dtype)


def _vectors(pkg):
    return [pkg.Vectors.dense([1.0, 2.0, 3.0]), pkg.Vectors.sparse(3, [0, 2], [1.0, 5.0])]


SHAPES = {
    "array_2d": lambda pkg: np.zeros((6, 4)),
    "array_1d": lambda pkg: np.zeros(4),
    "array_3d": lambda pkg: np.zeros((2, 3, 4)),
    "blocks": lambda pkg: [np.zeros((3, 4)), np.zeros((5, 4))],
    "blocks_and_rows": lambda pkg: [np.zeros((3, 4)), [1.0, 2.0, 3.0, 4.0]],
    "sparse": lambda pkg: sp.random(9, 6, density=0.3, format="csr", random_state=0),
    "sparse_blocks": lambda pkg: [sp.eye(3, 6, format="csr"), sp.eye(2, 6, format="csr")],
    "row_lists": lambda pkg: [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]],
    "vectors": lambda pkg: _vectors(pkg),
    "one_vector": lambda pkg: pkg.Vectors.sparse(5, [1], [2.0]),
    "empty_list": lambda pkg: [],
    "tensor": lambda pkg: torch.zeros((6, 4)) if pkg is tdata else jnp.zeros((6, 4)),
    "dataframe": lambda pkg: pkg.DataFrame({"features": [[1.0, 2.0]]}),
}


@pytest.mark.parametrize("kind", list(SHAPES))
def test_host_rows_shape_matches_the_reference(kind):
    assert tdata.host_rows_shape(SHAPES[kind](tdata)) == jdata.host_rows_shape(SHAPES[kind](jdata))


# --- admission decisions against the reference ------------------------------------


class _InMemory(Exception):
    """Raised in place of the in-memory fit: the guard admitted the input."""


def _streamed(log):
    def fake(family, fit_with_reader, matrix, **kw):
        log.append((family, np.array(matrix)))
        return "streamed"
    return fake


def _weighted(pkg, y):
    """A named-column frame with a weight column, in ``pkg``'s shim."""
    return pkg.DataFrame({"features": list(X), "label": list(y), "w": list(np.linspace(0.5, 2.0, len(y)))})


FAMILIES = {
    # name: (port estimator, JAX estimator, data, or data(package) for a frame)
    "pca": (lambda: PCA().setK(2), lambda: JaxPCA().setK(2), X),
    "pca_pallas": (lambda: PCA().setK(2).setCovarianceBackend("pallas"),
                   lambda: JaxPCA().setK(2).setCovarianceBackend("pallas"), X),
    "kmeans": (lambda: KMeans().setK(3).setSeed(1).setBackend("xla"),
               lambda: JaxKMeans().setK(3).setSeed(1).setBackend("xla"), X),
    "kmeans_fused": (lambda: KMeans().setK(3).setBackend("fused"), lambda: JaxKMeans().setK(3).setBackend("fused"), X),
    "linear": (lambda: LinearRegression().setRegParam(0.1), lambda: JaxLinR().setRegParam(0.1), (X, Y_LIN)),
    "logistic": (lambda: LogisticRegression().setMaxIter(5), lambda: JaxLR().setMaxIter(5), (X, Y_LOG)),
    "logistic_enet": (lambda: LogisticRegression().setRegParam(0.1).setElasticNetParam(0.5),
                      lambda: JaxLR().setRegParam(0.1).setElasticNetParam(0.5), (X, Y_LOG)),
    "umap": (lambda: UMAP().setNNeighbors(5), lambda: JaxUMAP().setNNeighbors(5), X.astype(np.float32)),
    "kmeans_weighted": (lambda: KMeans().setK(3).setWeightCol("w"), lambda: JaxKMeans().setK(3).setWeightCol("w"),
                        lambda pkg: _weighted(pkg, Y_LIN)),
    "linear_weighted": (lambda: LinearRegression().setWeightCol("w"), lambda: JaxLinR().setWeightCol("w"),
                        lambda pkg: _weighted(pkg, Y_LIN)),
    "logistic_weighted": (lambda: LogisticRegression().setWeightCol("w"), lambda: JaxLR().setWeightCol("w"),
                          lambda pkg: _weighted(pkg, Y_LOG)),
}
CAN_STREAM = {"pca", "kmeans", "linear", "logistic"}


def _needed(name) -> int:
    itemsize = 4 if name.startswith(("kmeans", "umap")) else 8
    return tmb.padded_input_bytes(X.shape[0], X.shape[1], np.float32 if itemsize == 4 else np.float64)


def _hook(monkeypatch, name):
    """Replace what follows admission by sentinels in both packages: the
    in-memory fit raises _InMemory, the streaming reroute records its
    matrix."""
    def raise_in_memory(*a, **k):
        raise _InMemory

    for cls in (PCA, KMeans, LinearRegression, LogisticRegression,
                JaxPCA, JaxKMeans, JaxLinR, JaxLR):
        monkeypatch.setattr(cls, "_fit_in_memory", raise_in_memory)
    monkeypatch.setattr(tumap_model, "matrix_like", raise_in_memory)
    monkeypatch.setattr(jumap_model, "matrix_like", raise_in_memory)
    logs = ([], [])
    monkeypatch.setattr(tmb, "run_streaming_with_recovery", _streamed(logs[0]))
    monkeypatch.setattr(jmb, "run_streaming_with_recovery", _streamed(logs[1]))
    # The reference prices KMeans at its default dtype: float32 where x64 is
    # off, which is what the port places.
    if name.startswith("kmeans"):
        monkeypatch.setattr(jingest, "default_dtype", lambda: jnp.float32)
    return logs


def _run(fit, tracing):
    before = _counts(tracing)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            outcome = ("result", fit())
        except _InMemory:
            outcome = ("in_memory",)
        except RuntimeError as exc:  # FitMemoryError in either package
            outcome = (type(exc).__name__, str(exc))
    warned = [(w.message.what, w.message.why, w.message.fallback) for w in caught
              if type(w.message).__name__ == "DegradationWarning"]
    return outcome, _deltas(tracing, before), warned


DECISIONS = [(name, d) for name in FAMILIES for d in ("admit", "over", "over_degrade_off")
             if not (d == "over_degrade_off" and name not in CAN_STREAM)]


@pytest.mark.parametrize("name,decision", DECISIONS)
def test_admission_matches_the_reference(monkeypatch, name, decision):
    port_est, jax_est, data = FAMILIES[name]
    logs = _hook(monkeypatch, name)
    budget = _needed(name) - (0 if decision == "admit" else 1)
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", str(budget))
    if decision == "over_degrade_off":
        monkeypatch.setenv("TPUML_FIT_DEGRADE", "off")
    ours = _run(lambda: port_est().fit(data(tdata) if callable(data) else data), ttracing)
    theirs = _run(lambda: jax_est().fit(data(jdata) if callable(data) else data), jtracing)
    assert ours == theirs
    expect = {"admit": "admitted", "over": "degraded" if name in CAN_STREAM else "rejected",
              "over_degrade_off": "rejected"}[decision]
    assert ours[1][f"fit.admission.{expect}"] == 1
    assert len(logs[0]) == len(logs[1]) == (1 if expect == "degraded" else 0)
    for (fam_a, mat_a), (fam_b, mat_b) in zip(*logs):
        assert fam_a == fam_b and mat_a.dtype == mat_b.dtype
        np.testing.assert_array_equal(mat_a, mat_b)


@pytest.mark.parametrize("source", ["stream", "cpu_tensor"])
def test_what_the_guard_waves_through(monkeypatch, source):
    """A stream is not priced, and a tensor computes where it lives: a CPU
    tensor is never copied to the card, so nothing is left to admit."""
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1")
    data = (lambda: iter([X])) if source == "stream" else torch.from_numpy(X)
    before = _counts(ttracing)
    model = PCA().setK(2).fit(data)
    assert model.pc.shape == (5, 2)
    assert _deltas(ttracing, before) == dict.fromkeys(COUNTERS, 0)


def test_no_budget_on_the_cpu_means_no_gate():
    assert tmb.free_hbm_bytes() is None and tmb.fit_mem_budget() == 0
    before = _counts(ttracing)
    PCA().setK(2).fit(X)
    assert _deltas(ttracing, before) == dict.fromkeys(COUNTERS, 0)


def test_free_memory_is_what_the_allocator_can_hand_out(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1000, 8000))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 300 if dev.index == 1 else 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 100 if dev.index == 1 else 0)
    port_device.set_platform("cuda")
    assert tmb.free_hbm_bytes(1) == 1000 + 300 - 100
    assert tmb.fit_mem_budget(1) == 1200
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "0")
    assert tmb.fit_mem_budget(1) == 0


# --- degraded fits -----------------------------------------------------------------


def _kmeans_init():
    return X[[3, 50, 120]].copy()


DEGRADED = {
    "pca": (lambda: PCA().setK(2), lambda: JaxPCA().setK(2), X,
            lambda r: PCA().setK(2).fit(r)),
    "kmeans": (lambda: KMeans().setK(3).setInitialModel(_kmeans_init()),
               lambda: JaxKMeans().setK(3).setInitialModel(_kmeans_init()), X,
               lambda r: KMeans().setK(3).setInitialModel(_kmeans_init()).fit(r)),
    "linear": (lambda: LinearRegression().setRegParam(0.1), lambda: JaxLinR().setRegParam(0.1), (X, Y_LIN),
               lambda r: LinearRegression().setRegParam(0.1).fit((r, Y_LIN))),
    "logistic": (lambda: LogisticRegression().setRegParam(0.01).setTol(1e-10),
                 lambda: JaxLR().setRegParam(0.01).setTol(1e-10), (X, Y_LOG),
                 lambda r: LogisticRegression().setRegParam(0.01).setTol(1e-10).fit((r, Y_LOG))),
}


def _state(family, model):
    if family == "pca":
        return [model.pc, model.explainedVariance]
    if family == "kmeans":
        return [model.clusterCenters(), np.array([model.trainingCost, model.numIter])]
    if family == "linear":
        return [model.coefficients, np.array([model.intercept])]
    return [model.weights, model.intercepts, np.array([model.numIter])]


def _aligned(pc, want):
    signs = np.where(np.sum(pc * want, axis=0) < 0, -1.0, 1.0)
    return pc * signs


_DEGRADED_FITS = {}


def _degraded_fit(family, monkeypatch):
    """The port's degraded fit (a budget of 1 byte, 40-row blocks), once."""
    if family not in _DEGRADED_FITS:
        port_est, _, data, _ = DEGRADED[family]
        with monkeypatch.context() as m:
            m.setenv("TPUML_FIT_MEM_BUDGET", "1")
            m.setenv("TPUML_FIT_BLOCK_ROWS", "40")
            with pytest.warns(DegradationWarning):
                _DEGRADED_FITS[family] = port_est().fit(data)
    return _DEGRADED_FITS[family]


@pytest.mark.parametrize("family", list(DEGRADED))
def test_degraded_fit_matches_the_reference(monkeypatch, family):
    _, jax_est, data, _ = DEGRADED[family]
    ours = _degraded_fit(family, monkeypatch)
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1")
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "40")
    with pytest.warns(jdegrade.DegradationWarning):
        theirs = jax_est().fit(data)
    got, want = _state(family, ours), _state(family, theirs)
    if family == "pca":
        np.testing.assert_allclose(_aligned(got[0], want[0]), want[0], rtol=0, atol=1e-8)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-10)
        return
    tol = 1e-4 if family == "kmeans" else 1e-10
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))
    if family in ("kmeans", "logistic"):
        assert got[-1][-1] == want[-1][-1]  # numIter


@pytest.mark.parametrize("family", list(DEGRADED))
def test_degraded_fit_is_the_explicit_reader_fit_bit_for_bit(monkeypatch, family):
    degraded = _degraded_fit(family, monkeypatch)
    explicit = DEGRADED[family][3](tdata.HostArrayBlockReader(X, block_rows=40))
    for a, b in zip(_state(family, degraded), _state(family, explicit)):
        np.testing.assert_array_equal(a, b)


# --- recovery ----------------------------------------------------------------------


def _oom():
    return torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")


@pytest.mark.parametrize("family", list(DEGRADED))
def test_an_oom_mid_fit_is_recovered_by_streaming(monkeypatch, family):
    cls = {"pca": PCA, "kmeans": KMeans, "linear": LinearRegression, "logistic": LogisticRegression}[family]
    real = cls._fit_in_memory

    def flaky(self, rows, *args):
        if not tdata.is_streaming_source(rows):
            raise _oom()
        return real(self, rows, *args)

    monkeypatch.setattr(cls, "_fit_in_memory", flaky)
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "40")
    names = ("fit.oom.events", "fit.oom.recovered", "fit.oom.reclaims", "degrade.events")
    before = {n: ttracing.counter_value(n) for n in names}
    with pytest.warns(DegradationWarning, match="out of memory mid-fit"):
        model = DEGRADED[family][0]().fit(DEGRADED[family][2])
    assert {n: ttracing.counter_value(n) - v for n, v in before.items()} == dict.fromkeys(names, 1)
    for a, b in zip(_state(family, model), _state(family, _degraded_fit(family, monkeypatch))):
        np.testing.assert_array_equal(a, b)


def _always_oom(log, exc):
    def fit_with_reader(reader):
        log.append(reader.block_rows)
        raise exc
    return fit_with_reader


@pytest.mark.parametrize("retries", ["1", "3", "6"])
def test_repeated_ooms_halve_like_the_reference(monkeypatch, retries):
    monkeypatch.setenv("TPUML_FIT_OOM_RETRIES", retries)
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "1000")
    ours, theirs = [], []
    with pytest.raises(tmb.FitMemoryError) as got:
        tmb.run_streaming_with_recovery("kmeans", _always_oom(ours, _oom()), X)
    with pytest.raises(jmb.FitMemoryError) as want:
        jmb.run_streaming_with_recovery("kmeans", _always_oom(theirs, RuntimeError("RESOURCE_EXHAUSTED")), X)
    assert ours == theirs and ours[0] == 1000 and min(ours) >= tmb.MIN_BLOCK_ROWS
    assert len(ours) == int(retries)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value.__cause__, torch.OutOfMemoryError)


def test_streaming_recovers_after_two_ooms(monkeypatch):
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "1000")
    seen = []

    def fit_with_reader(reader):
        seen.append(reader.block_rows)
        if len(seen) < 3:
            raise RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)")
        return sum(b.shape[0] for b in reader.iter_blocks())

    before = ttracing.counter_value("fit.oom.recovered")
    assert tmb.run_streaming_with_recovery("linear", fit_with_reader, X) == X.shape[0]
    assert seen == [1000, 500, 256]
    assert ttracing.counter_value("fit.oom.recovered") == before + 1


def test_the_failed_attempt_is_gone_when_the_fallback_starts():
    """T1: the reroute runs after the except block is left, with the failed
    attempt's traceback cleared, so what it allocated can be freed."""
    ref = {}

    def attempt():
        held = torch.ones(1000)
        ref["t"] = weakref.ref(held)
        raise _oom()

    def fallback():
        gc.collect()
        ref["alive_at_fallback"] = ref["t"]() is not None
        return "streamed"

    with pytest.warns(DegradationWarning):
        assert tmb.run_fit_with_oom_recovery("pca", attempt, fallback) == "streamed"
    assert ref["alive_at_fallback"] is False


def test_without_a_fallback_an_oom_is_a_fit_memory_error(monkeypatch):
    with pytest.raises(tmb.FitMemoryError, match="cannot degrade to streaming") as err:
        tmb.run_fit_with_oom_recovery("umap", lambda: (_ for _ in ()).throw(_oom()))
    assert isinstance(err.value.__cause__, torch.OutOfMemoryError)
    monkeypatch.setenv("TPUML_FIT_DEGRADE", "off")
    with pytest.raises(tmb.FitMemoryError, match="cannot degrade"):
        tmb.run_fit_with_oom_recovery("pca", lambda: (_ for _ in ()).throw(_oom()), lambda: "never")


@pytest.mark.parametrize("exc", [RuntimeError("shape mismatch"), ValueError("out of memory"),
                                 KeyError("x"), tmb.FitMemoryError("pca", "already structured")])
def test_other_errors_propagate_untouched(exc):
    def attempt():
        raise exc

    with pytest.raises(type(exc)) as got:
        tmb.run_fit_with_oom_recovery("pca", attempt, lambda: "never")
    assert got.value is exc


@pytest.mark.parametrize("exc,structured", [(_oom(), True), (RuntimeError("boom"), False),
                                            (ValueError("ran out of memory"), False)])
def test_estimator_fit_is_the_safety_net(monkeypatch, exc, structured):
    def escaped(self, dataset):
        raise exc

    monkeypatch.setattr(PCA, "_fit", escaped)
    before = ttracing.counter_value("fit.oom.events")
    with pytest.raises(tmb.FitMemoryError if structured else type(exc)) as got:
        PCA().setK(2).fit(X)
    if structured:
        assert "exhausted during the fit" in str(got.value) and got.value.__cause__ is exc
        assert got.value.family == "PCA"
    else:
        assert got.value is exc
    assert ttracing.counter_value("fit.oom.events") == before + int(structured)


OOM_CASES = {
    "resource_exhausted": RuntimeError("RESOURCE_EXHAUSTED: while allocating"),
    "out_of_memory": RuntimeError("CUDA out of memory."),
    "ran_out": RuntimeError("the device ran out of memory"),
    "value_error": ValueError("out of memory"),
    "other": RuntimeError("shape mismatch"),
    "chained": RuntimeError("retries exhausted"),
    "torch_oom": _oom(),
    "cublas": RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"),
    "cusolver": RuntimeError("cusolver error: CUSOLVER_STATUS_ALLOC_FAILED"),
}
OOM_CASES["chained"].__cause__ = RuntimeError("RESOURCE_EXHAUSTED")
PORT_ONLY = {"cublas": True, "cusolver": True}  # this backend's RESOURCE_EXHAUSTED


@pytest.mark.parametrize("case", list(OOM_CASES))
def test_oom_classification(case):
    exc = OOM_CASES[case]
    want = PORT_ONLY.get(case, jretry.is_oom_error(exc))
    assert tretry.is_oom_error(exc) is want
    assert jretry.is_oom_error(exc) is (False if case in PORT_ONLY else want)


# --- records ------------------------------------------------------------------------


def test_events_are_written_in_the_reference_shape(monkeypatch, tmp_path):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("TPUML_EVENT_LOG", str(log))
    tevents.configure()
    try:
        n0 = tevents.emitted_count()
        monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1")
        with pytest.warns(DegradationWarning):
            PCA().setK(2).fit(X)
        with pytest.raises(tmb.FitMemoryError):
            PCA().setK(2).setCovarianceBackend("pallas").fit(X)
    finally:
        monkeypatch.delenv("TPUML_EVENT_LOG")
        tevents.configure()
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert tevents.emitted_count() - n0 == len(records) == 3
    assert [(r["event"], r.get("action")) for r in records] == [
        ("fit_admission", "degrade"), ("degrade", None), ("fit_admission", "reject")]
    for rec in records:
        assert jevents.validate_record(rec) == []
    assert records[0]["needed_bytes"] == _needed("pca") and records[0]["budget_bytes"] == 1
    assert not tevents.enabled()


def test_reclaim_counts_and_collects():
    before = ttracing.counter_value("fit.oom.reclaims")
    tserving.reclaim_device_memory(None)
    tserving.reclaim_device_memory(torch.device("cpu"))
    assert ttracing.counter_value("fit.oom.reclaims") == before + 2


@pytest.mark.parametrize("source", ["stream"])
def test_an_oom_without_a_host_matrix_is_a_fit_memory_error(monkeypatch, source):
    """A stream has no host matrix to re-block: its OOM ends in the
    structured error, not in a streaming reroute (in both packages)."""
    def oom(self, rows, *args):
        raise _oom()

    monkeypatch.setattr(PCA, "_fit_in_memory", oom)
    data = lambda: iter([X])  # noqa: E731
    with pytest.raises(tmb.FitMemoryError, match="cannot degrade to streaming"):
        PCA().setK(2).fit(data)


_FAMILY_CLASSES = {"pca": (PCA, JaxPCA), "kmeans": (KMeans, JaxKMeans),
                   "linear": (LinearRegression, JaxLinR), "logistic": (LogisticRegression, JaxLR)}


def _on_device(data, to_device):
    return (to_device(data[0]), data[1]) if isinstance(data, tuple) else to_device(data)


def _raise_in_memory(monkeypatch, cls, is_stream, exc):
    real = cls._fit_in_memory

    def flaky(self, rows, *args):
        if not is_stream(rows):
            raise exc
        return real(self, rows, *args)

    monkeypatch.setattr(cls, "_fit_in_memory", flaky)


@pytest.mark.parametrize("family", list(DEGRADED))
def test_an_oom_on_a_tensor_is_recovered_by_streaming(monkeypatch, family):
    """A tensor that meets an OOM is copied to the host in its own dtype
    and streamed, as the reference recovers a device array: the result is
    the JAX package's recovered fit of the same rows, and bitwise the
    port's explicit ``HostArrayBlockReader`` fit."""
    port_cls, jax_cls = _FAMILY_CLASSES[family]
    port_est, jax_est, data, explicit_fit = DEGRADED[family]
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "40")
    _raise_in_memory(monkeypatch, port_cls, tdata.is_streaming_source, _oom())
    _raise_in_memory(monkeypatch, jax_cls, jdata.is_streaming_source,
                     RuntimeError("RESOURCE_EXHAUSTED: while allocating"))
    names = ("fit.oom.events", "fit.oom.recovered", "degrade.events")
    before = {n: ttracing.counter_value(n) for n in names}
    with pytest.warns(DegradationWarning, match="out of memory mid-fit"):
        ours = port_est().fit(_on_device(data, torch.from_numpy))
    assert {n: ttracing.counter_value(n) - v for n, v in before.items()} == dict.fromkeys(names, 1)
    with pytest.warns(jdegrade.DegradationWarning):
        theirs = jax_est().fit(_on_device(data, jnp.asarray))
    got, want = _state(family, ours), _state(family, theirs)
    if family == "pca":
        np.testing.assert_allclose(_aligned(got[0], want[0]), want[0], rtol=0, atol=1e-8)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-10)
    else:
        tol = 1e-4 if family == "kmeans" else 1e-10
        for a, b in zip(got[:-1], want[:-1]):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))
        if family in ("kmeans", "logistic"):
            assert got[-1][-1] == want[-1][-1]  # numIter
    explicit = explicit_fit(tdata.HostArrayBlockReader(X, block_rows=40))
    for a, b in zip(got, _state(family, explicit)):
        np.testing.assert_array_equal(a, b)


def test_a_tensor_copies_to_the_host_in_its_own_dtype():
    x32 = torch.from_numpy(X.astype(np.float32))
    m = tmb.host_matrix(x32)
    assert m.dtype == np.float32 and np.array_equal(m, X.astype(np.float32))
    assert tmb.host_matrix(torch.from_numpy(X)).dtype == np.float64
    assert tdata.as_matrix(x32[0]).shape == (1, X.shape[1])
