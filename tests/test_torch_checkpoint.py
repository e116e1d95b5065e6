"""Checkpointed fits that resume mid-solve, in the port, on the CPU.

Mirrors the non-Spark cases of ``tests/test_checkpoint.py``, with the
reference as the oracle where the two packages compute the same thing:

- ``data_fingerprint`` and ``params_hash`` give the reference's digests on
  the same arrays and parameters (a dtype under its numpy name; int32
  moments that wrap);
- with the knobs off, or only one of them set, a fit is the monolithic
  fit and writes nothing;
- segmented equals monolithic bitwise within the port for KMeans' Lloyd
  (7b), the linear FISTA (8b), logistic L-BFGS (9b) and the UMAP layout
  (12a, both tail routes), and for KMeans and logistic also on an (8, 1)
  and a (4, 2) mesh;
- a fit killed at a segment boundary resumes bitwise with strictly fewer
  solver iterations, and the killed and the resumed runs' iterations sum
  to the uninterrupted run's (the reference's rule); a worker process
  that dies (an injected fatal fault, or a SIGKILL while it is frozen at a
  boundary) leaves a snapshot the parent resumes bitwise;
- stale parameters or data never resume; torn, truncated and
  fault-skipped files fall back to the previous snapshot; retention keeps
  the last K; a failed write warns and the fit goes on;
- the port's snapshot at each step holds the reference's solver state at
  that step: KMeans centres 1e-8, the FISTA carry 1e-10, the L-BFGS
  parameters 1e-8, the UMAP layout 1e-5 with JAX's negatives passed in.
"""

import glob
import os
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.manifold import UMAP
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.robustness import (
    CheckpointWriteWarning,
    EphemeralSegmenter,
    FitCheckpointer,
    InjectedFault,
    data_fingerprint,
    inject,
    params_hash,
    replicate_state_onto_mesh,
)
from spark_rapids_ml_tpu_torch.robustness.checkpoint import DIR_ENV, EVERY_ENV, UMAP_ENV
from spark_rapids_ml_tpu_torch.robustness.faults import disarm, parse_spec
from spark_rapids_ml_tpu_torch.utils.tracing import clear_counters, counter_value, counters

REPO = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT = 120


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    disarm()


@pytest.fixture(autouse=True)
def _fresh_counters():
    clear_counters("checkpoint")
    yield


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (DIR_ENV, EVERY_ENV, UMAP_ENV, "TPUML_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture
def ckpt_dir(tmp_path, monkeypatch):
    root = str(tmp_path / "ckpts")
    monkeypatch.setenv(DIR_ENV, root)
    monkeypatch.setenv(EVERY_ENV, "2")
    return root


@pytest.fixture
def data():
    return np.random.default_rng(42).normal(size=(200, 5))


def _kmeans_fit(x, uid="ck-kmeans", max_iter=16, tol=0.0, mesh=None):
    m = KMeans(uid=uid, mesh=mesh).setK(6).setMaxIter(max_iter).setTol(tol).setSeed(3).fit(x)
    return m, (np.asarray(m.clusterCenters()).tobytes(), np.float64(m.trainingCost).tobytes(), m.numIter)


def _logistic_fit(x, uid="ck-logreg", mesh=None):
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
    m = LogisticRegression(uid=uid, mesh=mesh).setMaxIter(40).fit((x, y))
    return m, (np.asarray(m.coefficients).tobytes(), np.float64(m.intercept).tobytes(), m.numIter)


def _linreg_enet_fit(x, uid="ck-linreg"):
    y = x @ np.arange(1.0, 6.0) + 0.5
    m = LinearRegression(uid=uid).setRegParam(0.1).setElasticNetParam(0.5).fit((x, y))
    return m, (np.asarray(m.coefficients).tobytes(), np.float64(m.intercept).tobytes())


def _umap_fit(x, uid="ck-umap"):
    m = UMAP(uid=uid).setNComponents(2).setNNeighbors(8).setNEpochs(40).setSeed(1).fit(
        x[:80].astype(np.float32))
    return m, (np.asarray(m.embedding).tobytes(),)


FITS = {"kmeans": _kmeans_fit, "logistic": _logistic_fit, "linreg_enet": _linreg_enet_fit, "umap": _umap_fit}


@pytest.fixture
def umap_opt_in(monkeypatch):
    monkeypatch.setenv(UMAP_ENV, "1")


def _mesh(shape):
    return make_mesh(shape, devices=[torch.device("cpu")] * 8)


# --- the digests ----------------------------------------------------------------


def _arrays(rng):
    big = rng.normal(size=(64, 3)) * 4e4  # cubes wrap int32
    nans = rng.normal(size=(10, 4)).astype(np.float32)
    nans[2, 1] = np.nan
    nans[5, 3] = np.inf
    return [
        rng.normal(size=(50, 5)),
        rng.normal(size=(50, 5)).astype(np.float32),
        big,
        nans,
        rng.integers(0, 7, size=40),
        rng.normal(size=(33,)),
        np.float64(2.5),
        3,
        None,
        np.round(rng.normal(size=(16, 2)) * 8) / 8.0,  # dyadic: exact
    ]


def test_data_fingerprint_is_the_reference_digest():
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.robustness.checkpoint import data_fingerprint as jfp

    arrays = _arrays(np.random.default_rng(7))
    for a in arrays:
        ours_np = data_fingerprint(a)
        theirs = jfp(a if a is None or np.isscalar(a) or isinstance(a, np.generic) else jnp.asarray(a))
        assert ours_np == theirs, a
        if isinstance(a, np.ndarray):
            assert data_fingerprint(torch.from_numpy(a)) == theirs
    assert data_fingerprint(*arrays) == jfp(*[a if not isinstance(a, np.ndarray) else jnp.asarray(a)
                                             for a in arrays])


def test_a_fingerprint_is_one_of_its_rows_not_their_sharding():
    x = np.random.default_rng(3).normal(size=(41, 6)).astype(np.float32)
    whole = data_fingerprint(torch.from_numpy(x))
    assert data_fingerprint([torch.from_numpy(x[:20]), torch.from_numpy(x[20:])]) == whole
    assert data_fingerprint([x[:1], x[1:30], x[30:]]) == whole
    padded = np.concatenate([x, np.zeros((7, 6), np.float32)])
    assert data_fingerprint(padded) == whole  # zero pad rows move no moment
    assert data_fingerprint(x[::-1].copy()) == whole  # row order does not matter
    assert data_fingerprint(x + np.float32(1.0 / 8192)) != whole
    assert data_fingerprint(x.astype(np.float64)) != whole  # the dtype enters


@pytest.mark.parametrize("family", ["kmeans", "logistic", "linear", "umap"])
def test_params_hash_is_the_reference_digest(family):
    from spark_rapids_ml_tpu.models.kmeans import KMeans as JKMeans
    from spark_rapids_ml_tpu.models.linear_regression import LinearRegression as JLinear
    from spark_rapids_ml_tpu.models.logistic_regression import LogisticRegression as JLogistic
    from spark_rapids_ml_tpu.models.umap import UMAP as JUMAP

    pairs = {
        "kmeans": (lambda E: E(uid="job-42").setK(7).setMaxIter(9).setTol(1e-3).setSeed(5), KMeans, JKMeans),
        "logistic": (lambda E: E(uid="job-42").setMaxIter(40).setRegParam(0.01), LogisticRegression, JLogistic),
        "linear": (lambda E: E(uid="job-42").setRegParam(0.1).setElasticNetParam(0.5), LinearRegression, JLinear),
        "umap": (lambda E: E(uid="job-42").setNComponents(2).setSeed(1), UMAP, JUMAP),
    }
    build, ours, theirs = pairs[family]
    assert params_hash(build(ours)) == params_hash_reference(build(theirs))
    changed = build(ours).setSeed(99) if family in ("kmeans", "umap") else build(ours).setRegParam(0.2)
    assert params_hash(build(ours)) != params_hash(changed)
    assert params_hash(build(ours)) != params_hash(type(build(ours))(uid="job-42"))


def params_hash_reference(instance):
    from spark_rapids_ml_tpu.robustness.checkpoint import params_hash as jph

    return jph(instance)


# --- the knobs off --------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FITS))
def test_partial_knobs_stay_disabled(family, data, tmp_path, monkeypatch, umap_opt_in):
    _, want = FITS[family](data)
    monkeypatch.setenv(DIR_ENV, str(tmp_path / "c"))  # a dir without EVERY
    _, got_dir_only = FITS[family](data)
    monkeypatch.delenv(DIR_ENV)
    monkeypatch.setenv(EVERY_ENV, "2")  # EVERY without a dir
    _, got_every_only = FITS[family](data)
    assert got_dir_only == want and got_every_only == want
    assert counters("checkpoint") == {}
    assert not os.path.exists(str(tmp_path / "c"))


def test_umap_is_opt_in(data, ckpt_dir, monkeypatch):
    monkeypatch.setenv(EVERY_ENV, "0")
    _, want = _umap_fit(data)
    monkeypatch.setenv(EVERY_ENV, "16")
    assert _umap_fit(data)[1] == want
    assert counter_value("checkpoint.segments") == 0
    monkeypatch.setenv(UMAP_ENV, "1")
    assert _umap_fit(data)[1] == want
    assert counter_value("checkpoint.segments") == 3


# --- segmented equals monolithic ------------------------------------------------


@pytest.mark.parametrize("family", sorted(FITS))
def test_segmented_equals_monolithic(family, data, ckpt_dir, monkeypatch, umap_opt_in):
    monkeypatch.setenv(EVERY_ENV, "0")
    _, want = FITS[family](data)
    monkeypatch.setenv(EVERY_ENV, "3")
    _, got = FITS[family](data)
    assert got == want
    assert counter_value("checkpoint.segments") >= 2
    assert counter_value("checkpoint.write") == counter_value("checkpoint.segments")
    assert counter_value("checkpoint.completed") == 1
    assert glob.glob(os.path.join(ckpt_dir, "*", "ckpt-*.npz")) == []


def test_segmented_umap_on_the_k4_route_equals_monolithic(data, ckpt_dir, monkeypatch, umap_opt_in):
    """The tail route ``pallas`` builds K4's plan (its plain version on a
    CPU tensor): the segmented layout uses the same plan every epoch."""
    from spark_rapids_ml_tpu_torch.ops.kernels import umap as k4

    monkeypatch.setenv("TPUML_UMAP_SCATTER", "pallas")
    monkeypatch.setenv(EVERY_ENV, "0")
    _, want = _umap_fit(data)
    before = k4.launches["tail_accumulate"]
    monkeypatch.setenv(EVERY_ENV, "7")
    _, got = _umap_fit(data)
    assert got == want and k4.launches["tail_accumulate"] == before  # no CUDA tensor: no launch
    assert counter_value("checkpoint.solver_iters") == 40


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("family", ["kmeans", "logistic"])
def test_segmented_equals_monolithic_on_a_mesh(family, shape, data, ckpt_dir, monkeypatch):
    monkeypatch.setenv(EVERY_ENV, "0")
    _, want = FITS[family](data, mesh=_mesh(shape))
    monkeypatch.setenv(EVERY_ENV, "3")
    _, got = FITS[family](data, mesh=_mesh(shape))
    assert got == want and counter_value("checkpoint.segments") >= 2


def test_an_ephemeral_segmenter_segments_without_disk(data, monkeypatch):
    _, want = _kmeans_fit(data)
    est = KMeans(uid="ck-kmeans").setK(6).setMaxIter(16).setTol(0.0).setSeed(3)
    est._force_segment_every = 2
    m = est.fit(data)
    assert (np.asarray(m.clusterCenters()).tobytes(), np.float64(m.trainingCost).tobytes(), m.numIter) == want
    assert counter_value("checkpoint.segments") >= 2 and counter_value("checkpoint.write") == 0
    seg = EphemeralSegmenter(0)
    assert seg.every == 1 and seg.restore_latest(template=(1,)) is None


@pytest.mark.parametrize("checkpointed", [False, True], ids=["monolithic", "segmented"])
@pytest.mark.parametrize("family", sorted(FITS))
def test_a_finished_fit_leaves_no_tensor_in_a_reference_cycle(family, checkpointed, data, tmp_path,
                                                              monkeypatch, umap_opt_in):
    """What a fit allocated is freed when the fit returns, not at the next
    collection: the card's fit memory checks read the allocator right
    after a fit, and a cycle would keep the fit's rows alive there."""
    import gc

    if checkpointed:
        monkeypatch.setenv(DIR_ENV, str(tmp_path / "c"))
        monkeypatch.setenv(EVERY_ENV, "3")
    gc.collect()
    gc.disable()
    try:
        FITS[family](data)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cyclic == []


# --- crash and resume -------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FITS))
def test_a_fit_killed_mid_solve_resumes_bitwise(family, data, ckpt_dir, umap_opt_in):
    _, want = FITS[family](data)
    full_iters = counter_value("checkpoint.solver_iters")
    assert full_iters > 0

    clear_counters("checkpoint")
    with inject("checkpoint.segment=always:fatal"):
        with pytest.raises(InjectedFault):
            FITS[family](data)
    killed_iters = counter_value("checkpoint.solver_iters")
    assert counter_value("checkpoint.write") >= 1
    assert glob.glob(os.path.join(ckpt_dir, "*", "ckpt-*.npz"))

    clear_counters("checkpoint")
    _, got = FITS[family](data)
    assert got == want
    assert counter_value("checkpoint.restore") == 1
    assert counter_value("checkpoint.restore.steps") == killed_iters > 0
    resumed_iters = counter_value("checkpoint.solver_iters")
    assert resumed_iters < full_iters
    assert resumed_iters + counter_value("checkpoint.restore.steps") == full_iters


@pytest.mark.parametrize("family", ["kmeans", "logistic"])
def test_a_mesh_fit_resumes_on_another_mesh(family, data, ckpt_dir):
    """The fingerprint is of the real rows, so a fit killed on a (4, 2)
    mesh resumes on an (8, 1) mesh. The first segment ran on the other
    mesh's order of sums, so the result is the (8, 1) fit's to 1e-10,
    with the same iteration count."""
    _, want = FITS[family](data, mesh=_mesh((8, 1)))
    clear_counters("checkpoint")
    with inject("checkpoint.segment=1:fatal"):
        with pytest.raises(InjectedFault):
            FITS[family](data, mesh=_mesh((4, 2)))
    clear_counters("checkpoint")
    _, got = FITS[family](data, mesh=_mesh((8, 1)))
    assert counter_value("checkpoint.restore") == 1
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.frombuffer(a), np.frombuffer(b), rtol=1e-10, atol=1e-10)


def test_the_resumed_fit_matches_checkpointing_off(data, ckpt_dir, monkeypatch):
    monkeypatch.setenv(EVERY_ENV, "0")
    _, want = _kmeans_fit(data)
    monkeypatch.setenv(EVERY_ENV, "2")
    with inject("checkpoint.segment=1:fatal"):
        with pytest.raises(InjectedFault):
            _kmeans_fit(data)
    _, got = _kmeans_fit(data)
    assert got == want


WORKER = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from spark_rapids_ml_tpu_torch import device
device.set_platform("cpu")
from spark_rapids_ml_tpu_torch.clustering import KMeans
x = np.random.default_rng(7).normal(size=(200, 5))
KMeans(uid="ck-worker").setK(6).setMaxIter(16).setTol(0.0).setSeed(3).fit(x)
print("UNEXPECTED-COMPLETION")
"""


def _worker_env(ckpt_dir, faults):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
    env.update({DIR_ENV: ckpt_dir, EVERY_ENV: "2", "TPUML_FAULTS": faults, "JAX_PLATFORMS": "cpu"})
    return env


def _resume_worker_fit(monkeypatch):
    x = np.random.default_rng(7).normal(size=(200, 5))
    monkeypatch.setenv(EVERY_ENV, "0")
    _, want = _kmeans_fit(x, uid="ck-worker")
    monkeypatch.setenv(EVERY_ENV, "2")
    clear_counters("checkpoint")
    _, got = _kmeans_fit(x, uid="ck-worker")
    return got, want


def test_a_killed_worker_process_leaves_a_checkpoint_to_resume(ckpt_dir, tmp_path, monkeypatch):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO)))
    proc = subprocess.run([sys.executable, str(script)], env=_worker_env(ckpt_dir, "checkpoint.segment=always:fatal"),
                          capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "UNEXPECTED-COMPLETION" not in proc.stdout
    assert "checkpoint.segment" in proc.stderr
    assert glob.glob(os.path.join(ckpt_dir, "*", "ckpt-*.npz"))
    got, want = _resume_worker_fit(monkeypatch)
    assert got == want
    assert counter_value("checkpoint.restore") == 1 and counter_value("checkpoint.restore.steps") == 2


def test_a_sigkilled_worker_leaves_a_checkpoint_to_resume(ckpt_dir, tmp_path, monkeypatch):
    """A real process death: the worker freezes at its first segment
    boundary (after the snapshot committed) and is SIGKILLed there."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO)))
    proc = subprocess.Popen([sys.executable, str(script)], env=_worker_env(ckpt_dir, "checkpoint.segment=always:stall"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT
        while not glob.glob(os.path.join(ckpt_dir, "*", "ckpt-*.npz")):
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "no snapshot committed"
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    got, want = _resume_worker_fit(monkeypatch)
    assert got == want
    assert counter_value("checkpoint.restore") == 1 and counter_value("checkpoint.restore.steps") == 2


# --- stale and corrupt snapshots -------------------------------------------------


def _crash_kmeans(x):
    with inject("checkpoint.segment=always:fatal"):
        with pytest.raises(InjectedFault):
            _kmeans_fit(x)


def test_changed_params_never_resume(data, ckpt_dir):
    _crash_kmeans(data)
    clear_counters("checkpoint")
    _, got = _kmeans_fit(data, tol=1e-3)
    assert counter_value("checkpoint.restore") == 0
    for f in glob.glob(os.path.join(ckpt_dir, "*", "ckpt-*.npz")):
        os.remove(f)
    _, want = _kmeans_fit(data, tol=1e-3)
    assert got == want


def test_changed_data_is_stale(data, ckpt_dir):
    _crash_kmeans(data)
    clear_counters("checkpoint")
    _kmeans_fit(np.random.default_rng(5).normal(size=(200, 5)))
    assert counter_value("checkpoint.restore") == 0
    assert counter_value("checkpoint.skipped_stale") >= 1


def _ck(tmp_path, **kw):
    return FitCheckpointer(str(tmp_path / "run"), uid="u", param_hash="p", data_fp="d", every=1, **kw)


def test_a_torn_write_lands_truncated_and_is_rejected(tmp_path):
    ck = _ck(tmp_path)
    s1 = (torch.arange(4.0), np.int64(1))
    s2 = (torch.arange(4.0) * 2, np.int64(2))
    ck.save_async(1, s1)
    ck.wait()
    with inject("checkpoint.write=1:torn") as plan:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ck.save_async(2, s2)
            ck.wait()
    assert plan.fired == [("checkpoint.write", 0)]
    assert any(isinstance(w.message, CheckpointWriteWarning) for w in caught)
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpt-00000001.npz", "ckpt-00000002.npz"]
    clear_counters("checkpoint")
    step, state = ck.restore_latest(template=s1)
    assert step == 1
    assert counter_value("checkpoint.corrupt") == 1 and counter_value("checkpoint.restore") == 1
    assert isinstance(state[0], torch.Tensor) and isinstance(state[1], np.int64)
    np.testing.assert_array_equal(state[0].numpy(), np.arange(4.0))


def test_a_truncated_file_falls_back(tmp_path):
    ck = _ck(tmp_path)
    s = (torch.arange(3.0),)
    ck.save_async(1, s)
    ck.wait()
    ck.save_async(2, (torch.arange(3.0) * 5,))
    ck.wait()
    newest = str(tmp_path / "run" / "ckpt-00000002.npz")
    raw = open(newest, "rb").read()
    with open(newest, "wb") as f:
        f.write(raw[: len(raw) // 2])
    step, _ = ck.restore_latest(template=s)
    assert step == 1 and counter_value("checkpoint.corrupt") == 1


def test_a_restore_fault_skips_the_newest(tmp_path):
    ck = _ck(tmp_path)
    for i in (1, 2):
        ck.save_async(i, (torch.arange(3.0) * i,))
        ck.wait()
    with inject("checkpoint.restore=1"):
        step, _ = ck.restore_latest(template=(torch.arange(3.0),))
    assert step == 1
    with inject("checkpoint.restore=1:fatal"):
        with pytest.raises(InjectedFault):
            ck.restore_latest(template=(torch.arange(3.0),))


def test_a_template_of_other_shapes_or_dtypes_is_stale(tmp_path):
    ck = _ck(tmp_path)
    ck.save_async(1, (torch.arange(3.0, dtype=torch.float64), np.int64(4)))
    ck.wait()
    assert ck.restore_latest(template=(torch.arange(4.0, dtype=torch.float64), np.int64(0))) is None
    assert ck.restore_latest(template=(torch.arange(3.0, dtype=torch.float32), np.int64(0))) is None
    assert ck.restore_latest(template=(torch.arange(3.0, dtype=torch.float64),)) is None
    step, state = ck.restore_latest(template=(torch.zeros(3, dtype=torch.float64), np.int32(0)))
    assert step == 1 and state[1] == 4 and state[1].dtype == np.int32  # integer widths may differ
    assert counter_value("checkpoint.skipped_stale") == 3


def test_retention_keeps_the_last_k(tmp_path):
    ck = _ck(tmp_path, keep=2)
    for i in range(1, 6):
        ck.save_async(i, (torch.arange(2.0) * i,))
        ck.wait()
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpt-00000004.npz", "ckpt-00000005.npz"]
    ck.finalize_success()
    assert not os.path.exists(tmp_path / "run") and counter_value("checkpoint.completed") == 1


def test_a_failed_write_warns_and_the_fit_goes_on(data, ckpt_dir):
    _, want = _kmeans_fit(data)
    clear_counters("checkpoint")
    with inject("checkpoint.write=always"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, got = _kmeans_fit(data)
    assert got == want
    assert any(isinstance(w.message, CheckpointWriteWarning) for w in caught)
    assert counter_value("checkpoint.write_failed") == counter_value("checkpoint.segments") >= 2


def test_snapshots_copy_state_at_the_boundary(tmp_path):
    """A leaf updated in place after ``save_async`` does not reach the
    snapshot: host arrays and tensors are copied at the call."""
    ck = _ck(tmp_path)
    arr, ten = np.arange(4.0), torch.arange(4.0)
    ck.save_async(1, (arr, ten))
    arr[:] = -1.0
    ten.fill_(-1.0)
    ck.wait()
    _, (a, t) = ck.restore_latest(template=(np.zeros(4), torch.zeros(4, dtype=torch.float32)))
    np.testing.assert_array_equal(a, np.arange(4.0))
    np.testing.assert_array_equal(t.numpy(), np.arange(4.0))


def test_the_torn_spec_parses():
    plan = parse_spec("checkpoint.write=1:torn; checkpoint.restore=2")
    assert plan["checkpoint.write"].torn and not plan["checkpoint.write"].fatal
    assert not plan["checkpoint.restore"].torn


def test_a_restored_state_is_placed_on_the_mesh_first_device():
    mesh = _mesh((4, 2))
    state = (torch.arange(3.0), np.int64(2), np.float64(1.5))
    placed = replicate_state_onto_mesh(state, mesh)
    assert placed[0].device == mesh.first_device and placed[1:] == state[1:]


# --- the snapshots against the reference's solver state --------------------------


class _Recorder:
    """A checkpointer that keeps every snapshot in memory, as host arrays."""

    def __init__(self, every, flatten):
        self.every = every
        self.flatten = flatten
        self.states = {}

    def restore_latest(self, template=None):
        return None

    def save_async(self, step, state):
        self.states[int(step)] = [np.array(leaf) for leaf in self.flatten(state)]

    def wait(self):
        pass

    def finalize_success(self):
        pass


def _jax_recorder(every):
    import jax

    return _Recorder(every, jax.tree_util.tree_leaves)


def _port_recorder(every):
    return _Recorder(every, lambda s: [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf
                                       for leaf in s])


def test_lloyd_snapshots_hold_the_reference_state():
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import kmeans as jkm
    from spark_rapids_ml_tpu_torch.ops import kmeans as tkm

    rng = np.random.default_rng(11)
    x = rng.normal(size=(240, 4)) + np.repeat(np.eye(3, 4) * 5.0, 80, axis=0)
    init = x[[0, 100, 200]] + 0.1
    mask = np.ones(240)
    ours, theirs = _port_recorder(2), _jax_recorder(2)
    c, cost, it = tkm.lloyd_resumable(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(init),
                                      ours, max_iter=9, tol=1e-12)
    jc, jcost, jit = jkm.lloyd_resumable(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(init), theirs,
                                         max_iter=9, tol=1e-12)
    assert sorted(ours.states) == sorted(theirs.states) and it == int(jit)
    for step in ours.states:
        (pc, pm, pit, pcost), (jc_, jm, jit_, jcost_) = ours.states[step], theirs.states[step]
        np.testing.assert_allclose(pc, jc_, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(pcost, jcost_, rtol=1e-8)
        assert int(pit) == int(jit_) == step
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-8)


def test_fista_snapshots_hold_the_reference_state():
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import linear as jlin
    from spark_rapids_ml_tpu_torch.ops import linear as tlin

    rng = np.random.default_rng(12)
    x = rng.normal(size=(150, 6)) * np.linspace(0.5, 3.0, 6)
    y = x @ rng.normal(size=6) + 0.3 * rng.normal(size=150)
    stats = tlin.normal_eq_stats(torch.from_numpy(x), torch.from_numpy(y))
    kw = dict(reg_param=0.2, elastic_net_param=0.7, max_iter=30, tol=1e-12)
    ours, theirs = _port_recorder(4), _jax_recorder(4)
    coef, b0, it = tlin.solve_elastic_net_resumable(*stats[:4], stats[5], checkpointer=ours, **kw)
    jcoef, jb0, jit = jlin.solve_elastic_net_resumable(*[jnp.asarray(s.numpy()) for s in stats[:4]],
                                                       jnp.asarray(stats[5].numpy()), checkpointer=theirs, **kw)
    assert sorted(ours.states) == sorted(theirs.states) and it == int(jit)
    for step in ours.states:
        (pc, pz, pt, pit, pdelta), (jc, jz, jt, jit_, jdelta) = ours.states[step], theirs.states[step]
        for a, b in ((pc, jc), (pz, jz), (pt, jt), (pdelta, jdelta)):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
        assert int(pit) == int(jit_) == step
    np.testing.assert_allclose(coef.numpy(), np.asarray(jcoef), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("multinomial", [False, True])
def test_lbfgs_snapshots_hold_the_reference_state(multinomial):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import logistic as jlog
    from spark_rapids_ml_tpu_torch.ops import logistic as tlog

    rng = np.random.default_rng(13)
    x = rng.normal(size=(160, 4)) * np.array([1.0, 2.0, 0.5, 3.0]) + 1.0
    y = (x[:, 0] - 0.5 * x[:, 1] + rng.normal(size=160) > 1.0).astype(np.float64)
    if multinomial:
        y = y + (x[:, 3] > 2.0)
    mask = np.ones(160)
    kw = dict(n_classes=3 if multinomial else 2, reg_param=0.01, max_iter=12, tol=1e-10,
              multinomial=multinomial)
    ours, theirs = _port_recorder(3), _jax_recorder(3)
    fit = tlog.fit_logistic_resumable(torch.from_numpy(x), torch.from_numpy(y).to(torch.int64),
                                      torch.from_numpy(mask), ours, **kw)
    jfit = jlog.fit_logistic_resumable(jnp.asarray(x), jnp.asarray(y.astype(np.int32)), jnp.asarray(mask),
                                       theirs, **kw)
    assert sorted(ours.states) == sorted(theirs.states) and fit.n_iter == int(jfit.n_iter)
    for step in ours.states:
        theta = ours.states[step][0]
        jw, jb = theirs.states[step][0], theirs.states[step][1]
        np.testing.assert_allclose(theta, np.concatenate([jw.ravel(), jb]), rtol=1e-8, atol=1e-8)
        assert int(ours.states[step][3]) == step
    np.testing.assert_allclose(fit.weights.numpy(), np.asarray(jfit.weights), rtol=1e-8, atol=1e-8)


def test_layout_snapshots_hold_the_reference_state():
    """Per-edge negatives, JAX's draws passed in, one epoch a segment. Two
    epochs: the SGD amplifies the packages' ulp differences, ~4x an epoch
    here, so longer layouts are held structurally (tests/test_torch_umap.py)."""
    import jax
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.models.umap import _knn_excluding_self as jknn
    from spark_rapids_ml_tpu.ops import umap as jou
    from spark_rapids_ml_tpu_torch.ops import umap as pou

    rng = np.random.default_rng(14)
    x = np.concatenate([rng.normal(size=(40, 6)) + c for c in (0.0, 10.0, 20.0)])
    jd, ji = jknn(jnp.asarray(x, dtype=jnp.float32), 6, "euclidean")
    jg = jou.fuzzy_simplicial_set(ji, jd)
    pg = pou.FuzzyGraph(*(torch.from_numpy(np.array(a)) for a in jg))
    y0 = rng.uniform(-10, 10, size=(120, 2)).astype(np.float32)
    a, b = jou.find_ab_params(1.0, 0.1)
    kw = dict(n_epochs=2, neg_rate=3, neg_pool=0, learning_rate=1.0, repulsion=1.0, a=a, b=b)
    key, draws = jax.random.key(5), []
    for _ in range(2):
        key, k_neg = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.randint(k_neg, (120 * 6, 3), 0, 120))))
    ours, theirs = _port_recorder(1), _jax_recorder(1)
    gen = torch.Generator()
    y = pou.optimize_layout_resumable(torch.from_numpy(y0), pg, gen, ours, negatives=lambda ep: draws[ep], **kw)
    jy = jou.optimize_layout_resumable(jnp.asarray(y0), jg, jax.random.key(5), theirs, **kw)
    assert sorted(ours.states) == sorted(theirs.states) == [1, 2]
    for step in ours.states:
        np.testing.assert_allclose(ours.states[step][0], theirs.states[step][0], atol=1e-5)
        assert int(ours.states[step][2]) == int(theirs.states[step][-1]) == step
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)


def test_a_resumed_layout_draws_what_the_uninterrupted_one_drew(tmp_path):
    """The generator's state rides the snapshot: a layout resumed from a
    snapshot equals the uninterrupted one bitwise."""
    from spark_rapids_ml_tpu_torch.ops import umap as pou

    rng = np.random.default_rng(15)
    n, k = 60, 5
    idx = torch.from_numpy(np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                                     for i in range(n)]).astype(np.int32))
    graph = pou.FuzzyGraph(idx, torch.rand((n, k), generator=torch.Generator().manual_seed(0)),
                           torch.ones(n), torch.zeros(n))
    y0 = torch.from_numpy(rng.uniform(-5, 5, size=(n, 2)).astype(np.float32))
    kw = dict(n_epochs=12, neg_pool=16)

    def gen():
        return torch.Generator().manual_seed(9)

    want = pou.optimize_layout(y0, graph, gen(), **kw)
    ck = FitCheckpointer(str(tmp_path / "run"), uid="u", param_hash="p", data_fp="d", every=5)
    with inject("checkpoint.segment=1:fatal"):
        with pytest.raises(InjectedFault):
            pou.optimize_layout_resumable(y0, graph, gen(), ck, **kw)
    clear_counters("checkpoint")
    got = pou.optimize_layout_resumable(y0, graph, gen(), ck, **kw)
    assert torch.equal(got, want)
    assert counter_value("checkpoint.restore.steps") == 5 and counter_value("checkpoint.solver_iters") == 7
