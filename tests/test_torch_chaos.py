"""Fault injection and the retry policy in the port, held against the JAX
package on the CPU.

Mirrors the non-Spark cases of ``tests/test_chaos.py``:

- the fault grammar: every spec parses to the reference's schedules, and a
  malformed spec raises the reference's error with its message;
- ``RetryPolicy``: the same classification, attempt counts, backoff delays
  (the deterministic jitter's values exactly), deadline behaviour and
  ``retry.*`` counters as the reference's policy;
- the sites: ``ingest.device_put`` (host rows, a mesh's host partitions, a
  tensor resharded over a mesh, PCA's partition uploads),
  ``persistence.write``, ``distributed.initialize`` and ``collective.psum``
  (a 2-rank gloo gang: this file is its own worker, ``python
  tests/test_torch_chaos.py gang PORT OUT``, each rank under a 120 s
  timeout): a recovered run is bitwise the clean one, an exhausted budget
  is one ``RetryExhaustedError`` with the fault chained, a fatal fault is
  not retried, and the reference fires the same invocations;
- ``solver.segment=1:oom`` drives the fit-path OOM recovery (a degraded
  streaming KMeans fit halves its block rows once and completes).
"""

import gc
import glob
import itertools
import os
import socket
import subprocess
import sys
import warnings
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch.parallel import distributed as tdist  # noqa: E402
from spark_rapids_ml_tpu_torch.robustness import faults as tfaults  # noqa: E402
from spark_rapids_ml_tpu_torch.robustness import retry as tretry  # noqa: E402
from spark_rapids_ml_tpu_torch.utils import tracing as ttracing  # noqa: E402

WORLD = 2
TIMEOUT = 120


# --- the gang worker ------------------------------------------------------


def _gang_blocks(rank: int):
    rng = np.random.default_rng(900 + rank)
    return [rng.normal(size=(40, 6)) + rank for _ in range(3)]


def _worker(case: str, port: int, out: str) -> None:
    """One rank: a bring-up whose first attempt is faulted, then the psum
    moment merge clean, recovered from one fault, and exhausted; a clean
    merge after the exhaustion shows the ranks still in lockstep."""
    port_device.set_platform("cpu")
    with tfaults.inject("distributed.initialize=1") as plan:
        tdist.initialize(coordinator_address=f"127.0.0.1:{port}")
    res = {"init_fired": np.asarray(plan.fired[0][1]), "init_count": np.asarray(len(plan.fired))}
    rank = tdist.process_index()
    mesh = tdist.global_mesh()

    def merge():
        mean, cov, n = tdist.streaming_covariance_process_local(iter(_gang_blocks(rank)), mesh=mesh, merge="psum")
        return mean, cov, n

    res["mean"], res["cov"], n = merge()
    with tfaults.inject("collective.psum=1") as plan:
        res["mean_rec"], res["cov_rec"], n_rec = merge()
    res["psum_fired"] = np.asarray(plan.fired)
    res["n"] = np.asarray([n, n_rec])
    with tfaults.inject("collective.psum=always"):
        try:
            merge()
            res["exhausted"] = np.asarray("no error")
        except tretry.RetryExhaustedError as exc:
            res["exhausted"] = np.asarray(f"{exc.attempts} {type(exc.__cause__).__name__}")
    res["mean_after"], res["cov_after"], _ = merge()
    np.savez(f"{out}.{rank}.npz", **res)
    torch.distributed.destroy_process_group()
    print(f"OK rank {rank}/{WORLD}")


# --- fixtures ---------------------------------------------------------------


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    """A test that dies mid-inject must not poison its neighbours."""
    from spark_rapids_ml_tpu.robustness.faults import disarm

    yield
    tfaults.disarm()
    disarm()


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    monkeypatch.setenv("TPUML_RETRY_BASE_DELAY", "0")


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture
def data():
    return np.random.default_rng(42).normal(size=(120, 5))


# --- the fault grammar ------------------------------------------------------

SPECS = [
    "ingest.device_put=2; barrier.attempt=always:fatal,persistence.write=0",
    "checkpoint.write=1:torn; checkpoint.restore=2",
    "solver.segment=1:oom",
    "ipc.recv=always@3:stall",
    "member.join=2@1:fatal:oom",
    "refit.swap=3@0 ; drift.tick=always ; refit.ingest=1:torn:fatal",
    "member.launch=1,ipc.send=4@2,refit.quality_gate=0@5",
    "distributed.initialize=1:stall:oom; collective.psum=always:fatal",
    "",
    " ; ,",
]

MALFORMED = [
    "ingest.device_put",
    "ingest.device_put=soon",
    "no.such.site=1",
    "ingest.device_put=-1",
    "ingest.device_put=1@x",
    "ingest.device_put=1@-2",
    "ingest.device_put=always@-1",
    "ingest.device_put=1:sometimes",
    "checkpoint.segment=",
]


def _schedule_facts(plan):
    return {site: (s.count, s.fatal, s.torn, s.oom, s.stall, s.skip,
                   [s.should_fail(i) for i in range(12)] + [s.should_fail(10 ** 6)])
            for site, s in plan.items()}


def test_every_site_of_the_reference_vocabulary_is_known():
    from spark_rapids_ml_tpu.robustness import faults as jfaults

    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert (tfaults.ALWAYS, tfaults.STALL_MAX_S, tfaults.FAULTS_ENV) == (
        jfaults.ALWAYS, jfaults.STALL_MAX_S, jfaults.FAULTS_ENV)


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_to_the_reference_schedules(spec):
    from spark_rapids_ml_tpu.robustness import faults as jfaults

    assert _schedule_facts(tfaults.parse_spec(spec)) == _schedule_facts(jfaults.parse_spec(spec))


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_specs_raise_the_reference_error(spec):
    from spark_rapids_ml_tpu.robustness import faults as jfaults

    with pytest.raises(ValueError) as ours:
        tfaults.parse_spec(spec)
    with pytest.raises(ValueError) as theirs:
        jfaults.parse_spec(spec)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=3)))
def test_injected_faults_carry_the_reference_message(flags):
    from spark_rapids_ml_tpu.robustness import faults as jfaults

    fatal, torn, oom = flags
    ours = tfaults.InjectedFault("ingest.device_put", 3, fatal=fatal, torn=torn, oom=oom)
    theirs = jfaults.InjectedFault("ingest.device_put", 3, fatal=fatal, torn=torn, oom=oom)
    assert str(ours) == str(theirs)
    assert tretry.is_oom_error(ours) is oom


def test_a_plan_fires_the_invocations_the_reference_fires():
    from spark_rapids_ml_tpu.robustness import faults as jfaults

    spec = "ingest.device_put=2@1; persistence.write=always@3:fatal"
    outcomes = []
    for mod in (tfaults, jfaults):
        with mod.inject(spec) as plan:
            seen = []
            for site in ["ingest.device_put"] * 5 + ["persistence.write"] * 5 + ["solver.segment"]:
                try:
                    mod.fault_point(site)
                    seen.append("ok")
                except mod.InjectedFault as exc:
                    seen.append((exc.site, exc.invocation, exc.fatal))
            outcomes.append((seen, plan.fired, plan.invocations("ingest.device_put"),
                             plan.invocations("solver.segment")))
    assert outcomes[0] == outcomes[1]


def test_env_spec_arms_without_code_changes(monkeypatch):
    monkeypatch.setenv("TPUML_FAULTS", "ingest.device_put=1")
    plan = tfaults.arm_from_env()
    assert plan is not None and tfaults.active_plan() is plan
    with pytest.raises(tfaults.InjectedFault):
        tfaults.fault_point("ingest.device_put")
    tfaults.fault_point("ingest.device_put")  # schedule spent
    monkeypatch.delenv("TPUML_FAULTS")
    tfaults.disarm()
    assert tfaults.arm_from_env() is None and tfaults.active_plan() is None


def test_inject_restores_the_previous_plan_and_disarmed_is_a_no_op():
    assert tfaults.fault_point("ingest.device_put") is None
    outer = tfaults.arm("persistence.write=1")
    with tfaults.inject("ingest.device_put=1") as inner:
        assert tfaults.active_plan() is inner
    assert tfaults.active_plan() is outer


def test_a_stall_freezes_until_disarmed():
    import threading

    tfaults.arm("ipc.recv=always:stall")
    done = threading.Event()
    t = threading.Thread(target=lambda: (tfaults.fault_point("ipc.recv"), done.set()), daemon=True)
    t.start()
    assert not done.wait(0.2)
    tfaults.disarm()
    assert done.wait(5.0)


# --- the retry policy ---------------------------------------------------------


def _errors(mod):
    return [ValueError("bug"), TypeError("bug"), KeyError("k"), IndexError("i"), AttributeError("a"),
            AssertionError("x"), NotImplementedError("n"), OSError("io"), RuntimeError("heartbeat lost"),
            TimeoutError("slow"), ConnectionError("reset"), mod.InjectedFault("s", 0),
            mod.InjectedFault("s", 0, fatal=True), mod.InjectedFault("s", 0, oom=True)]


def test_classification_is_the_reference_classification():
    from spark_rapids_ml_tpu.robustness import faults as jfaults
    from spark_rapids_ml_tpu.robustness import retry as jretry

    ours = [tretry.classify(e) for e in _errors(tfaults)]
    theirs = [jretry.classify(e) for e in _errors(jfaults)]
    assert ours == theirs
    assert ours[:7] == ["fatal"] * 7 and ours[-2] == "fatal"
    assert tretry.FATAL_TYPES == jretry.FATAL_TYPES


POLICIES = [dict(), dict(max_attempts=5, base_delay=0.1, max_delay=1.0), dict(base_delay=0.0),
            dict(max_attempts=8, base_delay=0.3, max_delay=0.5)]


@pytest.mark.parametrize("kw", POLICIES)
def test_backoff_is_the_reference_deterministic_jitter(kw):
    from spark_rapids_ml_tpu.robustness import retry as jretry

    ours, theirs = tretry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    for name in ("ingest.device_put", "persistence.write", "x", "collective.psum"):
        for attempt in range(1, 9):
            assert ours.backoff(name, attempt) == theirs.backoff(name, attempt)
    assert ours.backoff("x", 1) != ours.backoff("y", 1) or kw.get("base_delay", 0.05) == 0.0


@pytest.mark.parametrize("failures,attempts", [(0, 3), (1, 3), (2, 3), (3, 3), (4, 5), (0, 1), (1, 1)])
def test_attempts_and_counters_match_the_reference(failures, attempts):
    from spark_rapids_ml_tpu.robustness import retry as jretry
    from spark_rapids_ml_tpu.utils import tracing as jtracing

    outcomes = []
    for mod, tracing, tag in ((tretry, ttracing, "ours"), (jretry, jtracing, "theirs")):
        name = f"unit{failures}x{attempts}{tag}"
        tracing.clear_counters(f"retry.{name}")
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= failures:
                raise OSError("transient")
            return "ok"

        try:
            got = mod.RetryPolicy(max_attempts=attempts, base_delay=0).run(fn, name)
        except mod.RetryExhaustedError as exc:
            got = (exc.attempts, type(exc.__cause__).__name__, str(exc).split(":", 1)[1])
        outcomes.append((got, len(calls), tracing.counter_value(f"retry.{name}.attempts"),
                         tracing.counter_value(f"retry.{name}.exhausted")))
    assert outcomes[0] == outcomes[1]


def test_fatal_reraises_immediately():
    calls = []

    def fn():
        calls.append(1)
        raise ValueError("caller bug")

    with pytest.raises(ValueError, match="caller bug"):
        tretry.RetryPolicy(max_attempts=5, base_delay=0).run(fn, "t")
    assert len(calls) == 1


def test_deadline_matches_the_reference(monkeypatch):
    from spark_rapids_ml_tpu.robustness import retry as jretry

    def fn():
        raise OSError("slow")

    messages = []
    for mod in (tretry, jretry):
        clock = itertools.count()
        monkeypatch.setattr(mod.time, "monotonic", lambda: float(next(clock)))
        with pytest.raises(mod.RetryExhaustedError, match="deadline") as ei:
            mod.RetryPolicy(max_attempts=100, base_delay=0, deadline=3.0).run(fn, "slowpoke")
        messages.append((ei.value.attempts, str(ei.value)))
        monkeypatch.undo()
    assert messages[0] == messages[1]


def test_attempts_open_trace_ranges(monkeypatch):
    names = []
    real = ttracing.TraceRange

    class Recording(real):
        def __enter__(self):
            names.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(ttracing, "TraceRange", Recording)
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("once")
        return 1

    tretry.RetryPolicy(max_attempts=3, base_delay=0).run(fn, "traced")
    assert names == ["retry:traced#0", "retry:traced#1"]


def test_env_knobs_reach_the_policy_as_in_the_reference(monkeypatch):
    from spark_rapids_ml_tpu.robustness import retry as jretry
    from spark_rapids_ml_tpu.utils.envknobs import EnvKnobError as JEnvKnobError
    from spark_rapids_ml_tpu_torch.utils.envknobs import EnvKnobError

    monkeypatch.setenv("TPUML_RETRY_MAX_ATTEMPTS", "7")
    monkeypatch.setenv("TPUML_RETRY_DEADLINE", "12.5")
    monkeypatch.setenv("TPUML_RETRY_MAX_DELAY", "0.25")
    ours, theirs = tretry.default_policy(), jretry.default_policy()
    assert vars(ours) == vars(theirs) == {"max_attempts": 7, "base_delay": 0.0, "max_delay": 0.25,
                                          "deadline": 12.5}
    monkeypatch.setenv("TPUML_RETRY_MAX_ATTEMPTS", "many")
    with pytest.raises(EnvKnobError) as a:
        tretry.RetryPolicy.from_env()
    with pytest.raises(JEnvKnobError) as b:
        jretry.RetryPolicy.from_env()
    assert str(a.value) == str(b.value)


def test_on_retry_runs_between_attempts_only():
    seen = []

    def fn():
        raise OSError("x")

    with pytest.raises(tretry.RetryExhaustedError):
        tretry.RetryPolicy(max_attempts=3, base_delay=0).run(fn, "hook", on_retry=lambda a, e: seen.append(a))
    assert seen == [0, 1]


def test_a_failed_attempt_frees_what_it_held():
    """What an attempt allocated dies with it: the policy clears the failed
    attempts' frames, so exhaustion holds none of their locals."""
    refs = []

    class Placed:
        pass

    def fn():
        placed = Placed()
        refs.append(weakref.ref(placed))
        raise OSError("after placing")

    with pytest.raises(tretry.RetryExhaustedError) as ei:
        tretry.RetryPolicy(max_attempts=3, base_delay=0).run(fn, "frees")
    gc.collect()
    assert ei.value.attempts == 3 and len(refs) == 3
    assert all(r() is None for r in refs)


def test_an_exhausted_fit_frees_what_it_allocated_without_a_collection(data, monkeypatch):
    """No reference cycle keeps a failed fit's tensors: once the caller
    has handled the error they are gone, before any garbage collection
    (on the card, the device memory comes back at once)."""
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.linalg import row_matrix

    refs = []
    real = row_matrix.welford_init

    def spy(*args, **kwargs):
        state = real(*args, **kwargs)
        refs.append(weakref.ref(state[1]))
        return state

    monkeypatch.setattr(row_matrix, "welford_init", spy)
    gc.disable()
    try:
        with tfaults.inject("ingest.device_put=always"):
            try:
                PCA().setK(2).fit(data)
            except tretry.RetryExhaustedError:
                pass
        assert len(refs) == 1 and refs[0]() is None
    finally:
        gc.enable()


# --- the ingest site ----------------------------------------------------------


def _kmeans_warm(pkg, x):
    if pkg == "port":
        from spark_rapids_ml_tpu_torch.clustering import KMeans
    else:
        from spark_rapids_ml_tpu.models.kmeans import KMeans
    cold = KMeans().setK(3).setMaxIter(2).setSeed(7).fit(x)
    warm = KMeans().setK(3).setMaxIter(5).setSeed(7).setInitialModel(cold).fit(x)
    return warm, (np.asarray(warm.clusterCenters()).tobytes(),)


def _logistic(pkg, x):
    if pkg == "port":
        from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    else:
        from spark_rapids_ml_tpu.models.logistic_regression import LogisticRegression
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
    m = LogisticRegression().setMaxIter(40).fit((x, y))
    return m, (np.asarray(m.coefficients).tobytes(), np.asarray(m.intercept).tobytes())


def _pca(pkg, x):
    if pkg == "port":
        from spark_rapids_ml_tpu_torch.feature import PCA
    else:
        from spark_rapids_ml_tpu.models.pca import PCA
    m = PCA().setK(2).fit(x)
    return m, (np.asarray(m.pc).tobytes(), np.asarray(m.explainedVariance).tobytes())


FITS = {"kmeans_warm": _kmeans_warm, "logistic": _logistic, "pca": _pca}


def _jax_inject(spec):
    from spark_rapids_ml_tpu.robustness.faults import inject

    return inject(spec)


@pytest.mark.parametrize("family", ["kmeans_warm", "logistic"])
def test_ingest_fail_first_then_bitwise(family, data):
    _, want = FITS[family]("port", data)
    with tfaults.inject("ingest.device_put=1") as plan:
        _, got = FITS[family]("port", data)
    with _jax_inject("ingest.device_put=1") as jplan:
        FITS[family]("jax", data)
    assert plan.fired == jplan.fired == [("ingest.device_put", 0)]
    assert got == want


@pytest.mark.parametrize("family", ["kmeans_warm", "logistic"])
def test_ingest_exhaustion_is_one_classified_error(family, data):
    from spark_rapids_ml_tpu.robustness import retry as jretry

    with tfaults.inject("ingest.device_put=always") as plan:
        with pytest.raises(tretry.RetryExhaustedError) as ei:
            FITS[family]("port", data)
    with _jax_inject("ingest.device_put=always") as jplan:
        with pytest.raises(jretry.RetryExhaustedError) as ej:
            FITS[family]("jax", data)
    assert isinstance(ei.value.__cause__, tfaults.InjectedFault)
    assert ei.value.attempts == ej.value.attempts == 3
    assert plan.fired == jplan.fired


def test_a_fatal_ingest_fault_is_not_retried(data):
    with tfaults.inject("ingest.device_put=always:fatal") as plan:
        with pytest.raises(tfaults.InjectedFault):
            FITS["kmeans_warm"]("port", data)
    assert plan.invocations("ingest.device_put") == 1


def test_an_ingest_oom_reclaims_before_the_next_attempt(data):
    _, want = FITS["logistic"]("port", data)
    before = ttracing.counter_value("fit.oom.reclaims")
    with tfaults.inject("ingest.device_put=1:oom") as plan:
        _, got = FITS["logistic"]("port", data)
    assert plan.fired == [("ingest.device_put", 0)] and got == want
    assert ttracing.counter_value("fit.oom.reclaims") == before + 1


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_pca_partition_uploads_recover_bitwise(data, backend):
    """PCA's host partitions upload through the guarded placement (one
    site per partition and pass): two faults are retried away."""
    from spark_rapids_ml_tpu_torch.feature import PCA

    def fit():
        m = PCA().setK(2).setCovarianceBackend(backend).fit([data[:50], data[50:]])
        return m.pc.tobytes(), m.explainedVariance.tobytes()

    want = fit()
    ttracing.clear_counters("retry.ingest")
    with tfaults.inject("ingest.device_put=2") as plan:
        got = fit()
    assert got == want and plan.fired == [("ingest.device_put", 0), ("ingest.device_put", 1)]
    assert ttracing.counter_value("retry.ingest.device_put.attempts") == plan.invocations("ingest.device_put")


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("source", ["partitions", "tensor"])
def test_mesh_placement_is_one_retry_unit(data, shape, source):
    from spark_rapids_ml_tpu_torch.core.ingest import prepare_rows
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shape, devices=[torch.device("cpu")] * 8)
    rows = [data[:70], data[70:]] if source == "partitions" else torch.from_numpy(data)
    want = prepare_rows(rows, mesh=mesh, dtype=torch.float64).x.numpy()
    with tfaults.inject("ingest.device_put=2") as plan:
        got = prepare_rows(rows, mesh=mesh, dtype=torch.float64).x.numpy()
    assert plan.invocations("ingest.device_put") == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with tfaults.inject("ingest.device_put=always"):
        with pytest.raises(tretry.RetryExhaustedError):
            prepare_rows(rows, mesh=mesh, dtype=torch.float64)


def test_a_stream_oom_halves_the_block_rows_once(monkeypatch, data):
    """``solver.segment=1:oom``: a degraded streaming KMeans fit whose
    first pass meets the injected OOM retries at half the block rows, as
    the reference's does."""
    from spark_rapids_ml_tpu.models.kmeans import KMeans as JKMeans
    from spark_rapids_ml_tpu.utils import tracing as jtracing
    from spark_rapids_ml_tpu_torch.clustering import KMeans

    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1000")
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "64")
    out = []
    for est, mod, tracing in ((KMeans, tfaults, ttracing), (JKMeans, None, jtracing)):
        before = tracing.counter_value("fit.oom.block_halved")
        with (mod.inject if mod else _jax_inject)("solver.segment=1:oom"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                model = est().setK(3).setSeed(7).fit(data)
        out.append((tracing.counter_value("fit.oom.block_halved") - before, model.clusterCenters().shape))
    assert out[0] == out[1] == (1, (3, data.shape[1]))
    with tfaults.inject("solver.segment=always:oom"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            from spark_rapids_ml_tpu_torch.core.membudget import FitMemoryError

            with pytest.raises(FitMemoryError) as ei:
                KMeans().setK(3).setSeed(7).fit(data)
    assert tretry.is_oom_error(ei.value.__cause__)


# --- the persistence site -------------------------------------------------------


def _state_bytes(model):
    if hasattr(model, "pc"):
        return [model.pc.tobytes(), model.explainedVariance.tobytes()]
    if hasattr(model, "clusterCenters"):
        return [np.asarray(model.clusterCenters()).tobytes()]
    return [np.asarray(model.coefficients).tobytes(), np.asarray(model.intercept).tobytes()]


@pytest.mark.parametrize("family", sorted(FITS))
def test_persistence_fail_first_then_roundtrip_bitwise(family, data, tmp_path):
    model, _ = FITS[family]("port", data)
    path = str(tmp_path / "m")
    with tfaults.inject("persistence.write=1") as plan:
        model.write.overwrite().save(path)
    assert plan.fired == [("persistence.write", 0)]
    assert _state_bytes(type(model).load(path)) == _state_bytes(model)


def test_persistence_exhaustion_leaves_no_artifact(data, tmp_path):
    model, _ = FITS["pca"]("port", data)
    path = str(tmp_path / "m")
    with tfaults.inject("persistence.write=always"):
        with pytest.raises(tretry.RetryExhaustedError) as ei:
            model.write.save(path)
    assert ei.value.attempts == 3
    assert not os.path.exists(path)
    assert glob.glob(str(tmp_path / ".*tmp-save*")) == []


def test_a_save_killed_midway_is_invisible_to_load(data, tmp_path):
    model, _ = FITS["pca"]("port", data)
    path = str(tmp_path / "m")
    with tfaults.inject("persistence.write=always:fatal") as plan:
        with pytest.raises(tfaults.InjectedFault):
            model.write.save(path)
    assert plan.invocations("persistence.write") == 1
    assert not os.path.exists(path)
    with pytest.raises(FileNotFoundError):
        type(model).load(path)


def test_a_failed_overwrite_keeps_the_previous_model(data, tmp_path):
    model, _ = FITS["pca"]("port", data)
    path = str(tmp_path / "m")
    model.write.save(path)
    before = _state_bytes(type(model).load(path))
    with tfaults.inject("persistence.write=always"):
        with pytest.raises(tretry.RetryExhaustedError):
            model.write.overwrite().save(path)
    assert _state_bytes(type(model).load(path)) == before


def test_a_saved_model_loads_in_the_reference_after_a_retried_write(data, tmp_path):
    from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JKMeansModel

    model, _ = FITS["kmeans_warm"]("port", data)
    path = str(tmp_path / "m")
    with tfaults.inject("persistence.write=2"):
        model.write.save(path)
    np.testing.assert_array_equal(np.asarray(JKMeansModel.load(path).clusterCenters()), model.clusterCenters())


def test_atomic_file_write_replaces_whole_files(tmp_path):
    from spark_rapids_ml_tpu_torch.core.persistence import atomic_file_write

    path = str(tmp_path / "f.bin")
    atomic_file_write(path, b"first")
    atomic_file_write(path, b"second")
    assert open(path, "rb").read() == b"second"
    assert sorted(os.listdir(tmp_path)) == ["f.bin"]


# --- the initialize and collective sites ---------------------------------------


@pytest.fixture
def mocked_bringup(monkeypatch):
    calls = []
    monkeypatch.setattr(tdist, "_initialized", False)
    monkeypatch.setattr(tdist, "_init_record", None)
    monkeypatch.setattr(tdist.dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


@pytest.fixture
def mocked_jax_bringup(monkeypatch):
    import jax

    from spark_rapids_ml_tpu.parallel import distributed as jdist

    calls = []
    monkeypatch.setattr(jdist, "_initialized", False)
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls.append(kw))
    return jdist, calls


def test_initialize_fail_first_then_initialized(mocked_bringup, mocked_jax_bringup):
    jdist, jcalls = mocked_jax_bringup
    with tfaults.inject("distributed.initialize=1") as plan:
        tdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1)
    with _jax_inject("distributed.initialize=1") as jplan:
        jdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1)
    assert plan.fired == jplan.fired == [("distributed.initialize", 0)]
    assert len(mocked_bringup) == len(jcalls) == 1
    assert (mocked_bringup[0]["world_size"], mocked_bringup[0]["rank"]) == (2, 1)
    assert tdist._initialized


def test_initialize_exhaustion_leaves_uninitialized(mocked_bringup, mocked_jax_bringup):
    from spark_rapids_ml_tpu.robustness import retry as jretry

    jdist, jcalls = mocked_jax_bringup
    with tfaults.inject("distributed.initialize=always"):
        with pytest.raises(tretry.RetryExhaustedError) as ei:
            tdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1)
    with _jax_inject("distributed.initialize=always"):
        with pytest.raises(jretry.RetryExhaustedError) as ej:
            jdist.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=1)
    assert isinstance(ei.value.__cause__, tfaults.InjectedFault)
    assert str(ei.value) == str(ej.value)
    assert mocked_bringup == jcalls == [] and tdist._initialized is False


def test_the_psum_merge_in_one_process_recovers_as_the_reference(monkeypatch):
    """The reference's single-process case on its 8-device mesh beside the
    port's process-local merge: both recover bitwise from one fault, both
    exhaust into one classified error."""
    from spark_rapids_ml_tpu.parallel import distributed as jdist
    from spark_rapids_ml_tpu.parallel.mesh import make_mesh as jmesh
    from spark_rapids_ml_tpu.robustness import retry as jretry

    blocks = _gang_blocks(0)
    mesh = tdist.global_mesh()
    jm = jmesh((8, 1))

    def ours():
        mean, cov, n = tdist.streaming_covariance_process_local(iter(blocks), mesh=mesh, merge="psum")
        return mean.tobytes(), cov.tobytes(), n

    def theirs():
        mean, cov, n = jdist.streaming_covariance_process_local(iter(blocks), mesh=jm, merge="psum")
        return np.asarray(mean), np.asarray(cov), n

    want, jwant = ours(), theirs()
    with tfaults.inject("collective.psum=1") as plan:
        got = ours()
    with _jax_inject("collective.psum=1") as jplan:
        jgot = theirs()
    assert got == want and plan.fired == jplan.fired == [("collective.psum", 0)]
    np.testing.assert_allclose(np.frombuffer(got[1]).reshape(6, 6), jgot[1], rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(jgot[1], jwant[1])
    with tfaults.inject("collective.psum=always"):
        with pytest.raises(tretry.RetryExhaustedError) as ei:
            ours()
    with _jax_inject("collective.psum=always"):
        with pytest.raises(jretry.RetryExhaustedError) as ej:
            theirs()
    assert str(ei.value) == str(ej.value)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_gloo_gang_retries_bringup_and_the_psum_merge_in_lockstep(tmp_path):
    port = _free_port()
    out = str(tmp_path / "gang")
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "gang", str(port), out],
            env=tdist.member_env(rank, WORLD, base={**os.environ, "JAX_PLATFORMS": "cpu"}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO),
        )
        for rank in range(WORLD)
    ]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{stderr[-3000:]}"
        assert f"OK rank {rank}/{WORLD}" in stdout, stdout
    results = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(WORLD)]
    for key in results[0]:
        np.testing.assert_array_equal(results[0][key], results[1][key], err_msg=key)
    r = results[0]
    assert int(r["init_fired"]) == 0 and int(r["init_count"]) == 1
    assert r["psum_fired"].tolist() == [["collective.psum", "0"]]
    for key in ("mean", "cov"):
        np.testing.assert_array_equal(r[f"{key}_rec"], r[key])
        np.testing.assert_array_equal(r[f"{key}_after"], r[key])
    assert str(r["exhausted"]) == "3 InjectedFault"
    assert r["n"].tolist() == [240, 240]
    rows = np.concatenate([b for rank in range(WORLD) for b in _gang_blocks(rank)])
    np.testing.assert_allclose(r["cov"], np.cov(rows, rowvar=False), rtol=1e-10, atol=1e-12)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
