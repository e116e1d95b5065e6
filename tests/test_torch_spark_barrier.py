"""The port's barrier-stage gang runs (``spark_rapids_ml_tpu_torch/spark/
barrier.py``) under the pyspark stub.

Port twins of the reference's barrier tests, each driving the port's
``barrier_gang_run`` / ``gang_fit`` and the port's estimators:

- ``TestBarrierSiteRecovery`` (``tests/test_chaos.py``): a member failed
  at ``barrier.attempt`` on attempt 0 relaunches the gang and refits
  bitwise; an exhausted budget is one ``RetryExhaustedError`` whose cause
  is the injected fault; ``TPUML_BARRIER_RESUBMITS`` resubmits the stage.
  ``TPUML_DEGRADE=cpu`` is refused (the reference degrades to a
  driver-local run; the port has no fallback stage).
- ``TestElasticGangResume`` (``tests/test_checkpoint.py``): a gang killed
  mid-solve resumes from the shared checkpoint dir, bitwise.
- ``TestStubGangTrace`` (``tests/test_tracing_gang.py``) and the barrier
  heartbeat case of ``tests/test_observability.py``: one merged trace,
  heartbeats from both members, no stale gauges.
- ``TestBarrierGangRecovery`` and ``TestGangFitPublicAPI``
  (``tests/spark_contract_suite.py``), through the port's modules.
- ``serving_gang_run`` serves a one-member barrier gang behind a
  ``RoutingRuntime(launch="barrier")`` (``tests/test_serving_router.py``'s
  ``TestBarrierLaunch``).
"""

import json
import os
import time
import uuid

import numpy as np
import pytest

import spark_contract_suite as suite
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.observability import events
from spark_rapids_ml_tpu_torch.observability import trace as tracelib
from spark_rapids_ml_tpu_torch.observability.metrics import default_registry
from spark_rapids_ml_tpu_torch.robustness import InjectedFault, RetryExhaustedError, inject
from spark_rapids_ml_tpu_torch.robustness.checkpoint import DIR_ENV, EVERY_ENV
from spark_rapids_ml_tpu_torch.robustness.faults import disarm
from spark_rapids_ml_tpu_torch.spark.barrier import _gang_extract, barrier_gang_run, gang_coordinates, gang_fit
from spark_rapids_ml_tpu_torch.utils import tracing
from spark_rapids_ml_tpu_torch.utils.envknobs import env_int
from spark_rapids_ml_tpu_torch.utils.tracing import clear_counters, counter_value
from test_torch_spark_adapter import install_stub

pytestmark = pytest.mark.spark


@pytest.fixture(scope="module")
def stub_spark():
    undo = install_stub()
    try:
        from pyspark.sql import SparkSession

        yield SparkSession.builder.master("local[2]").getOrCreate()
    finally:
        undo()


@pytest.fixture(autouse=True)
def cpu_and_fast_retries(monkeypatch):
    port_device.set_platform("cpu")
    monkeypatch.setenv("TPUML_RETRY_BASE_DELAY", "0")
    for name in ("TPUML_FAULTS", "TPUML_DEGRADE", "TPUML_BARRIER_RESUBMITS", DIR_ENV, EVERY_ENV):
        monkeypatch.delenv(name, raising=False)
    yield
    disarm()
    port_device.set_platform("cuda")


@pytest.fixture
def telemetry(tmp_path, monkeypatch):
    d = tmp_path / "telemetry"
    monkeypatch.setenv(events.TELEMETRY_DIR_ENV, str(d))
    events.configure()
    try:
        yield d
    finally:
        monkeypatch.delenv(events.TELEMETRY_DIR_ENV)
        events.configure()


@pytest.fixture
def event_log(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv(events.EVENT_LOG_ENV, str(path))
    events.configure()
    try:
        yield path
    finally:
        monkeypatch.delenv(events.EVENT_LOG_ENV)
        events.configure()


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


# --- barrier.attempt (tests/test_chaos.py) ---------------------------------


def _moments_task(ctx, it):
    xs = [np.asarray(r.features.toArray(), dtype=float) for r in it]
    x = np.asarray(xs)
    yield x.T @ x


def _moments_gang(spark, x):
    df = suite._vector_df(spark, x, n_parts=2)
    return sum(barrier_gang_run(df.select("features").rdd, _moments_task))


class TestBarrierSiteRecovery:
    def test_fail_first_then_bit_identical(self, stub_spark, rng):
        x = rng.normal(size=(80, 4))
        want = _moments_gang(stub_spark, x)
        with inject("barrier.attempt=1") as plan:
            got = _moments_gang(stub_spark, x)
        assert plan.fired == [("barrier.attempt", 0)]
        assert got.tobytes() == want.tobytes()

    def test_exhaustion_is_one_classified_error(self, stub_spark, rng):
        x = rng.normal(size=(40, 4))
        with inject("barrier.attempt=always"):
            with pytest.raises(RetryExhaustedError) as ei:
                _moments_gang(stub_spark, x)
        assert isinstance(ei.value.__cause__, InjectedFault)

    def test_stage_resubmit_knob(self, stub_spark, rng, monkeypatch):
        from pyspark.sql import BARRIER_MAX_ATTEMPTS

        x = rng.normal(size=(40, 4))
        monkeypatch.setenv("TPUML_BARRIER_RESUBMITS", "2")
        clear_counters("gang")
        with inject(f"barrier.attempt={BARRIER_MAX_ATTEMPTS}") as plan:
            got = _moments_gang(stub_spark, x)
        assert plan.invocations("barrier.attempt") > BARRIER_MAX_ATTEMPTS
        assert counter_value("gang.resubmit") == 1
        assert got.tobytes() == _moments_gang(stub_spark, x).tobytes()

    def test_degrade_to_a_driver_local_run_is_refused(self, stub_spark, rng, monkeypatch):
        x = rng.normal(size=(40, 4))
        monkeypatch.setenv("TPUML_DEGRADE", "cpu")
        with pytest.raises(NotImplementedError, match="barrier gang fit"):
            _moments_gang(stub_spark, x)


# --- elastic resume (tests/test_checkpoint.py) -------------------------------


class TestElasticGangResume:
    @staticmethod
    def _gang_fit(spark, x, ckdir):
        from spark_rapids_ml_tpu_torch.clustering import KMeans

        df = suite._vector_df(spark, x, n_parts=2)

        def task(ctx, it):
            rows = np.asarray([np.asarray(r.features.toArray(), dtype=float) for r in it])
            m = KMeans(uid="ck-gang").setK(5).setMaxIter(12).setTol(0.0).setSeed(1).fit(rows)
            yield np.asarray(m.clusterCenters())

        return barrier_gang_run(df.select("features").rdd, task, checkpoint_dir=ckdir)

    def test_gang_kill_resumes_from_checkpoint(self, stub_spark, rng, tmp_path, monkeypatch):
        ckdir = str(tmp_path / "ckpts")
        monkeypatch.setenv(EVERY_ENV, "2")
        x = rng.normal(size=(160, 5))
        want = [p.tobytes() for p in self._gang_fit(stub_spark, x, ckdir)]
        clear_counters("checkpoint")
        # Transient faults kill both tasks of attempt 0 mid-solve; the
        # stub's stage retry relaunches the whole gang.
        with inject("checkpoint.segment=3") as plan:
            got = [p.tobytes() for p in self._gang_fit(stub_spark, x, ckdir)]
        assert len(plan.fired) == 3
        assert got == want
        assert counter_value("checkpoint.restore") >= 1
        assert counter_value("checkpoint.restore.steps") >= 1
        assert DIR_ENV not in os.environ  # exported for the tasks' lifetime only


# --- one trace, heartbeats (tests/test_tracing_gang.py, test_observability.py)


class TestStubGangTrace:
    def test_gang_fit_assembles_into_one_trace(self, telemetry, stub_spark, monkeypatch):
        monkeypatch.setenv("TPUML_GANG_HEARTBEAT_EVERY", "0.02")
        df = stub_spark.createDataFrame([(float(i),) for i in range(8)], ["v"], numPartitions=2)

        def task(ctx, it):
            with tracing.TraceRange("member compute"):
                time.sleep(0.05)
                return [sum(r.v for r in it)]

        out = barrier_gang_run(df.rdd, task)
        assert sum(out) == sum(range(8))
        events.flush_telemetry()

        merged = tracelib.assemble(str(telemetry))
        assert merged["problems"] == []
        assert merged["orphan_problems"] == []
        assert len(merged["traces"]) == 1
        (cell,) = merged["traces"].values()
        assert cell["orphans"] == []
        assert cell["spans"] >= 3  # barrier gang + 2 member computes
        names = {s["name"] for s in merged["trace_cells"][cell["trace_id"]]["spans"]}
        assert {"barrier gang", "member compute"} <= names
        assert cell["critical_path"]
        beats = [r for r in merged["trace_cells"][cell["trace_id"]]["events"] if r["event"] == "heartbeat"]
        assert {r["process"] for r in beats} == {0, 1}

    def test_completed_gang_leaves_no_stale_heartbeat_gauges(self, telemetry, stub_spark, monkeypatch):
        monkeypatch.setenv("TPUML_GANG_HEARTBEAT_EVERY", "0.02")
        df = stub_spark.createDataFrame([(float(i),) for i in range(4)], ["v"], numPartitions=2)
        barrier_gang_run(df.rdd, lambda ctx, it: [sum(r.v for r in it)])
        stale = [name for name in default_registry.snapshot()["gauges"]
                 if name.startswith("gang.heartbeat.age_seconds")]
        assert stale == []

    def test_barrier_worker_heartbeats(self, event_log, stub_spark, monkeypatch):
        monkeypatch.setenv("TPUML_GANG_HEARTBEAT_EVERY", "0.01")
        df = stub_spark.createDataFrame([(float(i),) for i in range(4)], ["v"], numPartitions=2)

        def task(ctx, it):
            time.sleep(0.05)
            return [sum(r.v for r in it)]

        out = barrier_gang_run(df.rdd, task)
        assert sum(out) == sum(range(4))
        beats = [r for r in _records(event_log) if r["event"] == "heartbeat"]
        assert beats and all(r["what"] == "barrier" for r in beats)
        assert {r["process"] for r in beats} == {0, 1}


# --- the contract suite's barrier classes, through the port ----------------


class TestBarrierGangRecovery:
    """A partition task killed on its first attempt relaunches the WHOLE
    gang and the refit is correct (the suite's class, on the port)."""

    @staticmethod
    def _moments_task(sentinel, log_dir, fail_pid):
        def task(ctx, it):
            pid = 0 if ctx is None else ctx.partitionId()
            with open(os.path.join(log_dir, f"launches_p{pid}"), "a") as fh:
                fh.write("launch\n")
            xs, ys = [], []
            for r in it:
                xs.append(np.asarray(r.features.toArray(), dtype=float))
                ys.append(float(r.label))
            xs, ys = np.asarray(xs), np.asarray(ys)
            if pid == fail_pid and not os.path.exists(sentinel):
                open(sentinel, "w").close()
                raise RuntimeError("injected device failure mid-fit")
            yield (xs.T @ xs, xs.T @ ys)

        return task

    @staticmethod
    def _launch_counts(log_dir, n_parts):
        counts = []
        for pid in range(n_parts):
            p = os.path.join(log_dir, f"launches_p{pid}")
            counts.append(sum(1 for _ in open(p)) if os.path.exists(p) else 0)
        return counts

    def test_task_failure_relaunches_gang_and_refits(self, stub_spark, rng, tmp_path):
        n, d = 200, 4
        x = rng.normal(size=(n, d))
        y = x @ rng.normal(size=d) + 0.01 * rng.normal(size=n)
        df = suite._vector_df(stub_spark, x, extra={"label": list(y)}, n_parts=2)
        task = self._moments_task(str(tmp_path / "fault_fired"), str(tmp_path), fail_pid=1)
        parts = barrier_gang_run(df.select("features", "label").rdd, task)
        w_fit = np.linalg.solve(sum(p[0] for p in parts), sum(p[1] for p in parts))
        np.testing.assert_allclose(w_fit, np.linalg.lstsq(x, y, rcond=None)[0], atol=1e-8)
        assert os.path.exists(str(tmp_path / "fault_fired"))
        counts = self._launch_counts(str(tmp_path), 2)
        assert counts[1] >= 2 and counts[0] >= 2, counts

    def test_persistent_failure_escalates_to_driver(self, stub_spark, rng, tmp_path):
        from pyspark.sql import BARRIER_MAX_ATTEMPTS

        x = rng.normal(size=(40, 3))
        df = suite._vector_df(stub_spark, x, extra={"label": list(x[:, 0])}, n_parts=2)
        log_dir = str(tmp_path)

        def always_fails(ctx, it):
            pid = 0 if ctx is None else ctx.partitionId()
            with open(os.path.join(log_dir, f"launches_p{pid}"), "a") as fh:
                fh.write("launch\n")
            raise RuntimeError("unrecoverable injected failure")
            yield  # pragma: no cover - generator marker

        with pytest.raises(RetryExhaustedError):
            barrier_gang_run(df.select("features", "label").rdd, always_fails)
        assert self._launch_counts(log_dir, 1)[0] == BARRIER_MAX_ATTEMPTS

    def test_gang_relaunch_instrumentation_stub(self, stub_spark, rng, tmp_path):
        from pyspark.sql import BARRIER_TASK_LAUNCHES

        x = rng.normal(size=(60, 3))
        df = suite._vector_df(stub_spark, x, extra={"label": list(x[:, 0])}, n_parts=2)
        BARRIER_TASK_LAUNCHES.clear()
        task = self._moments_task(str(tmp_path / "fault2"), str(tmp_path), fail_pid=0)
        barrier_gang_run(df.select("features", "label").rdd, task)
        assert BARRIER_TASK_LAUNCHES == [(0, 0), (1, 0), (1, 1)]

    def test_gang_coordinates_derivation(self, stub_spark, rng):
        df = suite._vector_df(stub_spark, rng.normal(size=(40, 3)), n_parts=2)

        def task(ctx, it):
            list(it)
            if ctx is None:
                return
            yield gang_coordinates(ctx)

        coords = barrier_gang_run(df.select("features").rdd, task)
        assert {c["process_id"] for c in coords} == {0, 1}
        assert all(c["num_processes"] == 2 for c in coords)
        assert len({c["coordinator_address"] for c in coords}) == 1
        assert coords[0]["coordinator_address"].endswith(":8476")

    def test_relaunched_gang_gets_fresh_coordinator_port(self, stub_spark, rng, tmp_path):
        df = suite._vector_df(stub_spark, rng.normal(size=(40, 3)), n_parts=2)
        sentinel = str(tmp_path / "port_fault")
        log_dir = str(tmp_path)

        def task(ctx, it):
            list(it)
            if ctx is None:
                return
            coords = gang_coordinates(ctx)
            with open(os.path.join(log_dir, f"addr_a{ctx.attemptNumber()}_p{ctx.partitionId()}"), "w") as fh:
                fh.write(coords["coordinator_address"])
            if not os.path.exists(sentinel):
                open(sentinel, "w").close()
                raise RuntimeError("injected failure on the first attempt")
            yield coords

        coords = barrier_gang_run(df.select("features").rdd, task)
        with open(os.path.join(log_dir, "addr_a0_p0")) as fh:
            addr0 = fh.read()
        (addr1,) = {c["coordinator_address"] for c in coords}
        host0, _, port0 = addr0.rpartition(":")
        host1, _, port1 = addr1.rpartition(":")
        assert host1 == host0 and int(port1) == int(port0) + 1


class _UidProbe:
    """An estimator stand-in: ``copy`` draws a fresh uid, as a Params
    copy does, and ``fit`` returns the uid its member fitted under and the
    gang size the member saw."""

    def __init__(self, uid):
        self.uid = uid

    def copy(self):
        return _UidProbe(f"{type(self).__name__}_{uuid.uuid4().hex[:12]}")

    def setDeployMode(self, mode):
        return self

    def fit(self, local):
        return self.uid, env_int("TPUML_NUM_PROCESSES")


class TestGangFitPublicAPI:
    """``gang_fit``: single-member gangs through the port's public fit
    with ``deployMode='gang'`` (the member fits on a (1, 1) mesh), equal
    to the single-process fit to 1e-12, as in the suite; and which
    members keep the estimator's uid."""

    def test_gang_fit_linear_matches_single_process(self, stub_spark, rng):
        from spark_rapids_ml_tpu_torch.regression import LinearRegression

        n, d = 120, 5
        x = rng.normal(size=(n, d))
        y = x @ rng.normal(size=d) + 0.01 * rng.normal(size=n)
        df = suite._vector_df(stub_spark, x, extra={"label": list(y)}, n_parts=1)
        models = gang_fit(LinearRegression(), df.select("features", "label").rdd, labeled=True)
        assert len(models) == 1
        ref = LinearRegression().fit((x, y))
        np.testing.assert_allclose(models[0].coefficients, ref.coefficients, atol=1e-12, rtol=0)
        np.testing.assert_allclose(models[0].intercept, ref.intercept, atol=1e-12, rtol=0)

    def test_gang_fit_pca_merged_trace_strict_clean(self, stub_spark, rng, tmp_path, monkeypatch):
        from spark_rapids_ml_tpu_torch.feature import PCA

        telemetry = tmp_path / "telemetry"
        monkeypatch.setenv(events.TELEMETRY_DIR_ENV, str(telemetry))
        events.configure()
        try:
            x = rng.normal(size=(90, 6)) * np.linspace(1, 2, 6)
            df = suite._vector_df(stub_spark, x, n_parts=1)
            models = gang_fit(PCA().setK(2), df.select("features").rdd)
            events.flush_telemetry()
        finally:
            monkeypatch.delenv(events.TELEMETRY_DIR_ENV)
            events.configure()
        ref = PCA().setK(2).fit([x])
        np.testing.assert_allclose(np.asarray(models[0].pc), np.asarray(ref.pc), atol=1e-12, rtol=0)
        merged = tracelib.assemble(str(telemetry))
        assert merged["problems"] == [] and merged["orphan_problems"] == []
        assert len(merged["traces"]) == 1
        (cell,) = merged["traces"].values()
        recs = merged["trace_cells"][cell["trace_id"]]
        assert "barrier gang" in {s["name"] for s in recs["spans"]}
        assert any(r.get("action") == "join" for r in recs["events"] if r["event"] == "gang_fit")

    def test_gang_fit_relaunches_whole_stage_and_refits(self, stub_spark, rng, tmp_path):
        from spark_rapids_ml_tpu_torch.regression import LinearRegression

        n, d = 100, 4
        x = rng.normal(size=(n, d))
        y = x @ rng.normal(size=d)
        df = suite._vector_df(stub_spark, x, extra={"label": list(y)}, n_parts=1)
        sentinel = str(tmp_path / "gang_fit_fault")

        def extract(it):
            if not os.path.exists(sentinel):
                open(sentinel, "w").close()
                raise RuntimeError("injected member death mid-extract")
            return _gang_extract(it, labeled=True)

        models = gang_fit(LinearRegression(), df.select("features", "label").rdd, extract=extract)
        assert os.path.exists(sentinel)
        ref = LinearRegression().fit((x, y))
        np.testing.assert_allclose(models[0].coefficients, ref.coefficients, atol=1e-12, rtol=0)

    def test_a_checkpointed_gang_fit_killed_mid_solve_resumes(self, stub_spark, rng, tmp_path, monkeypatch):
        """The member keeps the estimator's uid (a copy would draw a new
        one each attempt and never find its snapshots): a fault at the
        third segment boundary relaunches the stage, and the refit
        resumes to the uninterrupted result."""
        from spark_rapids_ml_tpu_torch.regression import LinearRegression

        x = rng.normal(size=(400, 6)) * np.linspace(0.5, 4.0, 6) + 2.0
        y = x @ np.linspace(-1.0, 1.0, 6) + 0.1 * rng.normal(size=400)
        rdd = suite._vector_df(stub_spark, x, extra={"label": list(y)}, n_parts=1).select("features", "label").rdd
        monkeypatch.setenv(EVERY_ENV, "2")

        def enet():
            return LinearRegression(uid="gang-enet").setRegParam(0.1).setElasticNetParam(0.5)

        (whole,) = gang_fit(enet(), rdd, labeled=True, checkpoint_dir=str(tmp_path / "whole"))
        clear_counters("checkpoint")
        with inject("checkpoint.segment=1@2") as plan:
            (resumed,) = gang_fit(enet(), rdd, labeled=True, checkpoint_dir=str(tmp_path / "kill"))
        assert plan.fired == [("checkpoint.segment", 2)]
        assert counter_value("checkpoint.restore") == 1
        assert counter_value("checkpoint.restore.steps") == 6
        assert resumed.uid == whole.uid == "gang-enet"
        assert resumed.coefficients.tobytes() == whole.coefficients.tobytes()
        assert resumed.intercept == whole.intercept

    @pytest.mark.parametrize("parts", [1, 2])
    def test_only_a_gang_of_one_keeps_the_estimators_uid(self, stub_spark, rng, parts):
        """A checkpoint's snapshots are named by step alone under uid +
        param hash, so members of a larger gang that shared the uid would
        overwrite each other's in the shared checkpoint dir and could
        restore different steps: they draw fresh uids and refit from the
        start, and only a gang of one resumes."""
        df = suite._vector_df(stub_spark, rng.normal(size=(40, 3)), n_parts=parts)
        got = gang_fit(_UidProbe("gang-est"), df.select("features").rdd)
        assert [n for _, n in got] == ([None] if parts == 1 else [2, 2])
        uids = [u for u, _ in got]
        if parts == 1:
            assert uids == ["gang-est"]
        else:
            assert "gang-est" not in uids and len(set(uids)) == 2

    def test_gang_fit_logistic_is_bitwise_its_mesh_fit(self, stub_spark, rng):
        """The adapter's logistic route: the member's gang fit equals the
        port's own fit on a (1, 1) mesh of the same rows, bit for bit."""
        from spark_rapids_ml_tpu_torch.classification import LogisticRegression
        from spark_rapids_ml_tpu_torch.parallel.distributed import global_mesh

        x = rng.normal(size=(150, 4))
        y = (x[:, 0] - 0.5 * x[:, 2] > 0).astype(float)
        df = suite._vector_df(stub_spark, x, extra={"label": list(y)}, n_parts=1)
        (model,) = gang_fit(LogisticRegression().setMaxIter(50), df.select("features", "label").rdd,
                            labeled=True)
        ref = LogisticRegression(mesh=global_mesh()).setMaxIter(50).fit((x, y))
        assert model.coefficients.tobytes() == ref.coefficients.tobytes()
        assert model.intercept == ref.intercept and model.numIter == ref.numIter


def test_serving_gang_run_serves_a_one_member_barrier_gang(stub_spark, tmp_path):
    """``serving_gang_run`` runs ``serve_member`` as the barrier task: a
    router launched on it serves bitwise the model's own predictions,
    and the stage returns the member's summary once the router drains
    it (the stub runs barrier tasks in order, so one member)."""
    from pyspark.sql import RDD

    from spark_rapids_ml_tpu_torch.clustering import KMeansModel
    from spark_rapids_ml_tpu_torch.serving import RoutingRuntime

    rng = np.random.default_rng(41)
    model = KMeansModel("bar-km", rng.integers(-16, 16, size=(4, 8)) / 4.0)
    rt = RoutingRuntime(workers=1, launch="barrier", rdd=RDD([[0]]), rendezvous=str(tmp_path / "rdv"),
                        connect_timeout=60.0)
    try:
        rt.register("bar-km", model)
        x = rng.integers(-16, 16, size=(6, 8)) / 4.0
        out = rt.submit("bar-km", x).result(timeout=60.0)
        assert out.tobytes() == np.asarray(model.predict(x)).tobytes()
        assert rt.snapshot()["launch"] == "barrier"
    finally:
        rt.close()
    assert rt._barrier_result == [[{"member": 0, "served": 1, "drain": True}]]
