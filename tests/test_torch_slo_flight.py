"""The port's SLO monitor and flight recorder against the JAX package's,
after the reference's ``tests/test_opsplane.py`` (``TestSloSpec``,
``TestSloControlLoop``, ``TestFlightRecorder``; the ops server and the
lock sanitizer's stall strike are ``tests/test_torch_opsplane.py``'s, the
router's scaler vote ``tests/test_torch_elastic_gang.py``'s).

- ``parse_slo`` gives the reference's objectives and refuses what it
  refuses with its message; the monitor's burn rates for latency, shed
  and value objectives are the reference's arithmetic; a breach reaches a
  subscribed ``DriftMonitor`` as one vote and a recover record is none;
  the in-process ``ServingRuntime``'s latency histogram breaches one
  objective and holds another; ``TPUML_SLO`` starts the process monitor.
- The flight ring captures records with no sink; a dump's document has
  the reference's keys; a fatal exception in a child (an injected fatal
  fault in a host PCA fit), a thread's fatal exception, a SIGTERM and an
  ``os._exit`` each leave ``flight-<pid>.json``, which both packages'
  ``trace.assemble`` take as the dead process's manifest. Every dump
  lands under a directory the test names (``TPUML_FLIGHT_DIR`` or the
  telemetry dir), never in the working directory.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from spark_rapids_ml_tpu.observability import flightrec as jflightrec
from spark_rapids_ml_tpu.observability import slo as jslo
from spark_rapids_ml_tpu.observability import trace as jtrace
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.lifecycle.drift import DriftMonitor
from spark_rapids_ml_tpu_torch.observability import costs as tcosts
from spark_rapids_ml_tpu_torch.observability import events as tevents
from spark_rapids_ml_tpu_torch.observability import flightrec
from spark_rapids_ml_tpu_torch.observability import slo
from spark_rapids_ml_tpu_torch.observability import trace as ttrace
from spark_rapids_ml_tpu_torch.observability.metrics import counter, gauge
from spark_rapids_ml_tpu_torch.serving import ServingRuntime
from spark_rapids_ml_tpu_torch.serving.batcher import _latency_hist
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture
def telemetry(tmp_path, monkeypatch):
    d = tmp_path / "telemetry"
    monkeypatch.setenv(tevents.TELEMETRY_DIR_ENV, str(d))
    tevents.configure()
    try:
        yield d
    finally:
        monkeypatch.delenv(tevents.TELEMETRY_DIR_ENV)
        tevents.configure()


@pytest.fixture
def flight(tmp_path, monkeypatch):
    """The flight ring armed (8 records), no event sink, dumps under
    ``tmp_path / "flight"``; teardown disarms the hooks and the ring."""
    d = tmp_path / "flight"
    # The reference's tests leave its flight recorder's hooks installed
    # (they restore them by hand). Chained behind the port's, its dump
    # would land on the same path: arm the port's over the defaults.
    monkeypatch.setattr(threading, "excepthook", threading.__excepthook__)
    monkeypatch.setattr(sys, "excepthook", sys.__excepthook__)
    monkeypatch.setenv(tevents.FLIGHT_ENV, "8")
    monkeypatch.setenv(flightrec.FLIGHT_DIR_ENV, str(d))
    tevents.configure("")
    flightrec.reset()
    try:
        yield d
    finally:
        monkeypatch.delenv(tevents.FLIGHT_ENV)
        tevents.configure()
        flightrec.disarm()
        flightrec.reset()


def _shard_records(d):
    tevents.flush_telemetry()
    return [json.loads(line) for p in sorted(Path(d).glob("events-*.jsonl"))
            for line in open(p) if line.strip()]


# --- the objectives --------------------------------------------------------


@pytest.mark.parametrize("spec", ["serving.p95_ms<=50;shed.rate<=0.01;freshness.age_s<=600",
                                  "", " ; ", "serving.p99_ms <= 1e-3", "x.min>=2.5"])
def test_parse_slo_is_the_references(spec):
    ours, theirs = slo.parse_slo(spec), jslo.parse_slo(spec)
    assert [(o.name, o.op, o.threshold, o.spec()) for o in ours] == \
        [(o.name, o.op, o.threshold, o.spec()) for o in theirs]


@pytest.mark.parametrize("spec", ["serving.p95_ms<50", "p95==nope", "a<=b"])
def test_a_malformed_spec_is_refused_with_the_references_message(spec):
    with pytest.raises(slo.SloSpecError) as ours:
        slo.parse_slo(spec)
    with pytest.raises(jslo.SloSpecError) as theirs:
        jslo.parse_slo(spec)
    assert str(ours.value) == str(theirs.value)


def test_a_latency_breach_is_one_drift_vote_and_recovers(telemetry):
    monitor = slo.SloMonitor("serving.p95_ms<=5")
    edges = []
    dm = DriftMonitor("slo-ops", threshold=10.0, min_count=50)
    hist = _latency_hist()
    try:
        monitor.tick()  # absorb this process's history
        for _ in range(40):
            hist.observe(1.0)
        assert monitor.tick()["serving.p95_ms"]["breached"] is False
        monitor.subscribe(edges.append)
        monitor.subscribe(dm.on_slo_breach)
        for _ in range(40):
            hist.observe(100.0)
        cell = monitor.tick()["serving.p95_ms"]
        assert cell["breached"] is True and cell["burn"] == pytest.approx(20.0)
        assert [e["action"] for e in edges] == ["breach"] and dm._slo_votes == 1
        assert slo.burn_rates()["serving.p95_ms"] > 1.0
        for _ in range(40):
            hist.observe(1.0)
        assert monitor.tick()["serving.p95_ms"]["breached"] is False
        assert [e["action"] for e in edges] == ["breach", "recover"] and dm._slo_votes == 1
    finally:
        gauge(slo.BURN_GAUGE).remove(objective="serving.p95_ms")
    recs = _shard_records(telemetry)
    slo_recs = [r for r in recs if r["event"] == "slo"]
    assert [r["action"] for r in slo_recs[-2:]] == ["breach", "recover"]
    votes = [r for r in recs if r.get("action") == "slo_vote"]
    assert len(votes) == 1 and votes[0]["objective"] == "serving.p95_ms"
    from spark_rapids_ml_tpu.observability.events import validate_record

    assert [p for r in slo_recs + votes for p in validate_record(r)] == []


def test_the_shed_rate_windows_counter_deltas():
    monitor = slo.SloMonitor("shed.rate<=0.01")
    try:
        monitor.tick()
        bump_counter("serving.shed.queue", 5)
        bump_counter("serving.requests", 5)
        cell = monitor.tick()["shed.rate"]
        assert (cell["value"], cell["burn"], cell["breached"]) == (pytest.approx(0.5), pytest.approx(50.0), True)
        bump_counter("serving.requests", 100)
        cell = monitor.tick()["shed.rate"]
        assert cell["value"] == pytest.approx(0.0) and cell["breached"] is False
    finally:
        gauge(slo.BURN_GAUGE).remove(objective="shed.rate")


def test_a_value_objective_reads_its_source_or_gauge():
    monitor = slo.SloMonitor("freshness.age_s<=600;slo.test.level>=4")
    age = {"v": 1200.0}
    monitor.set_source("freshness.age_s", lambda: age["v"])
    gauge("slo.test.level").set(2.0)
    try:
        out = monitor.tick()
        assert out["freshness.age_s"]["burn"] == pytest.approx(2.0) and out["freshness.age_s"]["breached"]
        assert out["slo.test.level"]["burn"] == pytest.approx(2.0)
        age["v"] = 60.0
        gauge("slo.test.level").set(8.0)
        out = monitor.tick()
        assert out["freshness.age_s"]["burn"] == pytest.approx(0.1) and not out["freshness.age_s"]["breached"]
        assert out["slo.test.level"]["burn"] == pytest.approx(0.5)
    finally:
        for name in ("freshness.age_s", "slo.test.level"):
            gauge(slo.BURN_GAUGE).remove(objective=name)


def test_recover_records_are_not_refit_votes():
    dm = DriftMonitor("slo-ignore", threshold=10.0, min_count=50)
    dm.on_slo_breach({"action": "recover", "objective": "x"})
    assert dm._slo_votes == 0
    dm.on_slo_breach({"action": "breach", "objective": "x", "burn": 2.0})
    assert dm._slo_votes == 1


def test_the_runtimes_latency_breaches_one_objective_and_holds_another():
    model = interop.kmeans_model_from_numpy(np.eye(4) * 5.0)
    breaching = slo.SloMonitor("serving.p99_ms<=0.000001")
    holding = slo.SloMonitor("serving.p99_ms<=60000")
    dm = DriftMonitor("slo-runtime", threshold=10.0, min_count=50)
    breaching.subscribe(dm.on_slo_breach)
    try:
        breaching.tick()
        holding.tick()
        rows = np.random.default_rng(3).normal(size=(24, 4))
        with ServingRuntime(max_batch=4, max_delay_ms=1.0) as rt:
            rt.register("km", model)
            futures = [rt.submit("km", rows[i:i + 1]) for i in range(24)]
            for f in futures:
                f.result(timeout=60)
        hot, cold = breaching.tick()["serving.p99_ms"], holding.tick()["serving.p99_ms"]
        assert hot["window"] >= 24 and hot["breached"] and dm._slo_votes == 1
        assert cold["window"] >= 24 and not cold["breached"] and cold["burn"] == 0.0
    finally:
        gauge(slo.BURN_GAUGE).remove(objective="serving.p99_ms")


def test_tpuml_slo_starts_the_process_monitor(monkeypatch):
    slo.stop()
    monkeypatch.setenv(slo.SLO_ENV, "serving.p95_ms<=50")
    monkeypatch.setenv(slo.SLO_EVERY_ENV, "20")
    try:
        mon = slo.maybe_start_from_env()
        assert mon is slo.active() is slo.maybe_start_from_env()
        assert [o.name for o in mon.objectives] == ["serving.p95_ms"] and mon._thread.is_alive()
        thread = mon._thread
    finally:
        slo.stop()
    thread.join(timeout=10)
    assert slo.active() is None and not thread.is_alive()
    monkeypatch.delenv(slo.SLO_ENV)
    assert slo.maybe_start_from_env() is None


# --- the flight recorder ----------------------------------------------------


def test_the_ring_captures_without_any_sink(flight):
    assert not tevents.enabled()
    ring = tevents.flight_ring()
    assert ring is not None and ring.maxlen == 8 and flightrec.armed()
    before = tevents.emitted_count()
    for i in range(20):
        tevents.emit("fault", action="arm", seq=i)
    assert tevents.emitted_count() == before and [r["seq"] for r in ring] == list(range(12, 20))
    dest = flightrec.dump("test-ring")
    assert dest == str(flight / f"flight-{os.getpid()}.json")
    doc = json.load(open(dest))
    assert set(doc) == set(jflightrec.build_doc("keys"))
    assert doc["kind"] == jflightrec.DOC_KIND and doc["pid"] == os.getpid()
    assert [r["seq"] for r in doc["ring"]] == list(range(12, 20))
    assert doc["threads"] and isinstance(doc["metrics"], dict) and doc["locks"] == [] and doc["costs"] is None
    assert flightrec.dump("test-ring") is None  # once per reason
    # With the cost ledger armed, a dump carries its snapshot.
    tcosts.configure(enable=True)
    try:
        doc = json.load(open(flightrec.dump("test-ring-ledger")))
        assert tcosts.validate_ledger(doc["costs"]) == [] and doc["costs"]["pid"] == os.getpid()
    finally:
        tcosts.reset_for_tests()


@pytest.mark.parametrize("flight_dir,telemetry_dir", [(True, True), (True, False), (False, True), (False, False)])
def test_the_dump_dir_is_chosen_like_the_references(tmp_path, monkeypatch, flight_dir, telemetry_dir):
    for name, on in ((flightrec.FLIGHT_DIR_ENV, flight_dir), (tevents.TELEMETRY_DIR_ENV, telemetry_dir)):
        if on:
            monkeypatch.setenv(name, str(tmp_path / name))
        else:
            monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    assert flightrec.flight_dir() == jflightrec.flight_dir()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_threads_fatal_exception_dumps(flight):
    def boom():
        tevents.emit("fault", action="fire", site="thread.test")
        raise RuntimeError("thread died")

    t = threading.Thread(target=boom, name="doomed")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    doc = json.load(open(flight / f"flight-{os.getpid()}.json"))
    assert doc["reason"] == "fatal-thread" and doc["detail"] == {"exc": "RuntimeError", "thread": "doomed"}
    assert any(r.get("site") == "thread.test" for r in doc["ring"])


def test_sigterm_flush_publishes_manifest_and_flight(telemetry):
    flightrec.reset()
    undo = tevents.install_sigterm_flush()
    try:
        with pytest.raises(SystemExit) as excinfo:
            signal.raise_signal(signal.SIGTERM)
        assert excinfo.value.code == 143
    finally:
        undo()
        flightrec.reset()
    pid = os.getpid()
    assert json.load(open(telemetry / f"manifest-{pid}.json"))["pid"] == pid
    assert (telemetry / f"metrics-{pid}.json").exists()
    assert json.load(open(telemetry / f"flight-{pid}.json"))["reason"] == "sigterm"


def test_install_off_the_main_thread_is_a_no_op():
    out = {}
    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=lambda: out.setdefault("undo", tevents.install_sigterm_flush()))
    t.start()
    t.join(timeout=30)
    out["undo"]()
    assert signal.getsignal(signal.SIGTERM) is before


def _child(code: str, env: dict, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                          cwd=str(cwd), timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", **env})


def test_a_fatal_fault_in_a_fit_leaves_its_flight_dump(tmp_path):
    d = tmp_path / "flight"
    r = _child("""
        import numpy as np
        from spark_rapids_ml_tpu_torch import device
        from spark_rapids_ml_tpu_torch.feature import PCA
        device.set_platform("cpu")
        PCA().setK(2).fit(np.random.default_rng(0).normal(size=(64, 5)))
        """, {"TPUML_FLIGHT": "256", "TPUML_FLIGHT_DIR": str(d), "TPUML_FAULTS": "ingest.device_put=1:fatal"},
        tmp_path)
    assert r.returncode == 1 and "InjectedFault" in r.stderr
    (dump,) = d.glob("flight-*.json")
    doc = json.load(open(dump))
    assert doc["reason"] == "fatal" and doc["detail"]["exc"] == "InjectedFault"
    fires = [rec for rec in doc["ring"] if rec["event"] == "fault" and rec["action"] == "fire"]
    assert fires and fires[0]["site"] == "ingest.device_put" and fires[0]["fatal"] is True
    assert not list(tmp_path.glob("flight-*.json"))


def test_a_crash_dump_merges_into_the_post_hoc_trace(telemetry):
    r = _child("""
        import os
        from spark_rapids_ml_tpu_torch.observability import events, flightrec
        from spark_rapids_ml_tpu_torch.utils import tracing

        with events.run_scope("job", "crash-test"):
            with tracing.TraceRange("doomed-work"):
                events.emit("fault", action="arm", site="flight-crash")
                flightrec.dump("test-crash")
                os._exit(1)
        """, {tevents.TELEMETRY_DIR_ENV: str(telemetry), tevents.FLIGHT_ENV: "64"}, telemetry.parent)
    assert r.returncode == 1, r.stderr
    (dump,) = Path(telemetry).glob("flight-*.json")
    doc = json.load(open(dump))
    crash_pid = doc["pid"]
    assert doc["reason"] == "test-crash" and any(rec.get("site") == "flight-crash" for rec in doc["ring"])
    assert not (telemetry / f"manifest-{crash_pid}.json").exists()
    tevents.flush_telemetry()
    for assemble in (ttrace.assemble, jtrace.assemble):
        merged = assemble(str(telemetry))
        assert merged["problems"] == [] and merged["orphan_problems"] == []
        assert merged["flights"] == [f"flight-{crash_pid}.json"]
        (stand_in,) = [m for m in merged["manifests"] if m.get("pid") == crash_pid]
        assert stand_in["flight"] == "test-crash"
        assert any(m["file"] == f"flight-{crash_pid}.json" for m in merged["metrics"]["members"])


def test_slo_breaches_count_and_validate(telemetry):
    monitor = slo.SloMonitor("slo.test.depth<=1")
    gauge("slo.test.depth").set(3.0)
    before = counter("slo.breaches").value(objective="slo.test.depth")
    try:
        assert monitor.tick()["slo.test.depth"]["breached"]
        assert monitor.tick()["slo.test.depth"]["breached"]  # no second edge
    finally:
        gauge(slo.BURN_GAUGE).remove(objective="slo.test.depth")
    assert counter("slo.breaches").value(objective="slo.test.depth") == before + 1
    recs = [r for r in _shard_records(telemetry) if r["event"] == "slo"]
    assert [r["action"] for r in recs] == ["breach"] and recs[0]["spec"] == "slo.test.depth<=1"
