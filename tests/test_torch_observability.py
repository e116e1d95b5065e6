"""The port's traces and probes against the JAX package's observability.

``observability/{metrics,events,report,profiling,heartbeat}.py`` and the
span-recording ``utils/tracing.TraceRange``, each held against its JAX
twin on the CPU, after the reference's ``tests/test_observability.py``:

- the Prometheus exposition is byte for byte the reference's for the
  same registry operations, and parses back to the registry's values;
- every record the port writes passes the reference's ``validate_record``
  (and the reference's pass the port's); the schema, the base fields and
  the manifest keys are the reference's; ``tools/tpuml_metrics.py``
  validates the port's event log;
- ``fit_report`` has the reference's stage names, counter keys and
  summary keys for small PCA, KMeans, linear and logistic fits (the
  port's extra ranges named below), and a nested fit joins the outer run;
- the disabled range path stays within the reference's allocation budget,
  and writes no record;
- ``TPUML_PROFILE_DIR`` writes a Chrome trace holding the port's range
  names, and ``maybe_profile`` yields None under an open profiler;
- each knob of ROADMAP A.9 step 5's later parts raises where the
  reference would read it.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogistic
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.observability import events as jevents
from spark_rapids_ml_tpu.observability import metrics as jmetrics
from spark_rapids_ml_tpu.observability import report as jreport
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinear
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import observability as tobs
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.observability import events as tevents
from spark_rapids_ml_tpu_torch.observability import metrics as tmetrics
from spark_rapids_ml_tpu_torch.observability import profiling as tprofiling
from spark_rapids_ml_tpu_torch.observability import report as treport
from spark_rapids_ml_tpu_torch.observability.heartbeat import GangHeartbeat, heartbeat_scope
from spark_rapids_ml_tpu_torch.regression import LinearRegression
from spark_rapids_ml_tpu_torch.robustness.faults import inject
from spark_rapids_ml_tpu_torch.robustness.retry import RetryPolicy
from spark_rapids_ml_tpu_torch.tuning import CrossValidator, ParamGridBuilder
from spark_rapids_ml_tpu_torch.evaluation import RegressionEvaluator
from spark_rapids_ml_tpu_torch.utils import envknobs as tknobs
from spark_rapids_ml_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture
def event_log(tmp_path):
    """A fresh event-log file as the port's sink; teardown re-resolves the
    sink from the environment."""
    path = tmp_path / "events.jsonl"
    tevents.configure(str(path))
    try:
        yield path
    finally:
        tevents.configure()


@pytest.fixture
def no_event_log():
    tevents.configure("")
    try:
        yield
    finally:
        tevents.configure()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _rows(seed=0, n=64, d=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    return x, (x[:, 0] > 0).astype(np.float64), x @ np.arange(1.0, d + 1)


# --- the metrics exposition ---------------------------------------------


def _ops_labels_and_escapes(reg):
    reg.counter("rt.count", "requests served").inc(3, model="a\\c d")
    reg.counter("rt.count").inc(4, model="plain")
    reg.gauge("rt.gauge", "a level").set(2.5, host="x")
    h = reg.histogram("rt.lat", "latency", buckets=(1.0, 2.0, 5.0))
    for v in (0.5, 1.5, 99.0):
        h.observe(v)


def _ops_serving_shapes(reg):
    reg.counter("serving.cache.hit", "hits").inc(3)
    reg.gauge("serving.cache.size").set(2)
    reg.gauge("serving.queue.depth").set_function(lambda: 7, runtime="rt-1")
    reg.histogram("lat", buckets=(1.0,)).observe(0.5, solver="k")
    reg.histogram("serving.batch_rows", buckets=tmetrics.ROW_BUCKETS).observe(300)


def _ops_help_newlines_and_removal(reg):
    reg.counter("multi.help", "line one\nline \\two").inc(1.5)
    g = reg.gauge("gone")
    g.set(1, process="0")
    g.set(2, process="1")
    g.remove(process="0")
    reg.histogram("t.seconds", "times", buckets=tmetrics.TIME_BUCKETS).observe(0.003, site="x")
    reg.clear("multi.", kinds=("gauge",))


@pytest.mark.parametrize("ops", [_ops_labels_and_escapes, _ops_serving_shapes,
                                 _ops_help_newlines_and_removal])
def test_exposition_is_the_references_byte_for_byte(ops):
    ours, theirs = tmetrics.Registry(), jmetrics.Registry()
    ops(ours)
    ops(theirs)
    text = ours.render_prometheus()
    assert text == theirs.render_prometheus()
    assert tmetrics.parse_exposition(text) == jmetrics.parse_exposition(text)
    snap = ours.snapshot()
    snap.pop("ts")
    want = theirs.snapshot()
    want.pop("ts")
    assert snap == want
    helps = {n: m.help for n, m in ours.metrics().items() if m.help}
    assert tmetrics.render_prometheus_snapshot(ours.snapshot(), helps) == text


def test_parse_exposition_gives_back_the_registry_values():
    reg = tmetrics.Registry()
    _ops_labels_and_escapes(reg)
    doc = tmetrics.parse_exposition(reg.render_prometheus())
    assert doc["tpuml_rt_count"]["type"] == "counter"
    assert doc["tpuml_rt_count"]["help"] == "requests served"
    assert sorted(doc["tpuml_rt_count"]["series"].values()) == [3.0, 4.0]
    assert doc["tpuml_rt_gauge"]["series"] == {'tpuml_rt_gauge{host="x"}': 2.5}
    series = doc["tpuml_rt_lat"]["series"]
    assert series["tpuml_rt_lat_count"] == 3.0 and series['tpuml_rt_lat_bucket{le="+Inf"}'] == 3.0
    for bad in ("# TYPE x summary", "tpuml_x{a=\"b\"} nope", "just words here"):
        with pytest.raises(tmetrics.MetricError) as ours:
            tmetrics.parse_exposition(bad)
        with pytest.raises(jmetrics.MetricError) as theirs:
            jmetrics.parse_exposition(bad)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("values,q", [((), 0.5), ((100.0,) * 3, 0.95), ((0.5, 1.5, 3.0), 0.5),
                                      ((0.5, 100.0), 0.99), ((0.2, 0.7, 1.9, 3.9), 0.75)])
def test_percentile_from_histogram_is_the_references(values, q):
    out = []
    for mod in (tmetrics, jmetrics):
        h = mod.Registry().histogram("p", buckets=(1.0, 2.0, 4.0))
        for v in values:
            h.observe(v)
        out.append(mod.percentile_from_histogram(h.value(), q))
    assert out[0] == out[1]


def test_dump_snapshot_formats(tmp_path):
    reg = tmetrics.Registry()
    reg.counter("dump.test").inc()
    tmetrics.dump_snapshot(str(tmp_path / "m.json"), reg)
    tmetrics.dump_snapshot(str(tmp_path / "m.prom"), reg)
    assert json.load(open(tmp_path / "m.json"))["counters"] == {"dump.test": 1}
    assert open(tmp_path / "m.prom").read() == reg.render_prometheus()


def test_bump_counter_is_an_alias_over_the_registry():
    tracing.clear_counters("alias.")
    tracing.bump_counter("alias.x", 3)
    assert tmetrics.default_registry.counter("alias.x").value() == 3
    assert tracing.counters("alias.") == {"alias.x": 3} == tmetrics.default_registry.counters_snapshot("alias.")
    assert tracing.counter_value("alias.x") == 3
    tracing.clear_counters("alias.")
    assert tracing.counters("alias.") == {} and tracing.counter_value("alias.x") == 0


def test_metrics_dump_at_exit(tmp_path):
    out = tmp_path / "exit.prom"
    code = ("from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter\n"
            "bump_counter('exit.dump.test', 2)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "TPUML_METRICS_DUMP": str(out)}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    doc = tmetrics.parse_exposition(out.read_text())
    assert doc["tpuml_exit_dump_test"]["series"] == {"tpuml_exit_dump_test": 2.0}


# --- the event schema and the records ------------------------------------


def test_schema_and_base_fields_are_the_references():
    assert tevents.SCHEMA == jevents.SCHEMA
    assert tevents.BASE_FIELDS == jevents.BASE_FIELDS
    assert tevents.MAX_RUN_SPANS == jevents.MAX_RUN_SPANS


_BASE = {"event": "fault", "ts": 1.0, "mono": 2.0, "pid": 3, "process": 0, "run_id": None, "trace": None}


@pytest.mark.parametrize("record", [
    dict(_BASE, action="arm"),
    dict(_BASE),
    dict(_BASE, event="span"),
    dict(_BASE, event="nope"),
    dict(_BASE, ts="late", action="arm"),
    {k: v for k, v in _BASE.items() if k != "process"} | {"action": "arm"},
    ["not", "a", "record"],
    dict(_BASE, event="slo", action="breach"),
])
def test_validate_record_is_the_references(record):
    assert sorted(tevents.validate_record(record)) == sorted(jevents.validate_record(record))


def _drive_every_record_kind(tmp_path):
    """The port's real emitters of each record kind of the reference's
    core schema: run, span, retry, fault, checkpoint, heartbeat, serving,
    counters and report (the last two through a fit)."""
    from spark_rapids_ml_tpu_torch.core import serving
    from spark_rapids_ml_tpu_torch.robustness.checkpoint import FitCheckpointer

    x, _, _ = _rows()
    with tevents.run_scope("job", "schema"):
        with tracing.TraceRange("a span"):
            pass
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("transient")
            return 1

        RetryPolicy(max_attempts=2, base_delay=0.0).run(flaky, name="obs.unit")
        with inject("persistence.write=0"):
            pass
        ck = FitCheckpointer(str(tmp_path / "ck"), uid="u", param_hash="p", data_fp="d", every=1)
        ck.save_async(3, (np.zeros(2),))
        ck.wait()
        ck.restore_latest(template=(np.zeros(2),))
        GangHeartbeat(process_id=9, interval=10).beat()
        serving.serve_rows(lambda t: t * 2.0, np.ones((4, 3)), name="obs.schema")
        PCA().setK(2).fit(x)


def test_every_port_record_passes_the_references_validator(event_log, tmp_path):
    _drive_every_record_kind(tmp_path)
    recs = _records(event_log)
    assert [p for r in recs for p in jevents.validate_record(r)] == []
    assert [p for r in recs for p in tevents.validate_record(r)] == []
    seen = {r["event"] for r in recs}
    for kind in ("run", "span", "retry", "fault", "checkpoint", "heartbeat", "serving", "counters", "report"):
        assert kind in seen, kind
    # tools/tpuml_metrics.py, which imports the reference's validator,
    # accepts the port's log.
    spec = importlib.util.spec_from_file_location("tpuml_metrics_cli", REPO / "tools" / "tpuml_metrics.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    assert cli.main(["events", str(event_log), "--validate"]) == 0


def test_every_reference_record_passes_the_ports_validator(tmp_path):
    path = tmp_path / "jax.jsonl"
    jevents.configure(str(path))
    try:
        with jevents.run_scope("job", "ref"):
            from spark_rapids_ml_tpu.utils import tracing as jtracing

            with jtracing.TraceRange("ref span"):
                jevents.emit("fault", action="arm")
            JaxPCA().setK(2).fit(_rows()[0])
    finally:
        jevents.configure()
    recs = _records(path)
    assert recs and [p for r in recs for p in tevents.validate_record(r)] == []


def test_zero_records_when_unset(no_event_log):
    before = tevents.emitted_count()
    assert not tevents.enabled()
    with tracing.TraceRange("silent"):
        pass
    tracing.bump_counter("silent.counter")
    with inject("persistence.write=0"):
        pass
    assert tevents.emitted_count() == before


def test_stderr_sink(capsys):
    tevents.configure("stderr")
    try:
        tevents.emit("fault", action="arm")
    finally:
        tevents.configure()
    assert '"event": "fault"' in capsys.readouterr().err


def test_process_index_resolves_like_the_reference(monkeypatch):
    monkeypatch.setattr(tevents, "_process_index", None)
    monkeypatch.setattr(jevents, "_process_index", None)
    for value in (None, "3", "x"):
        if value is None:
            monkeypatch.delenv("TPUML_PROCESS_ID", raising=False)
        else:
            monkeypatch.setenv("TPUML_PROCESS_ID", value)
        assert tevents._resolve_process_index() == jevents._resolve_process_index()
    tevents.set_process_index(5)
    assert tevents._resolve_process_index() == 5


def test_run_context_caps_its_spans(no_event_log):
    ctx = tevents.RunContext("r", "job", "cap")
    for i in range(tevents.MAX_RUN_SPANS + 10):
        ctx.add_span({"i": i})
    assert ctx.span_count() == tevents.MAX_RUN_SPANS
    assert ctx.span_window(tevents.MAX_RUN_SPANS - 2) == [{"i": tevents.MAX_RUN_SPANS + 8},
                                                          {"i": tevents.MAX_RUN_SPANS + 9}]


# --- the span-recording range ---------------------------------------------


def test_ok_and_exception_type_recorded(event_log):
    with pytest.raises(ValueError):
        with tracing.TraceRange("boom"):
            raise ValueError("x")
    rec = [r for r in _records(event_log) if r["event"] == "span"][-1]
    assert (rec["name"], rec["ok"], rec["exc"]) == ("boom", False, "ValueError")


def test_depth_and_parent_rebuild_the_stage_tree(event_log):
    with tevents.run_scope("job", "tree"):
        with tracing.TraceRange("outer"):
            with tracing.TraceRange("mid"):
                with tracing.TraceRange("leaf"):
                    pass
            with tracing.TraceRange("sibling"):
                pass
    spans = [r for r in _records(event_log) if r["event"] == "span"]
    for build in (treport.build_stage_tree, jreport.build_stage_tree):
        outer = next(n for n in build(spans) if n["name"] == "outer")
        assert [c["name"] for c in outer["children"]] == ["mid", "sibling"]
        assert outer["children"][0]["children"][0]["name"] == "leaf"
    assert treport.stage_totals(spans) == jreport.stage_totals(spans)
    assert {r["name"]: r["depth"] for r in spans} == {"outer": 0, "mid": 1, "leaf": 2, "sibling": 1}
    assert all(r["span"].startswith(f"{os.getpid():x}-") for r in spans)
    assert len({r["span"] for r in spans}) == 4


def test_ring_open_spans_and_thread_hop(no_event_log):
    tracing.clear_events()
    seen = {}

    def remote(tc):
        with tevents.trace_scope(tc), tracing.TraceRange("remote work") as r:
            seen["parent"] = r.parent_id

    with tevents.run_scope("job", "hop"):
        with tracing.TraceRange("submit") as outer:
            mine = tracing.open_spans()[threading.get_ident()]["spans"]
            assert [s["name"] for s in mine] == ["submit"]
            t = threading.Thread(target=remote, args=(tevents.current_trace_context(),))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert seen["parent"] == outer.span_id
    assert threading.get_ident() not in tracing.open_spans()
    name, start, end = tracing.recent_events()[-1]
    assert name == "submit" and end >= start


def test_disabled_range_path_allocation_budget(no_event_log):
    n = 300
    with tracing.TraceRange("warmup"):
        pass
    tracemalloc.start()
    base, _ = tracemalloc.get_traced_memory()
    for _ in range(n):
        with tracing.TraceRange("budget"):
            pass
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak - base < n * 4096  # the reference's bound


def test_ranges_show_in_an_open_profiler_by_name(no_event_log):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.profiler_active()
        with tracing.TraceRange("named stage"):
            torch.ones(4).sum()
        with tprofiling.maybe_profile("nested") as d:
            assert d is None
    assert not tracing.profiler_active()
    assert "named stage" in {e.key for e in prof.key_averages()}


# --- fit reports -----------------------------------------------------------

#: Ranges the port opens and the reference does not, on these fits: a PCA
#: host input uploads through the guarded placement (the ``ingest H2D``
#: range and its retry unit, ROADMAP C), and the port's KMeans names its
#: Lloyd loop.
PORT_ONLY_STAGES = {"pca": {"ingest H2D", "retry:ingest.device_put#0"}, "kmeans": {"kmeans lloyd"}}
PORT_ONLY_COUNTERS = {"pca": {"retry.ingest.device_put.attempts"}}

FITS = {
    "pca": (lambda E, x, y, yl: E().setK(2).fit(x), PCA, JaxPCA),
    "kmeans": (lambda E, x, y, yl: E().setK(3).setSeed(1).fit(x), KMeans, JaxKMeans),
    "linear": (lambda E, x, y, yl: E().setRegParam(0.1).fit((x, yl)), LinearRegression, JaxLinear),
    "logistic": (lambda E, x, y, yl: E().setMaxIter(5).fit((x, y)), LogisticRegression, JaxLogistic),
}


@pytest.mark.parametrize("family", list(FITS))
def test_fit_report_matches_the_references(no_event_log, family):
    fit, ours_cls, theirs_cls = FITS[family]
    rows = _rows()
    ours, theirs = fit(ours_cls, *rows).fit_report(), fit(theirs_cls, *rows).fit_report()
    assert ours is not None and ours.ok and (ours.kind, ours.label) == (theirs.kind, theirs.label)
    assert set(ours.stage_totals()) == set(theirs.stage_totals()) | PORT_ONLY_STAGES.get(family, set())
    assert [n["name"] for n in ours.stage_tree()] == [n["name"] for n in theirs.stage_tree()]
    assert set(ours.counters) == set(theirs.counters) | PORT_ONLY_COUNTERS.get(family, set())
    assert set(ours.summary()) == set(theirs.summary())
    assert ours.device_memory == theirs.device_memory == {}
    assert ours.costs == [] and ours.hbm == {}
    assert ours.wall_seconds > 0 and ours.run_id in str(ours)
    json.dumps(ours.summary())


def test_nested_fits_join_the_outer_run(no_event_log):
    x, _, yl = _rows()
    with tevents.run_scope("job", "outer") as ctx:
        model = PCA().setK(2).fit(x)
        grid = ParamGridBuilder().addGrid(LinearRegression.regParam, [0.01, 0.1]).build()
        cvm = CrossValidator().setEstimator(LinearRegression()).setEstimatorParamMaps(grid) \
            .setEvaluator(RegressionEvaluator()).setNumFolds(2).fit((x, yl))
    assert model.fit_report().run_id == ctx.run_id
    assert cvm.bestModel.fit_report().run_id == ctx.run_id


def test_a_failed_fit_still_raises_its_error(no_event_log):
    with pytest.raises(ValueError):
        PCA().setK(9).fit(_rows()[0])


def test_a_report_pickles_with_its_model(no_event_log):
    import pickle

    model = PCA().setK(2).fit(_rows()[0])
    back = pickle.loads(pickle.dumps(model))
    assert back.fit_report().summary() == model.fit_report().summary()


def test_serving_report_names_its_item():
    with pytest.raises(NotImplementedError, match=r"A\.9, item 17b"):
        tobs.serving_report()


def test_device_memory_stats_are_empty_on_the_cpu():
    assert treport.device_memory_stats() == jreport.device_memory_stats() == {}


# --- the profiler session ---------------------------------------------------


def test_profile_dir_writes_a_chrome_trace_with_the_range_names(no_event_log, tmp_path, monkeypatch):
    prof = tmp_path / "profile"
    monkeypatch.setenv("TPUML_PROFILE_DIR", str(prof))
    PCA().setK(2).fit(_rows()[0])
    (trace,) = prof.glob("fit_PCA-*.trace.json")
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {"compute cov", "auto eigh"} <= names
    with tprofiling.maybe_profile("outer") as outer:
        assert outer == str(prof)
        with tprofiling.maybe_profile("inner") as inner:
            assert inner is None


def test_profile_records_validate(event_log, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUML_PROFILE_DIR", str(tmp_path / "p"))
    with tprofiling.maybe_profile("job"):
        pass
    recs = [r for r in _records(event_log) if r["event"] == "profile"]
    assert [r["action"] for r in recs] == ["start", "stop"] and recs[1]["path"].endswith(".trace.json")
    assert [p for r in recs for p in jevents.validate_record(r)] == []


# --- heartbeats --------------------------------------------------------------


def test_heartbeats_emit_and_the_gauge_reads_age(event_log):
    with heartbeat_scope(process_id=3, interval=0.02) as hb:
        time.sleep(0.12)
        assert hb.age_seconds() < 1.0
        assert 'gang.heartbeat.age_seconds{process="3"}' in tmetrics.default_registry.snapshot()["gauges"]
    recs = [r for r in _records(event_log) if r["event"] == "heartbeat"]
    assert len(recs) >= 3 and [r["seq"] for r in recs] == sorted(r["seq"] for r in recs)
    assert recs[0]["seq"] == 1 and all(r["interval"] == 0.02 and r["process"] == 3 for r in recs)
    assert [p for r in recs for p in jevents.validate_record(r)] == []
    assert 'gang.heartbeat.age_seconds{process="3"}' not in tmetrics.default_registry.snapshot()["gauges"]
    assert hb._thread is None


def test_zero_interval_runs_no_thread(no_event_log, monkeypatch):
    hb = GangHeartbeat(process_id=1, interval=0).start()
    assert hb._thread is None and not hb._registered
    hb.stop()
    monkeypatch.setenv("TPUML_GANG_HEARTBEAT_EVERY", "0.5")
    assert GangHeartbeat().interval == 0.5


# --- the knobs of step 5's later parts ----------------------------------------

LATER_AT_IMPORT = ("TPUML_OPS_PORT", "TPUML_OPS_STALL_S", "TPUML_LOCKCHECK",
                   "TPUML_LOCKCHECK_STALL_MS", "TPUML_LOCKCHECK_GRAPH")


@pytest.mark.parametrize("name,value", [("TPUML_OPS_PORT", "0"), ("TPUML_OPS_STALL_S", "30"),
                                        ("TPUML_LOCKCHECK", "warn"), ("TPUML_LOCKCHECK", "strict"),
                                        ("TPUML_LOCKCHECK_STALL_MS", "100"),
                                        ("TPUML_LOCKCHECK_GRAPH", "/tmp/g.json")])
def test_ops_plane_and_lockcheck_knobs_raise_at_import(monkeypatch, name, value):
    assert name in tobs.IMPORT_TIME_LATER_KNOBS
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9, step 5 \(costs / ops plane / lockcheck\)"):
        importlib.reload(tobs)
    monkeypatch.delenv(name)
    importlib.reload(tobs)


@pytest.mark.parametrize("name,value", [("TPUML_COST_LEDGER", "1"), ("TPUML_COST_LEDGER_DUMP", "/tmp/led.json")])
def test_cost_ledger_knobs_raise_at_the_fit(no_event_log, monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=rf"{name}=.*ROADMAP A\.9, step 5"):
        PCA().setK(2).fit(_rows()[0])


@pytest.mark.parametrize("name,value", [("TPUML_COST_LEDGER", "1"), ("TPUML_OPS_PORT", "9090")])
def test_flush_telemetry_refuses_the_costs_shard_and_ops_port(tmp_path, monkeypatch, name, value):
    monkeypatch.setenv(tevents.TELEMETRY_DIR_ENV, str(tmp_path / "t"))
    tevents.configure()
    try:
        monkeypatch.setenv(name, value)
        with pytest.raises(NotImplementedError, match=name):
            tevents.flush_telemetry()
    finally:
        monkeypatch.delenv(tevents.TELEMETRY_DIR_ENV)
        tevents.configure()


def test_later_knobs_at_their_off_values_are_quiet(no_event_log, monkeypatch):
    monkeypatch.setenv("TPUML_COST_LEDGER", "0")
    monkeypatch.setenv("TPUML_LOCKCHECK", "off")
    tknobs.reject_step5_later(*tknobs.STEP5_LATER_KNOBS)
    assert PCA().setK(2).fit(_rows()[0]).fit_report() is not None
    assert set(tknobs.STEP5_LATER_KNOBS) == set(LATER_AT_IMPORT) | {"TPUML_COST_LEDGER", "TPUML_COST_LEDGER_DUMP"}
