"""Gang-wide tracing of the port against the JAX package's, after the
reference's ``tests/test_tracing_gang.py``.

- The trace carriers: a run roots one trace, span ids are globally unique
  strings, ``inject_env`` / ``extract_env`` round-trip, a spawned
  process's records join the injected trace, ``trace_scope`` carries a
  trace across a thread hop.
- Telemetry shards: ``TPUML_TELEMETRY_DIR`` outranks ``TPUML_EVENT_LOG``;
  a shard's manifest has the reference's keys and a metrics snapshot
  beside it.
- Interchange: the reference's ``trace.assemble`` over the port's shards
  gives the port's ``assemble`` document, apart from ids and times, and
  the same holds the other way; ``gang_report`` likewise.
- A 2-rank gloo gang (this file is its own worker: ``python
  tests/test_torch_tracing_gang.py PORT OUT``, environment from
  ``member_env``) fits gang PCA inside ``heartbeat_scope``; its shards
  merge into one trace with both process indices, heartbeats from both
  ranks, a critical path and a Chrome trace, and the ranks' components
  are bitwise equal.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import events as tevents  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import report as treport  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import trace as ttrace  # noqa: E402
from spark_rapids_ml_tpu_torch.parallel import distributed as tdist  # noqa: E402
from spark_rapids_ml_tpu_torch.utils import tracing  # noqa: E402

WORLD = 2
TIMEOUT = 120
N, D = 203, 7


def _rows(rank: int):
    x = np.random.default_rng(77).normal(size=(N, D)) * np.linspace(1.0, 2.0, D)
    return x[:120] if rank == 0 else x[120:]


# --- the worker -----------------------------------------------------------


def _worker(port: int, out: str) -> None:
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.observability.heartbeat import heartbeat_scope

    port_device.set_platform("cpu")
    tdist.initialize(coordinator_address=f"127.0.0.1:{port}")
    rank = tdist.process_index()
    assert tevents._process_index == rank  # initialize stamps the envelope
    with heartbeat_scope(process_id=rank, interval=0.05):
        model = PCA().setDeployMode("gang").setK(3).setEigenSolver("full").fit([_rows(rank)])
    np.savez(f"{out}.{rank}.npz", pc=model.pc, ratio=model.explainedVariance)
    torch_dist = __import__("torch.distributed", fromlist=["destroy_process_group"])
    torch_dist.destroy_process_group()
    print(f"OK rank {rank}")


# --- fixtures ---------------------------------------------------------------


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture
def telemetry(tmp_path, monkeypatch):
    """A fresh telemetry dir as the port's (shard) sink; teardown puts the
    environment's sink back."""
    d = tmp_path / "telemetry"
    monkeypatch.setenv(tevents.TELEMETRY_DIR_ENV, str(d))
    tevents.configure()
    try:
        yield d
    finally:
        monkeypatch.delenv(tevents.TELEMETRY_DIR_ENV)
        tevents.configure()


@contextlib.contextmanager
def _jax_telemetry(d):
    """The reference's sink wired to its own telemetry dir for the block
    (both packages read the same variable: the port's dir comes back)."""
    from spark_rapids_ml_tpu.observability import events as jevents

    prev = os.environ.get(jevents.TELEMETRY_DIR_ENV)
    os.environ[jevents.TELEMETRY_DIR_ENV] = str(d)
    try:
        jevents.configure()
        yield jevents
    finally:
        if prev is None:
            del os.environ[jevents.TELEMETRY_DIR_ENV]
        else:
            os.environ[jevents.TELEMETRY_DIR_ENV] = prev
        jevents.configure(os.environ.get(jevents.EVENT_LOG_ENV) or "")


def _shard(d):
    (path,) = Path(d).glob(f"events-{os.getpid()}.jsonl")
    return [json.loads(line) for line in open(path) if line.strip()]


# --- the trace carriers ------------------------------------------------------


def test_a_run_roots_one_trace(telemetry):
    with tevents.run_scope("job", "root") as ctx:
        tc = tevents.current_trace()
        with tevents.run_scope("fit", "nested"):
            assert tevents.current_trace().trace_id == tc.trace_id
        tevents.emit("fault", action="arm")
    assert tevents.current_trace() is None
    traced = [r for r in _shard(telemetry) if r["run_id"] == ctx.run_id]
    assert traced and {r["trace"] for r in traced} == {tc.trace_id}


def test_span_ids_are_globally_unique_strings(telemetry):
    with tevents.run_scope("job", "spans"):
        with tracing.TraceRange("outer"):
            with tracing.TraceRange("inner"):
                pass
    inner, outer = [r for r in _shard(telemetry) if r["event"] == "span"]
    assert inner["span"].startswith(f"{os.getpid():x}-") and inner["parent"] == outer["span"]
    assert outer["parent"] is None


def test_inject_extract_round_trip(monkeypatch):
    with tevents.run_scope("job", "inject"):
        with tracing.TraceRange("launch"):
            carrier = tevents.inject_env({})
            tc = tevents.current_trace()
            assert carrier[tevents.TRACE_ID_ENV] == tc.trace_id
            assert carrier[tevents.TRACE_PARENT_ENV] == tracing.current_span_id()
    for k, v in carrier.items():
        monkeypatch.setenv(k, v)
    got, theirs = tevents.extract_env(), __import__(
        "spark_rapids_ml_tpu.observability.events", fromlist=["extract_env"]).extract_env()
    assert (got.trace_id, got.span_id) == (theirs.trace_id, theirs.span_id) == (
        tc.trace_id, carrier[tevents.TRACE_PARENT_ENV])
    bare = tevents.inject_env({})
    assert bare[tevents.TRACE_ID_ENV] and tevents.TRACE_PARENT_ENV not in bare


def test_the_env_trace_joins_a_spawned_process(telemetry, monkeypatch):
    monkeypatch.setenv(tevents.TRACE_ID_ENV, "feedfacefeedface")
    monkeypatch.setenv(tevents.TRACE_PARENT_ENV, "abc-1")
    tevents.configure()
    try:
        with tracing.TraceRange("member root") as root:
            pass
        tevents.emit("fault", action="arm")
    finally:
        monkeypatch.delenv(tevents.TRACE_ID_ENV)
        monkeypatch.delenv(tevents.TRACE_PARENT_ENV)
        tevents.configure()
    assert root.parent_id == "abc-1"
    faults = [r for r in _shard(telemetry) if r["event"] == "fault"]
    assert faults[-1]["trace"] == "feedfacefeedface"


def test_trace_scope_carries_across_threads(telemetry):
    def dispatcher(tc):
        with tevents.trace_scope(tc), tracing.TraceRange("remote work"):
            pass

    with tevents.run_scope("job", "hop"):
        with tracing.TraceRange("submit"):
            t = threading.Thread(target=dispatcher, args=(tevents.current_trace_context(),))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    spans = {r["name"]: r for r in _shard(telemetry) if r["event"] == "span"}
    assert spans["remote work"]["parent"] == spans["submit"]["span"]
    assert spans["remote work"]["trace"] == spans["submit"]["trace"]


# --- shards and manifests ------------------------------------------------------


def test_shard_manifest_and_metrics_snapshot(telemetry):
    from spark_rapids_ml_tpu.observability import events as jevents

    with tevents.run_scope("job", "shards") as ctx:
        tracing.bump_counter("tracetest.shard.counter", 3)
        with tracing.TraceRange("work"):
            pass
        trace_id = tevents.current_trace().trace_id
    manifest = json.load(open(tevents.flush_telemetry()))
    assert manifest["pid"] == os.getpid() and manifest["shard"] == f"events-{os.getpid()}.jsonl"
    assert trace_id in manifest["trace_roots"] and manifest["emitted"] >= 3
    assert (manifest["costs"], manifest["ops_port"]) == (None, None)
    metrics = json.load(open(telemetry / f"metrics-{os.getpid()}.json"))
    assert metrics["counters"]["tracetest.shard.counter"] == 3
    recs = _shard(telemetry)
    assert [p for r in recs for p in jevents.validate_record(r)] == []
    assert recs[0]["event"] == "telemetry" and ctx.run_id in {r["run_id"] for r in recs}
    # The reference's manifest has the same keys.
    with _jax_telemetry(telemetry.parent / "jax"):
        jevents.emit("fault", action="arm")
        theirs = json.load(open(jevents.flush_telemetry()))
    assert set(manifest) == set(theirs)


def test_the_telemetry_dir_outranks_the_event_log(tmp_path, monkeypatch):
    monkeypatch.setenv(tevents.EVENT_LOG_ENV, str(tmp_path / "one.jsonl"))
    monkeypatch.setenv(tevents.TELEMETRY_DIR_ENV, str(tmp_path / "shards"))
    try:
        assert tevents.configure() == str(tmp_path / "shards" / f"events-{os.getpid()}.jsonl")
    finally:
        monkeypatch.delenv(tevents.EVENT_LOG_ENV)
        monkeypatch.delenv(tevents.TELEMETRY_DIR_ENV)
        tevents.configure()


def test_assemble_flags_a_malformed_shard(telemetry):
    tevents.emit("fault", action="arm")
    tevents.flush_telemetry()
    (shard,) = Path(telemetry).glob("events-*.jsonl")
    with open(shard, "a") as f:
        f.write('{"event": "span"}\nnot json\n')
    assert len(ttrace.assemble(str(telemetry))["problems"]) >= 2


# --- interchange with the reference's assembler ---------------------------------


def _normalise(doc: dict) -> dict:
    """An assembled document without ids and times: per trace the span,
    event, root and orphan counts and the critical path's names; the
    problem lists; the merged counters' keys."""
    traces = sorted(
        (t["spans"], t["events"], t["roots"], len(t["orphans"]), t["processes"],
         [s["name"] for s in t["critical_path"]])
        for t in doc["traces"].values())
    return {
        "record_count": doc["record_count"],
        "traces": traces,
        "problems": doc["problems"],
        "orphans": doc["orphan_problems"],
        "warnings": len(doc["warnings"]),
        "manifests": len(doc["manifests"]),
        "counters": sorted(doc["metrics"]["merged"]["counters"]),
        "span_names": sorted(r["name"] for r in doc["records"] if r.get("event") == "span"),
    }


def _traced_job(events_mod, tracing_mod, pca_cls, x):
    with events_mod.run_scope("job", "interchange"):
        with tracing_mod.TraceRange("launcher"):
            events_mod.emit("fault", action="arm")
        pca_cls().setK(2).fit(x)
    return events_mod.flush_telemetry()


def test_the_assemblers_agree_on_either_packages_shards(telemetry):
    from spark_rapids_ml_tpu.feature import PCA as JaxPCA
    from spark_rapids_ml_tpu.observability import events as jevents
    from spark_rapids_ml_tpu.observability import report as jreport
    from spark_rapids_ml_tpu.observability import trace as jtrace
    from spark_rapids_ml_tpu.utils import tracing as jtracing
    from spark_rapids_ml_tpu_torch.feature import PCA

    x = _rows(0)
    assert _traced_job(tevents, tracing, PCA, x)
    jdir = telemetry.parent / "jax"
    with _jax_telemetry(jdir):
        assert _traced_job(jevents, jtracing, JaxPCA, x)
    for d in (telemetry, jdir):
        ours, theirs = ttrace.assemble(str(d)), jtrace.assemble(str(d))
        assert ours["problems"] == [] and ours["orphan_problems"] == []
        assert _normalise(ours) == _normalise(theirs)
        assert len(ours["traces"]) == 1
        chrome = ttrace.chrome_trace(ours["records"])
        assert chrome == jtrace.chrome_trace(theirs["records"])
        gang_ours, gang_theirs = treport.gang_report(str(d)), jreport.gang_report(str(d))
        assert gang_ours["merged"] == gang_theirs["merged"]
        assert gang_ours["members"] == gang_theirs["members"]


# --- a 2-rank gloo gang in subprocesses -----------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_two_rank_gang_fit_merges_into_one_trace(tmp_path):
    from spark_rapids_ml_tpu.observability import trace as jtrace

    tdir = tmp_path / "telemetry"
    out = str(tmp_path / "gang")
    port = _free_port()
    base = {**os.environ, "JAX_PLATFORMS": "cpu", tevents.TELEMETRY_DIR_ENV: str(tdir)}
    with tevents.run_scope("job", "launch"):
        trace_id = tevents.current_trace().trace_id
        envs = [tdist.member_env(rank, WORLD, base=base) for rank in range(WORLD)]
    assert {e[tevents.TRACE_ID_ENV] for e in envs} == {trace_id}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(port), out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(REPO)) for env in envs]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{stderr[-3000:]}"
        assert f"OK rank {rank}" in stdout
    res = [np.load(f"{out}.{rank}.npz") for rank in range(WORLD)]
    np.testing.assert_array_equal(res[0]["pc"], res[1]["pc"])
    np.testing.assert_array_equal(res[0]["ratio"], res[1]["ratio"])

    merged = ttrace.assemble(str(tdir))
    assert merged["problems"] == [] and merged["orphan_problems"] == []
    assert len(merged["manifests"]) == WORLD
    assert sorted(m["process"] for m in merged["manifests"]) == [0, 1]
    (cell,) = merged["traces"].values()
    assert cell["trace_id"] == trace_id and cell["processes"] == [0, 1]
    assert cell["orphans"] == [] and cell["critical_path"]
    beats = [r for r in merged["records"] if r["event"] == "heartbeat"]
    assert {r["process"] for r in beats} == {0, 1}
    spans = [e for e in ttrace.chrome_trace(merged["records"])["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"] for e in spans} == {m["pid"] for m in merged["manifests"]}
    summed = {}
    for m in merged["metrics"]["members"]:
        for k, v in m["snapshot"]["counters"].items():
            summed[k] = summed.get(k, 0) + v
    assert merged["metrics"]["merged"]["counters"] == summed
    assert summed.get("retry.distributed.initialize.attempts", 0) == WORLD
    assert _normalise(merged) == _normalise(jtrace.assemble(str(tdir)))
    rep = treport.gang_report(str(tdir))
    assert {m["process"] for m in rep["members"]} == {0, 1} and rep["problems"] == []


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
