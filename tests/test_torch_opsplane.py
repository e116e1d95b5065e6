"""The port's ops server (``observability/opsplane.py``) against the JAX package's.

After the reference's ``tests/test_opsplane.py``:

- **off by default**: with no ``TPUML_OPS_PORT`` there is no server, and
  the disabled emit path stays one None-check;
- **the endpoints**: ``/metrics`` is Prometheus text from the live
  registry (the same renderer as ``TPUML_METRICS_DUMP``, and for the same
  registry operations the reference's text byte for byte), ``/varz`` and
  ``/healthz`` carry the reference's keys, ``/tracez`` shows closed and
  open spans, an unknown path is a 404 that lists the endpoints, and
  ``remove_endpoint`` keeps its identity guard;
- **/healthz flips** on a failing probe, a raising probe, a heartbeat
  whose manual beats stopped (``TPUML_OPS_STALL_S``) and a lockcheck stall
  strike, and comes back when the cause goes;
- a ``ServingRuntime`` registers its dispatcher probe and removes it at
  ``close``; ``/varz`` carries its models, versions, aliases and budgets;
- the live registry as ``/varz`` serves it equals the metrics shard
  ``flush_telemetry`` writes beside a manifest that names the bound port
  (the in-process half of the reference's live-equals-post-hoc check; the
  gang ``/statusz`` half is ``tests/test_torch_opsplane_gang.py``).

Every server binds port 0 on 127.0.0.1 and is closed by its test; every
request has a timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from spark_rapids_ml_tpu.observability import metrics as jmetrics
from spark_rapids_ml_tpu.observability import opsplane as jops
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeansModel
from spark_rapids_ml_tpu_torch.observability import events as tevents
from spark_rapids_ml_tpu_torch.observability import metrics as tmetrics
from spark_rapids_ml_tpu_torch.observability import opsplane
from spark_rapids_ml_tpu_torch.observability.heartbeat import GangHeartbeat
from spark_rapids_ml_tpu_torch.serving import ServingRuntime
from spark_rapids_ml_tpu_torch.utils import lockcheck, tracing
from spark_rapids_ml_tpu_torch.utils.envknobs import env_str
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def http_get(url: str, timeout: float = 10.0):
    """(status, content type, body); a non-2xx status comes back as data
    (a 503 /healthz is the answer under test)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type", ""), exc.read().decode("utf-8")


@pytest.fixture(scope="module")
def ops_server():
    srv = opsplane.OpsServer(0)
    try:
        yield srv
    finally:
        srv.close()
        assert not srv._thread.is_alive()


@pytest.fixture
def clean_lockcheck():
    lockcheck.reset()
    try:
        yield
    finally:
        lockcheck.reset()


# --- off by default ------------------------------------------------------


class TestOffByDefault:
    def test_no_server_without_port_knob(self, monkeypatch):
        monkeypatch.delenv(opsplane.OPS_PORT_ENV, raising=False)
        assert opsplane.active() is None and opsplane.active_port() is None
        assert opsplane.maybe_start_from_env() is None and opsplane.active() is None

    def test_a_malformed_port_knob_starts_nothing(self, monkeypatch):
        monkeypatch.setenv(opsplane.OPS_PORT_ENV, "-1")
        assert opsplane.maybe_start_from_env() is None and opsplane.active() is None

    def test_disabled_emit_is_one_none_check(self):
        if tevents.enabled() or env_str(tevents.FLIGHT_ENV):
            pytest.skip("an event sink or the flight ring is active in this run")
        assert tevents.flight_ring() is None
        before = tevents.emitted_count()
        for _ in range(100):
            tevents.emit("fault", action="noop")
        assert tevents.emitted_count() == before

    def test_the_surface_is_the_references(self):
        for name in ("OPS_PORT_ENV", "OPS_STALL_ENV"):
            assert getattr(opsplane, name) == getattr(jops, name)
        public = {n for n in dir(jops) if not n.startswith("__") and callable(getattr(jops, n))}
        assert public - {"BaseHTTPRequestHandler", "ThreadingHTTPServer"} <= set(dir(opsplane))
        assert set(opsplane._BUILTIN) == set(jops._BUILTIN) == {"/metrics", "/healthz", "/varz", "/tracez"}


# --- one renderer, the reference's text -------------------------------------


def _fill(registry):
    registry.counter("rt.count", "requests served").inc(3, model="a\\c d")
    registry.counter("rt.count").inc(4, model="plain")
    registry.gauge("rt.gauge", "a level").set(2.5, host="x")
    h = registry.histogram("rt.lat", "latency", buckets=(1.0, 2.0, 5.0))
    for v in (0.5, 1.5, 99.0):
        h.observe(v)
    return registry


def test_a_registry_filled_alike_renders_the_references_text():
    ours, theirs = _fill(tmetrics.Registry()), _fill(jmetrics.Registry())
    assert ours.render_prometheus() == theirs.render_prometheus()
    helps = {name: m.help for name, m in ours.metrics().items() if m.help}
    assert ours.render_prometheus() == tmetrics.render_prometheus_snapshot(ours.snapshot(), helps=helps)


def test_metrics_body_is_the_dump_renderer_of_the_live_registry():
    bump_counter("opsplane.test.body")
    status, ctype, body = opsplane.metrics_body()
    assert status == 200 and ctype == jops.metrics_body()[1]
    assert body == tmetrics.default_registry.render_prometheus()
    assert tmetrics.parse_exposition(body)["tpuml_opsplane_test_body"]["type"] == "counter"


# --- the per-process ops server: /metrics /healthz /varz /tracez ------------


class TestOpsServerEndpoints:
    def test_metrics_scrape_is_valid_exposition(self, ops_server):
        bump_counter("opsplane.test.scrape")
        status, ctype, body = http_get(f"{ops_server.url}/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "tpuml_opsplane_test_scrape" in tmetrics.parse_exposition(body)
        assert "tpuml_opsplane_test_scrape" in jmetrics.parse_exposition(body)

    def test_varz_serves_the_live_registry(self, ops_server):
        bump_counter("opsplane.test.varz")
        status, ctype, body = http_get(f"{ops_server.url}/varz")
        assert status == 200 and ctype.startswith("application/json")
        doc = json.loads(body)
        assert doc["pid"] == os.getpid()
        assert doc["metrics"]["counters"]["opsplane.test.varz"] >= 1
        assert doc["serving"] == [] or isinstance(doc["serving"], list)
        assert doc["routers"] == []

    def test_tracez_reports_recent_and_open_spans(self, ops_server):
        with tracing.TraceRange("opsplane-span"):
            pass
        inside, release = threading.Event(), threading.Event()

        def hold_open():
            with tracing.TraceRange("opsplane-open"):
                inside.set()
                release.wait(10)

        t = threading.Thread(target=hold_open, name="tracez-open")
        t.start()
        try:
            assert inside.wait(10)
            status, _, body = http_get(f"{ops_server.url}/tracez")
        finally:
            release.set()
            t.join(timeout=10)
        assert status == 200 and not t.is_alive()
        doc = json.loads(body)
        assert any(r["name"] == "opsplane-span" for r in doc["recent"])
        assert any(s["name"] == "opsplane-open" for th in doc["open"].values() for s in th["spans"])

    def test_healthz_flips_on_failing_probe_and_recovers(self, ops_server, clean_lockcheck):
        status0, _, body0 = http_get(f"{ops_server.url}/healthz")
        assert status0 == (200 if json.loads(body0)["ok"] else 503)
        opsplane.add_probe("test.opsplane.flip", lambda: False)
        try:
            status, _, body = http_get(f"{ops_server.url}/healthz")
            doc = json.loads(body)
            assert status == 503 and doc["ok"] is False
            assert doc["checks"]["test.opsplane.flip"]["ok"] is False
        finally:
            opsplane.remove_probe("test.opsplane.flip")
        assert http_get(f"{ops_server.url}/healthz")[0] == status0

    def test_raising_probe_is_a_failed_probe(self, ops_server):
        def boom():
            raise RuntimeError("probe died")

        opsplane.add_probe("test.opsplane.boom", boom)
        try:
            status, _, body = http_get(f"{ops_server.url}/healthz")
            assert status == 503
            assert json.loads(body)["checks"]["test.opsplane.boom"] == {"ok": False, "exc": "RuntimeError"}
        finally:
            opsplane.remove_probe("test.opsplane.boom")

    def test_unknown_path_404_lists_endpoints(self, ops_server):
        status, _, body = http_get(f"{ops_server.url}/nope")
        assert status == 404
        assert {"/metrics", "/healthz", "/varz", "/tracez"} <= set(json.loads(body)["endpoints"])

    def test_remove_endpoint_identity_guard(self, ops_server):
        """A closing owner must not tear down a path a newer owner has
        since claimed."""
        fn1 = lambda: (200, "text/plain", "one\n")  # noqa: E731
        fn2 = lambda: (200, "text/plain", "two\n")  # noqa: E731
        opsplane.add_endpoint("/test-guard", fn1)
        opsplane.add_endpoint("/test-guard", fn2)
        try:
            opsplane.remove_endpoint("/test-guard", fn1)  # a stale owner
            status, _, body = http_get(f"{ops_server.url}/test-guard")
            assert (status, body) == (200, "two\n")
        finally:
            opsplane.remove_endpoint("/test-guard")
        assert http_get(f"{ops_server.url}/test-guard")[0] == 404

    def test_an_endpoint_that_raises_is_a_500(self, ops_server):
        def broken():
            raise KeyError("x")

        opsplane.add_endpoint("/test-broken", broken)
        try:
            status, _, body = http_get(f"{ops_server.url}/test-broken")
        finally:
            opsplane.remove_endpoint("/test-broken", broken)
        assert status == 500 and json.loads(body) == {"error": "KeyError"}
        with pytest.raises(ValueError):
            opsplane.add_endpoint("no-slash", broken)


# --- the documents carry the reference's keys ------------------------------


def test_varz_and_healthz_carry_the_references_keys(clean_lockcheck):
    ours, theirs = opsplane.varz_doc(), jops.varz_doc()
    assert set(ours) == set(theirs)
    assert set(ours["metrics"]) == set(theirs["metrics"])
    h_ours, h_theirs = opsplane.healthz_doc(), jops.healthz_doc()
    assert set(h_ours) == set(h_theirs) == {"ok", "ts", "checks"}
    assert set(h_ours["checks"]) >= {"heartbeat", "lockcheck"}
    for check in ("heartbeat", "lockcheck"):
        assert set(h_ours["checks"][check]) == set(h_theirs["checks"][check])
    assert set(opsplane.tracez_doc()) == set(jops.tracez_doc()) == {"open", "recent"}


# --- /healthz flips on a stale heartbeat and a stall strike ------------------


def test_healthz_flips_when_manual_beats_stop(ops_server, monkeypatch, clean_lockcheck):
    """A heartbeat whose owner's loop stops beating ages past
    ``TPUML_OPS_STALL_S``: /healthz goes 503 on ``heartbeat``, and comes
    back once the loop beats again."""
    monkeypatch.setenv(opsplane.OPS_STALL_ENV, "1.0")
    hb = GangHeartbeat(process_id=917, interval=0, manual=True).start()
    try:
        status, _, body = http_get(f"{ops_server.url}/healthz")
        assert status == 200, body
        deadline = time.monotonic() + 20.0
        doc = None
        while time.monotonic() < deadline:
            status, _, body = http_get(f"{ops_server.url}/healthz")
            if status == 503:
                doc = json.loads(body)
                break
            time.sleep(0.1)
        assert doc is not None, "a stopped heartbeat never flipped /healthz"
        check = doc["checks"]["heartbeat"]
        assert check["ok"] is False and check["max_age_s"] > 1.0 and check["limit_s"] == 1.0
        assert "process=917" in check["series"]
        hb.beat()
        assert http_get(f"{ops_server.url}/healthz")[0] == 200
    finally:
        hb.stop()


def test_healthz_flips_on_a_lockcheck_stall_strike(ops_server, monkeypatch, clean_lockcheck):
    """A thread that holds a named lock past ``TPUML_LOCKCHECK_STALL_MS``
    while another waits: one ``stall`` strike, /healthz's ``lockcheck``
    check false, the waiter still gets the lock, nothing raises."""
    monkeypatch.setenv(lockcheck.MODE_ENV, "strict")
    monkeypatch.setenv(lockcheck.STALL_ENV, "50")
    lock = lockcheck.make_lock("test.opsplane.stall")
    release = threading.Event()

    def holder():
        with lock:
            release.wait(0.5)

    t = threading.Thread(target=holder, name="stall-holder")
    t.start()
    while not lock.locked():
        time.sleep(0.001)
    with lock:
        pass
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    status, _, body = http_get(f"{ops_server.url}/healthz")
    doc = json.loads(body)
    assert status == 503 and doc["checks"]["lockcheck"] == {"ok": False, "stall_strikes": 1}
    lockcheck.reset()
    assert json.loads(http_get(f"{ops_server.url}/healthz")[2])["checks"]["lockcheck"]["ok"] is True


# --- the serving runtime's probe and its /varz entry ------------------------


def test_a_runtime_registers_its_dispatcher_probe_and_removes_it(ops_server, clean_lockcheck):
    rng = np.random.default_rng(5)
    model = KMeansModel("ops-km", rng.normal(size=(4, 3)))
    rt = ServingRuntime(max_batch=4, max_delay_ms=1.0, queue_limit=64, mem_budget=1 << 20)
    probe = f"dispatcher.{rt.runtime_id}"
    try:
        v1 = rt.register("km", model)
        rt.register("km", KMeansModel("ops-km2", rng.normal(size=(4, 3))))
        rt.set_alias("km", "prod", v1.version)
        rows = rng.normal(size=(5, 3))
        got = [rt.submit("km@prod", r).result(timeout=30)[0] for r in rows]
        np.testing.assert_array_equal(got, model.predict(rows))
        doc = json.loads(http_get(f"{ops_server.url}/healthz")[2])
        assert doc["checks"][probe] == {"ok": True}
        varz = json.loads(http_get(f"{ops_server.url}/varz")[2])
        (snap,) = [s for s in varz["serving"] if s["runtime"] == rt.runtime_id]
        assert (snap["queue_limit"], snap["mem_budget"], snap["max_batch"]) == (64, 1 << 20, 4)
        km = snap["models"]["km"]
        assert (km["versions"], km["latest"], km["aliases"]) == ([1, 2], 2, {"prod": 1})
        rt._batcher.stop(drain=True)  # a dispatcher that died under a live runtime
        status, _, body = http_get(f"{ops_server.url}/healthz")
        assert status == 503 and json.loads(body)["checks"][probe] == {"ok": False}
    finally:
        rt.close()
    assert probe not in json.loads(http_get(f"{ops_server.url}/healthz")[2])["checks"]


# --- live equals post-hoc, and the manifest's port ---------------------------


def test_the_live_registry_equals_the_flushed_shard(tmp_path, monkeypatch):
    monkeypatch.setenv(tevents.TELEMETRY_DIR_ENV, str(tmp_path / "t"))
    monkeypatch.setenv(opsplane.OPS_PORT_ENV, "0")
    tevents.configure()
    srv = opsplane.maybe_start_from_env()
    try:
        assert srv is opsplane.start() is opsplane.active()
        bump_counter("opsplane.test.posthoc", 7)
        live = json.loads(http_get(f"{srv.url}/varz")[2])
        manifest = json.load(open(tevents.flush_telemetry()))
        shard = json.load(open(tmp_path / "t" / manifest["metrics"]))
        assert manifest["ops_port"] == srv.port == live["ops_port"]
        wanted = {k: v for k, v in live["metrics"]["counters"].items() if k.startswith("opsplane.test.")}
        assert wanted and wanted == {k: v for k, v in shard["counters"].items() if k.startswith("opsplane.test.")}
    finally:
        opsplane.stop()
        monkeypatch.delenv(tevents.TELEMETRY_DIR_ENV)
        tevents.configure()
    assert opsplane.active() is None and not srv._thread.is_alive()


def test_the_port_knob_starts_the_server_at_import(tmp_path):
    """A fresh interpreter with ``TPUML_OPS_PORT=0`` serves /healthz on
    the ephemeral port it bound at import, with the sanitizer under
    ``warn`` and its hold-time histogram on /metrics."""
    code = (
        "import json, urllib.request\n"
        "from spark_rapids_ml_tpu_torch import observability as o\n"
        "from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter\n"
        "bump_counter('opsplane.child')\n"
        "url = f'http://127.0.0.1:{o.opsplane.active_port()}'\n"
        "h = json.loads(urllib.request.urlopen(url + '/healthz', timeout=10).read())\n"
        "m = urllib.request.urlopen(url + '/metrics', timeout=10).read().decode()\n"
        "print(json.dumps({'port': o.opsplane.active_port(), 'ok': h['ok'],\n"
        "                  'hold': 'tpuml_lockcheck_hold_ms_count{lock=\"events.sink\"}' in m}))\n"
        "o.opsplane.stop()\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TPUML_LOCKCHECK", "TPUML_OPS"))}
    env.update(PYTHONPATH=str(REPO), TPUML_OPS_PORT="0", TPUML_LOCKCHECK="warn")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["port"] > 0 and doc["ok"] is True and doc["hold"] is True
