"""The ops plane's gang half in the port: the router's ``/statusz`` over
spawned members that run ops servers, and a wedged member's own
``/healthz``, on the CPU.

Twins of ``tests/test_opsplane.py``'s ``TestStatuszLiveEqualsPostHoc``
and ``TestHealthzStallFlip``, which need the routing tier:

- the gang-merged ``/statusz`` scraped live after the traffic quiesces
  and the post-hoc assemble of the gang's telemetry shards agree on every
  ``serving.`` counter and histogram (the same merge function over the
  same state), the reference's ``tools/tpuml_top.py`` renders it, and the
  members' ``/metrics`` parse as Prometheus text in both packages;
- a member whose frame loop freezes (``ipc.recv=always@3:stall``) turns
  its own ``/healthz`` 503 on heartbeat age while the router still counts
  it live, and the stall retire then recovers its parked requests
  bitwise.

Rows and centres are dyadic, so every routed answer is bitwise the
model's own predict. Every request, future wait and subprocess has a
timeout.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from spark_rapids_ml_tpu.observability import metrics as jmetrics
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeansModel
from spark_rapids_ml_tpu_torch.observability import events, opsplane
from spark_rapids_ml_tpu_torch.observability import metrics as tmetrics
from spark_rapids_ml_tpu_torch.observability import trace as tracelib
from spark_rapids_ml_tpu_torch.robustness import faults
from spark_rapids_ml_tpu_torch.serving import RoutingRuntime

REPO = Path(__file__).resolve().parents[1]
TOP_CLI = REPO / "tools" / "tpuml_top.py"

D = 8
WAIT = 60.0  # seconds, every future wait


def dyadic(rng, shape, scale=4):
    return rng.integers(-4 * scale, 4 * scale, size=shape).astype(np.float64) / 4.0


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    port_device.set_platform("cpu")
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    yield
    faults.disarm()
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


def _http_get(url: str, timeout: float = 10.0):
    """(status, content type, body); a non-2xx status comes back as data
    (a 503 /healthz is the answer under test)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type", ""), exc.read().decode("utf-8")


class TestStatuszLiveEqualsPostHoc:
    N = 24

    def test_live_statusz_matches_posthoc_merge(self, telemetry, monkeypatch):
        """Route traffic across a 2-member spawned gang whose members run
        ops servers (ports learned from contact cards), scrape the
        router's /statusz over HTTP once the traffic quiesces, then close
        the gang and assemble its shards post hoc: the ``serving.``
        counters and histograms agree exactly."""
        monkeypatch.setenv(opsplane.OPS_PORT_ENV, "0")
        rng = np.random.default_rng(91)
        model = KMeansModel("ops-km", dyadic(rng, (4, D)))
        probes = dyadic(rng, (self.N, D))
        expected = np.asarray(model.predict(probes))

        local = opsplane.start(0)
        rt = RoutingRuntime(workers=2, launch="spawn", max_delay_ms=1.0, connect_timeout=WAIT)
        try:
            rt.register("km", model, warm_buckets=(1,))
            for i in range(self.N):
                assert rt.submit("km", probes[i]).result(timeout=WAIT).tobytes() == expected[i:i + 1].tobytes()
            status, ctype, body = _http_get(f"{local.url}/statusz")
            assert status == 200 and ctype.startswith("application/json")
            live = json.loads(body)

            members = live["members"]
            assert len(members) == 2
            for cell in members.values():
                assert cell["ok"] is True, cell
                assert isinstance(cell["ops_port"], int)
                assert cell["pid"] != os.getpid()
            # Each member's /metrics is Prometheus text to both parsers.
            for cell in members.values():
                ms, _, mbody = _http_get(f"http://127.0.0.1:{cell['ops_port']}/metrics")
                assert ms == 200
                assert "tpuml_serving_worker_ops" in tmetrics.parse_exposition(mbody)
                assert "tpuml_serving_worker_ops" in jmetrics.parse_exposition(mbody)

            spec = importlib.util.spec_from_file_location("tpuml_top_under_test", TOP_CLI)
            top = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(top)
            assert top.normalize_url("8321") == "http://127.0.0.1:8321/statusz"
            frame = top.render_frame(live)
            assert live["router"]["router"] in frame
            assert "gang:" in frame and "live" in frame
        finally:
            rt.close()
            opsplane.stop()

        def serving(section):
            return {k: v for k, v in section.items() if k.startswith("serving.")}

        live_counters = serving(live["merged"]["counters"])
        live_hists = serving(live["merged"]["histograms"])
        events.flush_telemetry()
        merged = tracelib.assemble(str(telemetry))
        assert merged["problems"] == []
        post = merged["metrics"]["merged"]
        post_counters, post_hists = serving(post["counters"]), serving(post["histograms"])

        assert live_counters == post_counters
        assert live_counters["serving.requests"] >= self.N
        assert sorted(live_hists) == sorted(post_hists)
        for name, series in live_hists.items():
            for skey, cell in series.items():
                other = post_hists[name][skey]
                assert cell["buckets"] == other["buckets"], (name, skey)
                assert cell["count"] == other["count"], (name, skey)
                assert cell["sum"] == pytest.approx(other["sum"])  # float sums in merge order


class TestHealthzStallFlip:
    def test_stalled_member_healthz_flips_before_eof(self, telemetry, monkeypatch):
        """Freeze a member's frame loop with the ``:stall`` fault: its
        manual heartbeat stops, so its OWN /healthz goes 503 on heartbeat
        age (``TPUML_OPS_STALL_S``) while its socket is open and the
        router still counts it live. The stall retire then recovers every
        parked request bitwise."""
        monkeypatch.setenv(opsplane.OPS_PORT_ENV, "0")
        monkeypatch.setenv(opsplane.OPS_STALL_ENV, "1.0")
        rng = np.random.default_rng(92)
        model = KMeansModel("healthz-km", dyadic(rng, (4, D)))
        probes = dyadic(rng, (12, D))
        expected = np.asarray(model.predict(probes))

        rt = RoutingRuntime(workers=1, launch="spawn", max_delay_ms=1.0, connect_timeout=WAIT)
        try:
            rt.register("km", model, warm_buckets=(1,))
            # Arm ONLY the joiner: hello (0), replay register (1), replay
            # warm (2), so @3 freezes on its first routed frame.
            monkeypatch.setenv(faults.FAULTS_ENV, "ipc.recv=always@3:stall")
            stalled_id = rt.add_member()
            monkeypatch.delenv(faults.FAULTS_ENV)

            card = rt.statusz()["members"][str(stalled_id)]
            assert card["ok"] is True
            url = f"http://127.0.0.1:{card['ops_port']}/healthz"
            deadline = time.monotonic() + 10.0
            status = None
            while time.monotonic() < deadline:
                status, _, _ = _http_get(url)
                if status == 200:
                    break
                time.sleep(0.1)
            assert status == 200

            futs = [rt.submit("km", probes[i]) for i in range(12)]
            deadline = time.monotonic() + 30.0
            doc = None
            while time.monotonic() < deadline:
                status, _, body = _http_get(url)
                if status == 503:
                    doc = json.loads(body)
                    break
                time.sleep(0.1)
            assert doc is not None, "stalled member /healthz never flipped"
            hb = doc["checks"]["heartbeat"]
            assert hb["ok"] is False and hb["max_age_s"] > 1.0
            # At flip time the router has seen no EOF: still live.
            by_id = {m["member"]: m for m in rt.snapshot()["members"]}
            assert by_id[stalled_id]["dead"] is False

            deadline = time.monotonic() + 30.0
            retired: list = []
            while stalled_id not in retired:
                assert time.monotonic() < deadline, "stall retire never fired"
                retired += rt.retire_stalled(1.0)
                time.sleep(0.05)
            for i, fut in enumerate(futs):
                assert fut.result(timeout=WAIT).tobytes() == expected[i:i + 1].tobytes()
        finally:
            rt.close()

        events.flush_telemetry()
        recs = [r for r in tracelib.assemble(str(telemetry))["records"] if r.get("event") == "serving"]
        stalls = [r for r in recs if r.get("action") == "member_stalled"]
        assert [r["member"] for r in stalls] == [stalled_id]
