"""The port's distributed serving tier (``serving/router.py``,
``serving/worker.py``, ``serving/ipc.py``) on the CPU.

Twins of ``tests/test_serving_router.py``'s non-slow cases, each driving
the port's router over spawned port members, plus the cross-package
checks: the wire format is the reference's byte for byte (frames,
contact cards, encoded errors), routed answers are the port model's own
bit for bit and the JAX model's on the same numpy rows (labels exact,
floats equal: the rows and weights are dyadic, integers over 4, so every
dot product is exact in float64), and the introspection documents
(``snapshot``, ``statusz``, ``serving_report``, ``/varz``) carry the
reference's keys. A member spawned on the ``cuda`` platform without a
card fails its launch, and the router raises naming it.

One 2-member gang on the CPU platform serves the module (distinct model
names keep the tests independent); a few tests start a gang of their
own where they need one (a shedding gang, a gang to close). Every future
wait, socket read and subprocess has a timeout.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeansModel
from spark_rapids_ml_tpu_torch.observability import opsplane
from spark_rapids_ml_tpu_torch.observability.metrics import default_registry
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.regression import LinearRegressionModel
from spark_rapids_ml_tpu_torch.serving import (
    Overloaded,
    RoutingRuntime,
    ServingRuntime,
    ipc,
    router_snapshots,
)
from spark_rapids_ml_tpu_torch.serving import router as trouter
from spark_rapids_ml_tpu_torch.serving.admission import DeadlineExceeded
from spark_rapids_ml_tpu_torch.serving.worker import decode_error, encode_error, serve_member
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

D = 8
WAIT = 60.0  # seconds, every future wait


def dyadic(rng, shape, scale=4):
    return rng.integers(-4 * scale, 4 * scale, size=shape).astype(np.float64) / 4.0


@pytest.fixture(scope="module", autouse=True)
def _cpu_platform():
    """The module's members run on the CPU: the router carries its
    platform onto each member's command line."""
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture(scope="module")
def gang(_cpu_platform):
    """One 2-member spawned gang shared by the small tests. Its members
    run an ops server each (``TPUML_OPS_PORT=0`` in their environment
    only), so ``statusz`` scrapes them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(opsplane.OPS_PORT_ENV, "0")
        rt = RoutingRuntime(workers=2, launch="spawn", max_delay_ms=1.0, connect_timeout=WAIT)
    yield rt
    rt.close()


def _jax_kmeans(centers):
    from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JaxKMeansModel

    return JaxKMeansModel("j", centers)


# ---------------------------------------------------------------------------
# wire framing + error codecs (no processes)
# ---------------------------------------------------------------------------


def _frame_bytes(send, msg) -> bytes:
    a, b = socket.socketpair()
    try:
        b.settimeout(WAIT)
        send(a, msg)
        a.close()
        out = bytearray()
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return bytes(out)
            out.extend(chunk)
    finally:
        b.close()


_PAYLOADS = {
    "submit": {"t": "submit", "id": 7, "name": "km", "version": 2,
               "x": np.arange(24, dtype=np.float64).reshape(3, 8) / 4.0, "timeout": None,
               "carrier": {"TPUML_TRACE_ID": "abc", "TPUML_TRACE_PARENT": "def"}},
    "reply": {"ok": True, "id": 7, "depth": 3, "model": "km", "version": 2,
              "result": np.array([1, 0, 3], dtype=np.int64)},
    "beat": {"t": "beat", "member": 1, "age": 0.25, "id": None, "depth": 0},
}


class TestIpc:
    def test_framing_roundtrip_and_eof(self):
        a, b = socket.socketpair()
        try:
            b.settimeout(WAIT)
            msg = {"t": "submit", "x": np.arange(6).reshape(2, 3), "id": 7}
            ipc.send_msg(a, msg)
            got = ipc.recv_msg(b)
            assert got["t"] == "submit" and got["id"] == 7
            np.testing.assert_array_equal(got["x"], msg["x"])
            a.close()
            assert ipc.recv_msg(b) is None  # orderly EOF
        finally:
            b.close()

    def test_oversized_frame_refused(self):
        a, b = socket.socketpair()
        try:
            b.settimeout(WAIT)
            a.sendall((ipc.MAX_FRAME_BYTES + 1).to_bytes(4, "big"))
            with pytest.raises(ValueError, match="exceeds"):
                ipc.recv_msg(b)
        finally:
            a.close()
            b.close()

    def test_model_serialization_roundtrip(self):
        rng = np.random.default_rng(3)
        m = KMeansModel("ipc-km", dyadic(rng, (4, D)))
        clone = ipc.loads_model(ipc.dumps_model(m))
        x = dyadic(rng, (5, D))
        np.testing.assert_array_equal(clone.predict(x), m.predict(x))

    def test_error_codec_roundtrip(self):
        ov = Overloaded("memory", "m", queue_depth=3, queue_limit=8, reserved_bytes=100,
                        request_bytes=50, mem_budget=120, retry_after_ms=12.5)
        back = decode_error(encode_error(ov))
        assert isinstance(back, Overloaded)
        assert back.reason == "memory" and back.retry_after_ms == 12.5
        assert back.request_bytes == 50 and back.mem_budget == 120

        dl = decode_error(encode_error(DeadlineExceeded("m", 9.0, 5.0)))
        assert isinstance(dl, DeadlineExceeded) and dl.deadline_ms == 5.0

        other = decode_error(encode_error(ValueError("boom")))
        assert isinstance(other, RuntimeError) and "boom" in str(other)

    def test_rendezvous_cards(self, tmp_path):
        assert ipc.read_member(str(tmp_path), 0) is None
        ipc.publish_member(str(tmp_path), 0, "127.0.0.1", 4242)
        card = ipc.read_member(str(tmp_path), 0)
        assert card["port"] == 4242 and card["pid"] == os.getpid()

    @pytest.mark.parametrize("kind", sorted(_PAYLOADS))
    def test_frames_are_the_references_byte_for_byte(self, kind):
        from spark_rapids_ml_tpu.serving import ipc as jipc

        ours = _frame_bytes(ipc.send_msg, _PAYLOADS[kind])
        theirs = _frame_bytes(jipc.send_msg, _PAYLOADS[kind])
        assert ours == theirs
        assert int.from_bytes(ours[:4], "big") == len(ours) - 4

    @pytest.mark.parametrize("direction", ["port_reads_reference", "reference_reads_port"])
    def test_each_side_reads_the_others_frames(self, direction):
        from spark_rapids_ml_tpu.serving import ipc as jipc

        send, recv = (jipc.send_msg, ipc.recv_msg) if direction == "port_reads_reference" else (
            ipc.send_msg, jipc.recv_msg)
        a, b = socket.socketpair()
        try:
            b.settimeout(WAIT)
            for msg in _PAYLOADS.values():
                send(a, msg)
            for msg in _PAYLOADS.values():
                got = recv(b)
                assert set(got) == set(msg)
                for key, value in msg.items():
                    if isinstance(value, np.ndarray):
                        assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes()
                    else:
                        assert got[key] == value
            a.close()
            assert recv(b) is None
        finally:
            b.close()

    def test_contact_cards_are_the_references(self, tmp_path):
        from spark_rapids_ml_tpu.serving import ipc as jipc

        ours, theirs = tmp_path / "port", tmp_path / "ref"
        ipc.publish_member(str(ours), 3, "127.0.0.1", 4242, ops_port=9090)
        jipc.publish_member(str(theirs), 3, "127.0.0.1", 4242, ops_port=9090)
        assert json.loads((ours / "member-3.json").read_text()) == json.loads((theirs / "member-3.json").read_text())
        assert ipc.read_member(str(theirs), 3) == jipc.read_member(str(ours), 3)
        assert sorted(p.name for p in ours.iterdir()) == ["member-3.json"]  # no tmp file left

    @pytest.mark.parametrize("kind", ["overloaded_memory", "overloaded_queue", "deadline", "error"])
    def test_encoded_errors_are_the_references(self, kind):
        from spark_rapids_ml_tpu.serving import admission as jadm
        from spark_rapids_ml_tpu.serving import worker as jworker

        def make(adm):
            if kind == "overloaded_memory":
                return adm.Overloaded("memory", "m", queue_depth=3, queue_limit=8, reserved_bytes=100,
                                      request_bytes=50, mem_budget=120, retry_after_ms=12.5)
            if kind == "overloaded_queue":
                return adm.Overloaded("queue", "m", queue_depth=8, queue_limit=8, retry_after_ms=4.0)
            if kind == "deadline":
                return adm.DeadlineExceeded("m", 9.0, 5.0)
            return ValueError("boom")

        from spark_rapids_ml_tpu_torch.serving import admission as tadm

        ours, theirs = encode_error(make(tadm)), jworker.encode_error(make(jadm))
        assert ours == theirs
        back = decode_error(theirs)
        assert type(back).__name__ == type(jworker.decode_error(ours)).__name__
        assert str(back) == str(jworker.decode_error(ours))


# ---------------------------------------------------------------------------
# the routed request path
# ---------------------------------------------------------------------------


class TestRoutedRequests:
    def test_roundtrip_is_bitwise_model_output(self, gang):
        rng = np.random.default_rng(11)
        centers = dyadic(rng, (4, D))
        m = KMeansModel("rt-km", centers)
        gang.register("rt-km", m)
        x = dyadic(rng, (12, D))
        out = gang.submit("rt-km", x).result(timeout=WAIT)
        # Bitwise the port model's own predict; labels exact against the
        # JAX model's (int64 in the port, by design).
        assert out.dtype == np.int64 and out.tobytes() == np.asarray(m.predict(x)).tobytes()
        np.testing.assert_array_equal(out, np.asarray(_jax_kmeans(centers).predict(x)))

    def test_submit_many_spreads_across_members(self, gang):
        from spark_rapids_ml_tpu.models.linear_regression import LinearRegressionModel as JaxLinear

        rng = np.random.default_rng(12)
        coef = dyadic(rng, (D,))
        m = LinearRegressionModel("rt-lr", coef, 0.25)
        jm = JaxLinear("rt-lr", coef, 0.25)
        gang.register("rt-lr", m)
        xs = [dyadic(rng, (1, D)) for _ in range(12)]
        futs = gang.submit_many("rt-lr", xs)
        for x, f in zip(xs, futs):
            got = np.asarray(f.result(timeout=WAIT))
            assert got.tobytes() == np.asarray(m.predict(x)).tobytes()
            # Floats equal to the JAX model's on dyadic rows (tolerance 0).
            np.testing.assert_array_equal(got, np.asarray(jm.predict(x)))
        snap = gang.snapshot()
        assert sum(mm["routed"] for mm in snap["members"]) >= 12
        # Least-loaded selection: nobody got ALL the traffic.
        assert all(mm["routed"] > 0 for mm in snap["members"])

    def test_input_validation_is_local(self, gang):
        rng = np.random.default_rng(13)
        gang.register("rt-val", KMeansModel("rt-val", dyadic(rng, (4, D))))
        with pytest.raises(ValueError, match="features"):
            gang.submit("rt-val", np.zeros((2, D + 1)))
        with pytest.raises(KeyError):
            gang.submit("rt-missing", np.zeros((1, D)))

    def test_router_appears_in_serving_report(self, gang):
        from spark_rapids_ml_tpu_torch.observability.report import serving_report

        assert any(s["router"] == gang.router_id for s in router_snapshots())
        rep = serving_report()
        routers = rep.get("routers", [])
        assert any(s["router"] == gang.router_id for s in routers)
        mine = next(s for s in routers if s["router"] == gang.router_id)
        assert len(mine["members"]) == 2
        assert "routed_latency_ms" in rep

    def test_a_tensor_request_travels_as_host_float64(self, gang):
        import torch

        rng = np.random.default_rng(16)
        m = KMeansModel("rt-tensor", dyadic(rng, (4, D)))
        gang.register("rt-tensor", m)
        x = dyadic(rng, (5, D))
        out = gang.submit("rt-tensor", torch.from_numpy(x.astype(np.float32))).result(timeout=WAIT)
        assert isinstance(out, np.ndarray) and out.tobytes() == np.asarray(m.predict(x)).tobytes()


class TestIntrospectionKeys:
    """``snapshot()``, ``statusz()``, ``serving_report()`` and ``/varz``
    carry the reference's keys (a reference router attached to no member
    stands in, with one member handle for the per-member keys)."""

    @pytest.fixture
    def reference_router(self):
        from spark_rapids_ml_tpu.serving import router as jrouter

        jrt = jrouter.RoutingRuntime(workers=0, launch="attach", connect_timeout=WAIT)
        jrt._members[0] = jrouter._Member(0, {"pid": 1}, None)
        try:
            yield jrt
        finally:
            jrt.close()

    def test_snapshot_and_statusz_keys(self, gang, reference_router):
        ours, theirs = gang.snapshot(), reference_router.snapshot()
        assert set(ours) == set(theirs)
        assert set(ours["members"][0]) == set(theirs["members"][0])
        doc = gang.statusz()
        assert set(doc) == set(reference_router.statusz())
        assert set(doc["router"]) == set(theirs)
        # Both members' ops servers were scraped and merged.
        assert all(cell["ok"] for cell in doc["members"].values()), doc["members"]
        assert set(doc["merged"]) >= {"counters", "gauges", "histograms"}

    def test_serving_report_and_varz_keys(self, gang, reference_router):
        from spark_rapids_ml_tpu.observability import opsplane as jops
        from spark_rapids_ml_tpu.observability.report import serving_report as jreport
        from spark_rapids_ml_tpu.serving import ServingRuntime as JaxServingRuntime
        from spark_rapids_ml_tpu_torch.observability.report import serving_report

        ours_rt, theirs_rt = ServingRuntime(start=False), JaxServingRuntime(start=False)
        try:
            ours, theirs = serving_report(), jreport()
            assert set(ours) == set(theirs)
            assert set(ours["runtimes"][0]) == set(theirs["runtimes"][0])
            assert set(ours["routers"][0]) == set(theirs["routers"][0])
            tv, jv = opsplane.varz_doc(), jops.varz_doc()
            assert set(tv) == set(jv)
            mine = next(r for r in tv["routers"] if r["router"] == gang.router_id)
            assert set(mine) == set(jv["routers"][0])
        finally:
            ours_rt.close()
            theirs_rt.close()

    def test_tpuml_top_renders_the_ports_statusz(self, gang):
        from tools import tpuml_top

        srv = opsplane.OpsServer(0)
        try:
            doc = tpuml_top.fetch_statusz(tpuml_top.normalize_url(srv.url), timeout=WAIT)
        finally:
            srv.close()
        frame = tpuml_top.render_frame(doc)
        assert gang.router_id in frame
        rows = [line for line in frame.splitlines() if line.strip().endswith("live")]
        assert len(rows) == 2, frame

    def test_statusz_is_claimed_on_the_ops_plane(self, gang):
        """The router claims ``/statusz`` through ``opsplane.add_endpoint``;
        a scrape returns its gang-merged document."""
        srv = opsplane.OpsServer(0)
        try:
            with urllib.request.urlopen(f"{srv.url}/statusz", timeout=WAIT) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        finally:
            srv.close()
        assert doc["router"]["router"] == gang.router_id
        assert set(doc["members"]) == {"0", "1"}


# ---------------------------------------------------------------------------
# backpressure-driven member selection
# ---------------------------------------------------------------------------


class TestBackpressure:
    def test_backed_off_member_is_skipped(self, gang):
        members = list(gang._members.values())
        try:
            with gang._lock:
                members[0].backoff_until = time.monotonic() + 60.0
            for _ in range(6):
                picked = gang._pick_member(set())
                assert picked.id == members[1].id
                with gang._lock:
                    picked.outstanding -= 1
                    picked.routed -= 1
        finally:
            with gang._lock:
                members[0].backoff_until = 0.0

    def test_least_loaded_pick_reads_depth_and_outstanding(self, gang):
        members = list(gang._members.values())
        try:
            with gang._lock:
                members[0].last_depth = 50
            picked = gang._pick_member(set())
            assert picked.id == members[1].id
            with gang._lock:
                picked.outstanding -= 1
                picked.routed -= 1
        finally:
            with gang._lock:
                members[0].last_depth = 0

    def test_all_members_backed_off_sheds_with_soonest_hint(self, gang):
        rng = np.random.default_rng(14)
        gang.register("rt-shed", KMeansModel("rt-shed", dyadic(rng, (4, D))))
        before = counter_value("serving.router.rejected")
        try:
            with gang._lock:
                for m in gang._members.values():
                    m.backoff_until = time.monotonic() + 60.0
            with pytest.raises(Overloaded) as exc:
                gang.submit("rt-shed", np.zeros((1, D)))
            # The aggregate hint is the SOONEST recovery, ~60 s here.
            assert 55_000.0 < exc.value.retry_after_ms <= 61_000.0
        finally:
            with gang._lock:
                for m in gang._members.values():
                    m.backoff_until = 0.0
        assert counter_value("serving.router.rejected") == before + 1
        assert gang.snapshot()["rejected"] >= 1

    def test_member_shed_sets_backoff_and_retries_elsewhere(self):
        """A genuinely shedding member: queue_limit=1 forces Overloaded
        replies under a burst; the router retries them on the other
        member (or surfaces a structured Overloaded), never hangs, and
        the counters agree with the member handles."""
        rng = np.random.default_rng(15)
        m = KMeansModel("bp-km", dyadic(rng, (4, D)))
        shed0 = counter_value("serving.router.shed")
        rejected0 = counter_value("serving.router.rejected")
        rt = RoutingRuntime(workers=2, launch="spawn", queue_limit=1, max_delay_ms=20.0, connect_timeout=WAIT)
        try:
            rt.register("bp-km", m)
            xs = dyadic(rng, (64, D))
            outcomes = {"ok": 0, "overloaded": 0}
            futs = []
            for i in range(64):
                try:
                    futs.append((i, rt.submit("bp-km", xs[i])))
                except Overloaded as exc:
                    assert exc.retry_after_ms >= 0.0
                    outcomes["overloaded"] += 1
            for i, f in futs:
                try:
                    out = np.asarray(f.result(timeout=WAIT))
                    np.testing.assert_array_equal(out, m.predict(xs[i:i + 1]))
                    outcomes["ok"] += 1
                except Overloaded as exc:
                    assert exc.retry_after_ms >= 0.0
                    outcomes["overloaded"] += 1
            assert outcomes["ok"] >= 1
            total_shed = sum(mm["shed"] for mm in rt.snapshot()["members"])
        finally:
            rt.close()
        if outcomes["overloaded"]:
            shed = counter_value("serving.router.shed") - shed0
            rejected = counter_value("serving.router.rejected") - rejected0
            assert shed + rejected > 0
            assert shed >= total_shed


# ---------------------------------------------------------------------------
# replicated registry
# ---------------------------------------------------------------------------


class TestReplicatedRegistry:
    def test_versions_agree_across_members(self, gang):
        rng = np.random.default_rng(21)
        v1 = gang.register("rep-km", KMeansModel("rep-km-a", dyadic(rng, (4, D))))
        v2 = gang.register("rep-km", KMeansModel("rep-km-b", dyadic(rng, (4, D))))
        assert (v1.version, v2.version) == (1, 2)
        for st in gang.member_status():
            assert st["snapshot"]["models"]["rep-km"]["versions"] == [1, 2]

    def test_alias_swap_and_retire_replicate(self, gang):
        rng = np.random.default_rng(22)
        gang.register("rep-alias", KMeansModel("a1", dyadic(rng, (4, D))))
        gang.register("rep-alias", KMeansModel("a2", dyadic(rng, (4, D))))
        gang.set_alias("rep-alias", "prod", 2)
        assert gang.registry.resolve("rep-alias@prod").version == 2
        for st in gang.member_status():
            assert st["snapshot"]["models"]["rep-alias"]["aliases"] == {"prod": 2}
        gang.retire("rep-alias", 1)
        for st in gang.member_status():
            assert st["snapshot"]["models"]["rep-alias"]["versions"] == [2]

    def test_warm_reaches_every_member(self, gang):
        rng = np.random.default_rng(23)
        gang.register("rep-warm", KMeansModel("w", dyadic(rng, (4, D))))
        # 1 rounds up to the floor bucket (8); 64 is its own bucket.
        assert gang.warm("rep-warm", buckets=(1, 64)) == 2


# ---------------------------------------------------------------------------
# oversized requests: the sharded route
# ---------------------------------------------------------------------------


class TestMeshSharded:
    def test_oversized_request_shards_bitwise(self, gang):
        """13 rows over a 4-shard data axis (one CPU device repeated):
        not a multiple of the shards, so the pad-and-slice path runs. The
        answer is bitwise the member's for the same rows."""
        rng = np.random.default_rng(31)
        centers = dyadic(rng, (4, D))
        m = KMeansModel("mesh-km", centers)
        gang.register("mesh-km", m)
        x = dyadic(rng, (13, D))
        member_out = gang.submit("mesh-km", x).result(timeout=WAIT)
        before = counter_value("serving.router.oversized")
        member_completed = sum(mm["completed"] for mm in gang.snapshot()["members"])
        old_rows, old_mesh = gang.shard_rows, gang._mesh
        gang.shard_rows = 8
        with gang._mesh_lock:
            gang._mesh = make_mesh((4, 1), devices=["cpu"] * 4)
        try:
            fut = gang.submit("mesh-km", x)
            out = fut.result(timeout=WAIT)
        finally:
            gang.shard_rows = old_rows
            with gang._mesh_lock:
                gang._mesh = old_mesh
        assert out.tobytes() == member_out.tobytes() == np.asarray(m.predict(x)).tobytes()
        np.testing.assert_array_equal(out, np.asarray(_jax_kmeans(centers).predict(x)))
        assert (fut.model_name, fut.model_version) == ("mesh-km", 1)
        assert counter_value("serving.router.oversized") == before + 1
        # The request never touched a member.
        assert sum(mm["completed"] for mm in gang.snapshot()["members"]) == member_completed

    def test_member_budget_floor_drives_oversizing(self, gang):
        members = list(gang._members.values())
        saved = [m.mem_budget for m in members]
        rng = np.random.default_rng(32)
        mv = gang.register("mesh-bud", KMeansModel("mesh-bud", dyadic(rng, (4, D))))
        try:
            with gang._lock:
                for mm in members:
                    mm.mem_budget = 1  # one byte: everything is oversized
            assert gang._is_oversized(mv, 4, np.dtype(np.float64))
            with gang._lock:
                for mm in members:
                    mm.mem_budget = 0  # no budget: the gate is off
            assert not gang._is_oversized(mv, 4, np.dtype(np.float64))
        finally:
            with gang._lock:
                for mm, s in zip(members, saved):
                    mm.mem_budget = s

    def test_the_tuners_shard_rows_drive_oversizing(self, gang, monkeypatch):
        """With no explicit cutoff, an armed autotuner's
        ``recommend_shard_rows`` for the model's family decides."""
        rng = np.random.default_rng(33)
        mv = gang.register("mesh-tune", KMeansModel("mesh-tune", dyadic(rng, (4, D))))
        asked = []

        def recommend(family):
            asked.append(family)
            return 16

        monkeypatch.setattr(trouter._autotune, "active", lambda: SimpleNamespace(recommend_shard_rows=recommend))
        assert gang._is_oversized(mv, 16, np.dtype(np.float64))
        assert not gang._is_oversized(mv, 15, np.dtype(np.float64))
        assert asked == [mv.signature.name] * 2

    def test_a_tuple_output_shards_like_a_member(self, gang):
        """The logistic kernel's several outputs concatenate leaf by leaf
        over the shards, each equal to the member's answer."""
        from spark_rapids_ml_tpu_torch.classification import LogisticRegressionModel

        rng = np.random.default_rng(34)
        m = LogisticRegressionModel("mesh-lr", dyadic(rng, (D, 1)), dyadic(rng, (1,)), 2)
        gang.register("mesh-lr", m)
        x = dyadic(rng, (11, D))
        member_out = gang.submit("mesh-lr", x).result(timeout=WAIT)
        old_rows, old_mesh = gang.shard_rows, gang._mesh
        gang.shard_rows = 8
        with gang._mesh_lock:
            gang._mesh = make_mesh((3, 1), devices=["cpu"] * 3)
        try:
            out = gang.submit("mesh-lr", x).result(timeout=WAIT)
        finally:
            gang.shard_rows = old_rows
            with gang._mesh_lock:
                gang._mesh = old_mesh
        assert type(out) is type(member_out) and len(out) == len(member_out)
        for a, b in zip(out, member_out):
            assert a.shape[0] == 11 and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# lifecycle: gauges retire, members drain, worker orphan timeout, platform
# ---------------------------------------------------------------------------


class TestLifecycle:
    def test_runtime_close_retires_queue_and_inflight_gauges(self):
        rt = ServingRuntime(start=False)
        gsnap = default_registry.snapshot()["gauges"]
        assert any(rt.runtime_id in name for name in gsnap if name.startswith("serving.queue.depth"))
        rt.close()
        for name in default_registry.snapshot()["gauges"]:
            assert rt.runtime_id not in name, name

    def test_router_close_retires_member_depth_gauges(self):
        rt = RoutingRuntime(workers=1, launch="spawn", connect_timeout=WAIT)
        rid = rt.router_id
        gsnap = default_registry.snapshot()["gauges"]
        assert any(rid in name for name in gsnap if name.startswith("serving.router.member.depth"))
        proc = rt._members[0].proc
        rt.close()
        for name in default_registry.snapshot()["gauges"]:
            assert rid not in name, name
        assert rt.snapshot()["closed"]
        assert proc.returncode == 0  # the member drained and exited
        assert all(s["router"] != rid for s in router_snapshots())
        rt.close()  # idempotent

    def test_orphaned_member_times_out_instead_of_parking(self, tmp_path):
        import signal

        handler = signal.getsignal(signal.SIGTERM)
        before = {name for name in default_registry.snapshot()["gauges"]
                  if name.startswith(("serving.queue.depth", "serving.inflight"))}
        with pytest.raises(TimeoutError, match="TPUML_ROUTER_CONNECT_TIMEOUT"):
            serve_member(0, str(tmp_path), accept_timeout=1.0)
        # Even the orphan retired its gauges on the way out.
        after = {name for name in default_registry.snapshot()["gauges"]
                 if name.startswith(("serving.queue.depth", "serving.inflight"))}
        assert after <= before
        # Its card was published (a router arriving late can see what
        # happened), and the in-process member undid its SIGTERM flush.
        assert ipc.read_member(str(tmp_path), 0) is not None
        assert signal.getsignal(signal.SIGTERM) is handler

    def test_a_cuda_member_without_a_card_fails_its_launch(self, monkeypatch):
        """The router's platform rides the member's command line: on
        ``cuda`` a member that finds no card exits before it publishes,
        and the router raises naming it, leaving no process behind."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has a card: the member would serve on it")
        port_device.set_platform("cuda")
        try:
            with pytest.raises(RuntimeError, match=r"serving member 0 exited with code 1 before publishing"):
                RoutingRuntime(workers=1, launch="spawn", connect_timeout=WAIT)
        finally:
            port_device.set_platform("cpu")


# ---------------------------------------------------------------------------
# barrier-mode launch (the pyspark stub runs barrier tasks sequentially, so
# only a single-member gang runs here; spawn covers N > 1)
# ---------------------------------------------------------------------------


class TestBarrierLaunch:
    def test_single_member_barrier_gang_serves(self, tmp_path):
        from test_torch_spark_adapter import install_stub

        undo = install_stub()
        try:
            from pyspark.sql import RDD

            rng = np.random.default_rng(41)
            m = KMeansModel("bar-km", dyadic(rng, (4, D)))
            rt = RoutingRuntime(workers=1, launch="barrier", rdd=RDD([[0]]),
                                rendezvous=str(tmp_path / "rdv"), connect_timeout=WAIT)
            try:
                rt.register("bar-km", m)
                x = dyadic(rng, (6, D))
                out = rt.submit("bar-km", x).result(timeout=WAIT)
                assert out.tobytes() == np.asarray(m.predict(x)).tobytes()
            finally:
                rt.close()
        finally:
            undo()
        # The barrier stage returned each member's summary.
        assert rt._barrier_result and rt._barrier_result[0][0]["drain"]
        assert rt._barrier_result[0][0]["served"] == 1


# ---------------------------------------------------------------------------
# the loadgen's ramp grammar drives the port's router
# ---------------------------------------------------------------------------


class TestLoadgenRamp:
    def test_parse_ramp_phases_drive_the_port_router(self, gang):
        """The reference loadgen's parsed ramp, run closed-loop against
        the port's router: every offered request completes, per phase,
        and the freshness table names the version that answered."""
        from tools import tpuml_loadgen

        phases = tpuml_loadgen._parse_ramp("40:0.25,80:0.25")
        assert phases == [(40.0, 0.25), (80.0, 0.25)]
        rng = np.random.default_rng(42)
        gang.register("ramp-km", KMeansModel("ramp-km", dyadic(rng, (4, D))))
        args = SimpleNamespace(family="ramp-km", timeout=WAIT, threads=2)
        table = tpuml_loadgen.FreshnessTable()
        report, completed, totals = tpuml_loadgen._run_ramp(
            gang, args, phases, [dyadic(rng, (1, D)) for _ in range(4)], True, table)
        assert [p["target_rps"] for p in report] == [40.0, 80.0]
        assert all(p["completed"] == p["offered"] > 0 for p in report)
        assert totals == {"overloaded": 0, "deadline": 0, "other": 0}
        assert [(r["model"], r["version"], r["requests"]) for r in table.report()] == [("ramp-km", 1, completed)]

    def test_parse_ramp_rejects_garbage_before_any_request(self, gang):
        from tools import tpuml_loadgen

        before = counter_value("serving.router.requests")
        for bad in ("50", "0:5", "50:0", "x:5", ""):
            with pytest.raises(SystemExit):
                tpuml_loadgen._parse_ramp(bad)
        assert counter_value("serving.router.requests") == before


def test_every_router_lock_comes_from_the_factories_under_its_name(tmp_path):
    """Under ``TPUML_LOCKCHECK=strict`` each lock of the tier is an
    instrumented lock named as the reference names it."""
    code = (
        "import json\n"
        "from spark_rapids_ml_tpu_torch import device\n"
        "device.set_platform('cpu')\n"
        "from spark_rapids_ml_tpu_torch.observability import report\n"
        "from spark_rapids_ml_tpu_torch.serving import router, worker, ServingRuntime\n"
        "from spark_rapids_ml_tpu_torch.utils import lockcheck as lc\n"
        "rt = router.RoutingRuntime(workers=0, launch='attach')\n"
        "m = router._Member(0, {}, None)\n"
        "w = worker.ServingWorker(0, ServingRuntime(start=False))\n"
        "locks = [router._router_seq_lock, rt._lock, rt._op_lock, rt._mesh_lock, m.send_lock,\n"
        "         w._send_lock, report._serve_lock]\n"
        "print(json.dumps([[lc._unwrap(l).name, lc.is_instrumented(l)] for l in locks]))\n"
        "rt.close(); w.runtime.close()\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_LOCKCHECK")}
    env.update(TPUML_LOCKCHECK="strict", PYTHONPATH=str(os.path.dirname(os.path.dirname(__file__))))
    import subprocess

    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [
        ["serving.router_seq", True], ["serving.router", True], ["serving.router.oplog", True],
        ["serving.router.mesh", True], ["serving.router.member_send", True],
        ["serving.worker.send", True], ["report.serving", True],
    ]

