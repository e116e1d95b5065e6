"""Elastic gang membership in the port (``serving/elastic.py`` and the
router's join, retire and stall paths) on the CPU: join, retire, stall,
crash, under live load, and nobody sheds.

Twins of ``tests/test_elastic_gang.py``'s non-slow cases, each driving
the port's router over spawned port members and the port's fault
grammar, plus the scaler's parity: on one scripted sequence of load,
shed, p95 and SLO-burn samples, ``ElasticScaler.tick()`` in the port
takes the decisions the reference's takes, tick for tick.

Float parity is the dyadic posture of the serving suites: integers over
4 make every distance exact in float64, so "bitwise equal to the model's
own predict" holds across process hops and membership changes. Every
future wait and subprocess has a timeout.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeansModel
from spark_rapids_ml_tpu_torch.observability import events
from spark_rapids_ml_tpu_torch.observability import trace as tracelib
from spark_rapids_ml_tpu_torch.observability.metrics import default_registry
from spark_rapids_ml_tpu_torch.robustness import faults
from spark_rapids_ml_tpu_torch.serving import ElasticScaler, RoutingRuntime
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter, counter_value

REPO = Path(__file__).resolve().parents[1]
TRACE_CLI = REPO / "tools" / "tpuml_trace.py"

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
    """A fresh telemetry dir as the active sink, exported to the
    environment so spawned members inherit it and write their own shards."""
    d = tmp_path / "telemetry"
    monkeypatch.setenv(events.TELEMETRY_DIR_ENV, str(d))
    events.configure()
    try:
        yield d
    finally:
        monkeypatch.delenv(events.TELEMETRY_DIR_ENV)
        events.configure()


def _serving_records(telemetry_dir):
    events.flush_telemetry()
    merged = tracelib.assemble(str(telemetry_dir))
    return merged, [r for r in merged["records"] if r.get("event") == "serving"]


def _router(workers: int) -> RoutingRuntime:
    return RoutingRuntime(workers=workers, launch="spawn", max_delay_ms=1.0, connect_timeout=WAIT)


# ---------------------------------------------------------------------------
# fault grammar: the @K skip offset and the :stall freeze
# ---------------------------------------------------------------------------


class TestFaultGrammar:
    def test_skip_offset_parses_and_windows(self):
        sched = faults.parse_spec("ipc.recv=2@3")["ipc.recv"]
        assert (sched.count, sched.skip) == (2, 3)
        assert [sched.should_fail(i) for i in range(6)] == [False, False, False, True, True, False]

    def test_always_with_skip(self):
        sched = faults.parse_spec("ipc.send=always@4")["ipc.send"]
        assert sched.count == faults.ALWAYS and sched.skip == 4
        assert not sched.should_fail(3)
        assert sched.should_fail(4) and sched.should_fail(4000)

    def test_stall_suffix_stacks_with_skip(self):
        sched = faults.parse_spec("ipc.recv=always@3:stall")["ipc.recv"]
        assert sched.stall and sched.skip == 3 and sched.count == faults.ALWAYS
        assert not sched.fatal and not sched.torn

    def test_member_sites_known(self):
        plan = faults.parse_spec("member.launch=1;member.join=1@1")
        assert plan["member.launch"].count == 1
        assert plan["member.join"].skip == 1

    def test_malformed_skip_rejected(self):
        with pytest.raises(ValueError, match="skip offset"):
            faults.parse_spec("ipc.recv=1@x")
        with pytest.raises(ValueError, match="skip offset"):
            faults.parse_spec("ipc.recv=1@-2")

    def test_stall_blocks_until_disarmed(self):
        """The :stall freeze is the stuck-but-alive mode: the site parks
        (no raise) and wakes only when the plan goes away."""
        done = threading.Event()

        def run():
            faults.fault_point("ipc.recv")
            done.set()

        with faults.inject("ipc.recv=always:stall") as plan:
            t = threading.Thread(target=run, daemon=True)
            t.start()
            time.sleep(0.3)
            assert not done.is_set(), ":stall site returned while armed"
        assert done.wait(5.0), ":stall site never woke after disarm"
        assert plan.fired == [("ipc.recv", 0)]

    def test_a_failed_launch_or_join_leaves_the_gang_as_it_was(self):
        """``member.launch`` fails before a process exists,
        ``member.join`` after the joiner connected: either way the router
        serves on with its members, and the joiner's process is gone."""
        rng = np.random.default_rng(60)
        model = KMeansModel("join-km", dyadic(rng, (4, D)))
        rt = _router(1)
        try:
            rt.register("km", model)
            for spec in ("member.launch=1:fatal", "member.join=1:fatal"):
                with faults.inject(spec) as plan:
                    with pytest.raises(faults.InjectedFault):
                        rt.add_member()
                assert plan.fired == [(spec.split("=")[0], 0)]
                assert rt.live_member_ids() == [0] and sorted(rt._members) == [0]
            x = dyadic(rng, (3, D))
            assert rt.submit("km", x).result(timeout=WAIT).tobytes() == np.asarray(model.predict(x)).tobytes()
        finally:
            rt.close()


# ---------------------------------------------------------------------------
# the full elastic episode: ramp up -> join -> ramp down -> retire -> drain
# ---------------------------------------------------------------------------


class TestElasticEpisode:
    N_THREADS = 4
    PER_THREAD = 25

    def test_join_retire_episode_sheds_nothing_and_leaves_no_stale_series(self, telemetry):
        """One member carries the low phase; the gang grows by one under
        live load (zero shed, event-log join proof), both members carry
        the burst, the joiner retires on ramp-down, and the drained
        episode leaves no stale gauge series anywhere, with the merged
        multi-process trace strict-clean."""
        rng = np.random.default_rng(61)
        model = KMeansModel("elastic-km", dyadic(rng, (4, D)))
        n = self.N_THREADS * self.PER_THREAD
        probes = dyadic(rng, (n, D))
        expected = np.asarray(model.predict(probes))

        shed0 = counter_value("serving.router.shed")
        rejected0 = counter_value("serving.router.rejected")
        rt = _router(1)
        rid = rt.router_id
        errors: list = []
        try:
            rt.register("km", model, warm_buckets=(1,))
            for i in range(8):
                out = rt.submit("km", probes[i]).result(timeout=WAIT)
                np.testing.assert_array_equal(out, expected[i:i + 1])

            collected = []
            lock = threading.Lock()

            def worker(tid):
                local = []
                for j in range(self.PER_THREAD):
                    i = tid * self.PER_THREAD + j
                    try:
                        local.append((i, np.asarray(rt.submit("km", probes[i]).result(timeout=WAIT))))
                    except Exception as exc:  # noqa: BLE001 - asserted below
                        errors.append((i, repr(exc)))
                with lock:
                    collected.extend(local)

            threads = [threading.Thread(target=worker, args=(t,)) for t in range(self.N_THREADS)]
            for t in threads:
                t.start()
            time.sleep(0.05)
            new_member = rt.add_member()
            assert new_member == 1
            assert rt.live_member_ids() == [0, 1]
            # A post-join burst guarantees the joiner takes traffic even
            # if the threads finished while it was connecting.
            burst = [rt.submit("km", probes[i]) for i in range(8)]
            for i, fut in enumerate(burst):
                np.testing.assert_array_equal(fut.result(timeout=WAIT), expected[i:i + 1])
            for t in threads:
                t.join(timeout=WAIT)

            rt.retire_member(new_member)
            assert rt.live_member_ids() == [0]
            for i in range(8):
                np.testing.assert_array_equal(rt.submit("km", probes[i]).result(timeout=WAIT), expected[i:i + 1])
            snap = rt.snapshot()
        finally:
            rt.close()

        assert errors == [], errors[:5]
        assert counter_value("serving.router.shed") == shed0
        assert counter_value("serving.router.rejected") == rejected0
        assert len(collected) == n
        for i, out in collected:
            assert out.tobytes() == expected[i:i + 1].tobytes()

        by_id = {m["member"]: m for m in snap["members"]}
        assert by_id[0]["routed"] > 0 and by_id[1]["routed"] > 0
        assert by_id[1]["shed"] == 0

        merged, recs = _serving_records(telemetry)
        joins = [r for r in recs if r.get("action") == "member_join"]
        assert len(joins) == 1
        assert joins[0]["member"] == new_member
        assert joins[0]["ops_replayed"] == 2 and joins[0]["lsn"] == 2
        retires = [r for r in recs if r.get("action") == "member_retire"]
        assert [r["member"] for r in retires] == [new_member]
        downs = {r["member"]: r["reason"] for r in recs
                 if r.get("action") == "member_down" and r.get("router")}
        assert downs[new_member] == "retired"
        assert not any(r.get("action") == "route_shed" for r in recs)

        for name in default_registry.snapshot()["gauges"]:
            assert rid not in name, f"stale router gauge series {name!r}"
        stale = [name for name in merged["metrics"]["merged"]["gauges"]
                 if name.startswith(("gang.heartbeat.age_seconds", "serving.router.member.depth"))]
        assert stale == [], f"stale gauge series in merged shards: {stale}"

        # The reference's CLI is the oracle: ONE strict-clean merged trace
        # across router + both members, join and retire included.
        r = subprocess.run([sys.executable, str(TRACE_CLI), str(telemetry), "--validate", "--strict"],
                           capture_output=True, text=True, cwd=str(REPO),
                           env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# stall: frozen frame loop, open socket, retired by heartbeat age
# ---------------------------------------------------------------------------


class TestStallRetire:
    def test_stalled_member_retired_before_eof_and_requests_survive(self, telemetry, monkeypatch):
        """A member whose frame loop freezes mid-conversation (the
        ``:stall`` fault) keeps its socket open, so EOF detection never
        fires; its reported heartbeat age grows instead, and the scaler's
        liveness tick force-retires it. The submit parked on the frozen
        member redispatches and completes bitwise correct."""
        rng = np.random.default_rng(62)
        model = KMeansModel("stall-km", dyadic(rng, (4, D)))
        probes = dyadic(rng, (12, D))
        expected = np.asarray(model.predict(probes))

        stall0 = counter_value("serving.elastic.stall")
        rt = _router(2)
        try:
            rt.register("km", model, warm_buckets=(1,))
            # Arm ONLY the joiner: it inherits the environment and arms
            # at import. Its recv sequence is hello (0), replay register
            # (1), replay warm (2), so @3 lets the join complete and
            # freezes on the first routed frame.
            monkeypatch.setenv(faults.FAULTS_ENV, "ipc.recv=always@3:stall")
            stalled_id = rt.add_member()
            monkeypatch.delenv(faults.FAULTS_ENV)
            assert rt.live_member_ids() == [0, 1, stalled_id]

            futs = [rt.submit("km", probes[i]) for i in range(12)]
            scaler = ElasticScaler(rt, min_members=1, max_members=4, hysteresis=1000,
                                   cooldown_ms=0.0, stall_after_s=1.0)
            deadline = time.monotonic() + 30.0
            action = None
            while action is None and time.monotonic() < deadline:
                action = scaler.tick()
                time.sleep(0.05)
            assert action == "stall_retire"
            assert scaler.decisions == [("stall_retire", (stalled_id,))]
            assert counter_value("serving.elastic.stall") == stall0 + 1
            for i, fut in enumerate(futs):
                assert fut.result(timeout=WAIT).tobytes() == expected[i:i + 1].tobytes()
            snap = rt.snapshot()
        finally:
            rt.close()

        by_id = {m["member"]: m for m in snap["members"]}
        assert by_id[stalled_id]["dead"]
        assert rt.live_member_ids() == []  # closed

        _, recs = _serving_records(telemetry)
        stalls = [r for r in recs if r.get("action") == "member_stalled"]
        assert [r["member"] for r in stalls] == [stalled_id]
        assert stalls[0]["age_s"] > 1.0
        downs = {r["member"]: r["reason"] for r in recs
                 if r.get("action") == "member_down" and r.get("router")}
        assert downs.get(stalled_id) == "stalled"
        for name in default_registry.snapshot()["gauges"]:
            assert rt.router_id not in name, name


# ---------------------------------------------------------------------------
# crash mid-broadcast: the op survives on the survivors, lsn stays dense
# ---------------------------------------------------------------------------


class TestDeadMemberBroadcast:
    def test_member_death_mid_broadcast_is_skipped_not_fatal(self, telemetry, monkeypatch):
        """A member seeded to die on its next frame receive takes the
        registry-op broadcast down with it: the router classifies it
        SKIPPED (``replicate_skip``), the survivors ack with the same
        version, and every LATER op still sees dense lsns."""
        rng = np.random.default_rng(63)
        m1 = KMeansModel("bc-v1", dyadic(rng, (4, D)))
        m2 = KMeansModel("bc-v2", dyadic(rng, (4, D)) + 32.0)
        probes = dyadic(rng, (6, D))

        rt = _router(1)
        try:
            rt.register("a", m1)  # oplog: [register a] -> lsn 1
            # Joiner recv sequence: hello (0), replay register (1); the
            # NEXT frame it receives (the live broadcast) kills it.
            monkeypatch.setenv(faults.FAULTS_ENV, "ipc.recv=1@2")
            victim = rt.add_member()
            monkeypatch.delenv(faults.FAULTS_ENV)
            assert rt.live_member_ids() == [0, victim]

            mv2 = rt.register("b", m2)  # the broadcast the victim dies on
            assert mv2.version == 1
            deadline = time.monotonic() + 10.0
            while victim in rt.live_member_ids():
                assert time.monotonic() < deadline, "victim EOF never seen"
                time.sleep(0.02)
            out = rt.submit("b", probes).result(timeout=WAIT)
            assert out.tobytes() == np.asarray(m2.predict(probes)).tobytes()
            rt.warm("b", buckets=(6,))
        finally:
            rt.close()

        _, recs = _serving_records(telemetry)
        skips = [r for r in recs if r.get("action") == "replicate_skip"]
        assert len(skips) == 1
        assert skips[0]["member"] == victim and skips[0]["op"] == "register" and skips[0]["lsn"] == 2
        downs = {r["member"]: r["reason"] for r in recs
                 if r.get("action") == "member_down" and r.get("router")}
        assert victim in downs


# ---------------------------------------------------------------------------
# the scaler's vote machinery against a live router
# ---------------------------------------------------------------------------


class TestElasticScaler:
    def test_shed_pressure_scales_up_and_sustained_idle_scales_down(self, telemetry):
        """Shed deltas vote up (through the zero-shed join), sustained
        idle votes down (through drain-then-detach), hysteresis gates
        both, and the min/max bounds are hard."""
        rng = np.random.default_rng(64)
        model = KMeansModel("scale-km", dyadic(rng, (4, D)))
        up0 = counter_value("serving.elastic.up")
        down0 = counter_value("serving.elastic.down")

        rt = _router(1)
        try:
            rt.register("km", model, warm_buckets=(1,))
            # Depth thresholds parked out of reach: shed deltas are the
            # ONLY pressure signal, idle the only relief.
            scaler = ElasticScaler(rt, min_members=1, max_members=2, hysteresis=2,
                                   cooldown_ms=0.0, high=1e9, low=1e9)
            bump_counter("serving.router.shed")
            assert scaler.tick() is None  # one vote < hysteresis
            bump_counter("serving.router.shed")
            assert scaler.tick() == "scale_up"
            assert rt.live_member_ids() == [0, 1]
            assert counter_value("serving.elastic.up") == up0 + 1

            # At max: pressure can't overshoot the bound.
            bump_counter("serving.router.shed")
            scaler.tick()
            bump_counter("serving.router.shed")
            assert scaler.tick() is None
            assert rt.live_member_ids() == [0, 1]

            # Sustained idle drains one member back out (tie on load:
            # the lowest id retires, member 0).
            assert scaler.tick() is None
            assert scaler.tick() == "scale_down"
            assert rt.live_member_ids() == [1]
            assert counter_value("serving.elastic.down") == down0 + 1

            # At min: idle can't retire the last member.
            assert scaler.tick() is None
            assert scaler.tick() is None
            assert rt.live_member_ids() == [1]
            assert scaler.decisions == [("scale_up", 1), ("scale_down", 0)]
            x = dyadic(rng, (5, D))
            assert rt.submit("km", x).result(timeout=WAIT).tobytes() == np.asarray(model.predict(x)).tobytes()
        finally:
            rt.close()


# ---------------------------------------------------------------------------
# the scaler's decisions are the reference's on scripted signals
# ---------------------------------------------------------------------------


class _ScriptedRouter:
    """The router surface a scaler reads and drives, with scripted load:
    ``snapshot`` reports the scripted per-member depth, ``add_member`` /
    ``retire_member`` / ``retire_stalled`` change the membership."""

    def __init__(self):
        self._closed = False
        self.members = [0]
        self.depth = 0.0
        self.stalled = []

    def snapshot(self) -> dict:
        return {"members": [{"member": m, "dead": False, "joining": False, "retiring": False,
                             "depth": self.depth, "outstanding": 0} for m in self.members]}

    def add_member(self) -> int:
        new = max(self.members) + 1
        self.members.append(new)
        return new

    def retire_member(self, member: int) -> None:
        self.members.remove(member)

    def retire_stalled(self, max_age: float) -> list:
        out = [m for m in self.stalled if m in self.members]
        for m in out:
            self.members.remove(m)
        self.stalled = []
        return out


#: One tick each: (mean depth, sheds this tick, latency samples in ms,
#: SLO burn, members stalled).
_SCRIPT = [
    (0.0, 0, [1.0] * 8, 0.0, []),       # idle: down vote 1
    (0.0, 0, [1.0] * 8, 0.0, []),       # idle at min: nothing to retire
    (6.0, 0, [], 0.0, []),              # depth over high: up vote 1
    (6.0, 0, [], 0.0, []),              # up vote 2: scale_up
    (2.0, 3, [], 0.0, []),              # shed: up vote 1
    (2.0, 0, [400.0] * 40, 0.0, []),    # p95 over the budget: up vote 2: scale_up
    (2.0, 0, [], 1.5, []),              # the SLO burns: up vote 1
    (2.0, 0, [], 1.5, []),              # up vote 2, but at max
    (2.0, 0, [], 0.0, [1]),             # member 1 stalls: stall_retire
    (2.0, 0, [1.0] * 1000, 0.0, []),    # p95 back under the budget: neither pressured nor idle
    (0.1, 0, [], 0.0, []),              # idle: down vote 1
    (0.1, 0, [], 0.0, []),              # down vote 2: scale_down
    (0.1, 0, [], 0.0, []),              # down vote 1
    (0.1, 0, [], 0.0, []),              # down vote 2, but at min
]


def _run_script(package: str) -> tuple:
    if package == "port":
        from spark_rapids_ml_tpu_torch.observability import metrics as mod
        from spark_rapids_ml_tpu_torch.serving.elastic import ElasticScaler as Scaler
        from spark_rapids_ml_tpu_torch.utils import tracing
    else:
        from spark_rapids_ml_tpu.observability import metrics as mod
        from spark_rapids_ml_tpu.serving.elastic import ElasticScaler as Scaler
        from spark_rapids_ml_tpu.utils import tracing
    from spark_rapids_ml_tpu_torch.serving.batcher import LATENCY_MS_BUCKETS

    fresh = mod.Registry()
    hist = fresh.histogram("serving.router.latency_ms", buckets=LATENCY_MS_BUCKETS)
    burn = fresh.gauge("slo.burn_rate")
    router = _ScriptedRouter()
    actions = []
    with pytest.MonkeyPatch.context() as mp:
        # The scaler reads its latency and burn signals from the registry:
        # these fresh series stand in for the process's own, scripted.
        mp.setattr(mod.default_registry, "metrics", fresh.metrics)
        scaler = Scaler(router, min_members=1, max_members=3, high=4.0, low=0.5, hysteresis=2,
                        cooldown_ms=0.0, stall_after_s=1.0, deadline_ms=50.0)
        for depth, sheds, samples, slo_burn, stalled in _SCRIPT:
            router.depth, router.stalled = depth, list(stalled)
            if sheds:
                tracing.bump_counter("serving.router.shed", sheds)
            for s in samples:
                hist.observe(s)
            burn.set(slo_burn, objective="serving.p95_ms<=50")
            actions.append(scaler.tick())
    return actions, scaler.decisions, router.members


def test_scaler_decisions_are_the_references_on_scripted_signals():
    ours = _run_script("port")
    theirs = _run_script("jax")
    assert ours == theirs
    actions, decisions, members = ours
    assert actions == [None, None, None, "scale_up", None, "scale_up", None, None, "stall_retire",
                       None, None, "scale_down", None, None]
    assert decisions == [("scale_up", 1), ("scale_up", 2), ("stall_retire", (1,)), ("scale_down", 0)]
    assert members == [2]


class _FakeRouter:
    """The scaler's whole view of a gang, minus the gang."""

    def __init__(self):
        self._closed = False
        self.added = 0

    def snapshot(self):
        return {"members": [{"member": 0, "dead": False, "joining": False, "retiring": False,
                             "depth": 0, "outstanding": 0}]}

    def add_member(self, **kwargs):
        self.added += 1
        return self.added

    def retire_member(self, member_id, **kwargs):
        raise AssertionError("the scaler must not retire under SLO pressure")

    def retire_stalled(self, max_age):
        return []


def test_a_burning_slo_on_the_routers_latency_is_a_scale_up_vote(telemetry):
    """The reference's ``TestSloControlLoop`` scaler half: latency the
    router observes (``serving.router.latency_ms``, which the monitor
    reads before the runtime's) burns a p95 budget, and the scaler's next
    tick scales an otherwise idle gang up, recording the burn."""
    from spark_rapids_ml_tpu_torch.observability import slo
    from spark_rapids_ml_tpu_torch.observability.metrics import gauge
    from spark_rapids_ml_tpu_torch.serving.router import _routed_latency_hist

    monitor = slo.SloMonitor("serving.p95_ms<=5")
    hist = _routed_latency_hist()
    try:
        monitor.tick()  # absorb this process's history
        for _ in range(40):
            hist.observe(100.0)
        cell = monitor.tick()["serving.p95_ms"]
        assert cell["breached"] is True and cell["burn"] == pytest.approx(20.0)
        fake = _FakeRouter()
        scaler = ElasticScaler(fake, min_members=1, max_members=4, hysteresis=1, cooldown_ms=0.0,
                               stall_after_s=0.0, high=1e9, low=-1.0)
        assert scaler.tick() == "scale_up"
        assert fake.added == 1 and scaler.decisions == [("scale_up", 1)]
    finally:
        gauge(slo.BURN_GAUGE).remove(objective="serving.p95_ms")
    events.flush_telemetry()
    recs = [r for r in tracelib.assemble(str(telemetry))["records"]
            if r.get("event") == "elastic" and r.get("action") == "scale_up"]
    assert len(recs) == 1 and recs[0]["slo_burn"] == pytest.approx(20.0)
