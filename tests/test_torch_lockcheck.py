"""The port's lock sanitizer (``utils/lockcheck.py``) against the JAX package's.

Both modules are stdlib Python. The reference's ``tests/test_lockcheck.py``
classes ``TestOffMode``, ``TestGuarded``, ``TestOrderCycle``,
``TestViolationKinds`` and ``TestBookkeeping`` run here against each
module on the same scripted acquisition sequences (one case per package),
and a scripted run through both gives the same violation kinds and lock
names, the same ``order_graph()`` and the same keys in the graph dump.

Then the port as a whole:

- with ``TPUML_LOCKCHECK`` unset, every lock site of the port is a plain
  ``threading`` primitive; under ``strict`` (a fresh interpreter, since
  module-level locks are made at import) each is instrumented under its
  name;
- a fresh interpreter under ``strict`` fits every family and serves a
  16-thread closed loop through a ``ServingRuntime`` (unbatched and
  batched, a hot swap and a retire), with the cost ledger on: every
  result is bitwise the ``off`` run's, no violation is recorded, and the
  order graph read back from its exit dump is acyclic;
- the flight recorder's stall strike writes one dump whose ``locks``
  shows the holder and the waiter, and ``disarm`` takes the hook back;
- the static half: ``tools/tpuml_lint``'s lock family finds nothing in
  any module of the port (the ``# guarded-by:`` annotations hold).

Stall tests hold a lock ten times the watchdog's threshold (50 ms
against 500 ms), so that they keep their margin on a loaded machine.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_ml_tpu.observability import events as jevents
from spark_rapids_ml_tpu.observability import metrics as jmetrics
from spark_rapids_ml_tpu.utils import lockcheck as jlc
from spark_rapids_ml_tpu.utils.envknobs import env_str as jenv_str
from spark_rapids_ml_tpu_torch.observability import events as tevents
from spark_rapids_ml_tpu_torch.observability import flightrec
from spark_rapids_ml_tpu_torch.observability import metrics as tmetrics
from spark_rapids_ml_tpu_torch.utils import lockcheck as tlc
from spark_rapids_ml_tpu_torch.utils.envknobs import env_str as tenv_str

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import tools.tpuml_lint as tl  # noqa: E402
from tools.tpuml_lint import locks as lint_locks  # noqa: E402

PACKAGES = {
    "port": SimpleNamespace(lc=tlc, events=tevents, metrics=tmetrics, env_str=tenv_str),
    "reference": SimpleNamespace(lc=jlc, events=jevents, metrics=jmetrics, env_str=jenv_str),
}

STALL_MS = "50"
HOLD_S = 0.5


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """One package's lockcheck with its own events and metrics, the
    global state reset before and after."""
    p = PACKAGES[request.param]
    p.lc.reset()
    try:
        yield p
    finally:
        p.lc.reset()


@pytest.fixture(autouse=True)
def plain_metric_locks():
    """Every metric first made in the port's process-wide registry while
    a test ran the sanitizer on took an instrumented lock, and would go
    on feeding ``lockcheck.hold_ms`` on every later read of the registry
    (a ``/metrics`` render included). Hand each such metric back its
    plain primitive once the test is over: the metric and its values
    stay, the recording stops."""
    yield
    for m in tmetrics.default_registry.metrics().values():
        if tlc.is_instrumented(m._lock):
            m._lock = m._lock._inner


@pytest.fixture
def event_log(pkg, tmp_path):
    prev = pkg.env_str(pkg.events.EVENT_LOG_ENV)
    path = tmp_path / "events.jsonl"
    pkg.events.configure(str(path))
    try:
        yield path
    finally:
        pkg.events.configure(prev if prev else None)


def lockcheck_events(path):
    if not path.exists():
        return []
    recs = [json.loads(line) for line in path.read_text().splitlines() if line]
    return [r for r in recs if r.get("event") == "lockcheck"]


def _hold_while_waiting(lock, hold_s: float = HOLD_S) -> bool:
    """A holder thread keeps ``lock`` ``hold_s`` while this thread
    acquires it (blocking past the watchdog); returns what acquire gave."""
    release = threading.Event()

    def holder():
        with lock:
            release.wait(hold_s)

    t = threading.Thread(target=holder, name="holder")
    t.start()
    while not lock.locked():
        time.sleep(0.001)
    got = lock.acquire()
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    lock.release()
    return got


# --- off: the factories hand back plain threading primitives ------------


class TestOffMode:
    def test_plain_primitives(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "off")
        assert type(lc.make_lock("t.a")) is type(threading.Lock())
        assert type(lc.make_rlock("t.b")) is type(threading.RLock())
        assert isinstance(lc.make_condition("t.c"), threading.Condition)
        assert not lc.is_instrumented(lc.make_lock("t.d"))
        assert not lc.is_instrumented(lc.make_condition("t.e"))

    def test_guarded_is_noop_on_plain(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "off")
        lc.guarded(lc.make_lock("t.a"), "anything")  # no lock held, still silent
        lc.guarded(lc.make_condition("t.c"), "anything")
        assert lc.violations() == []

    def test_default_mode_is_off(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.delenv(lc.MODE_ENV, raising=False)
        assert lc.mode() == "off"
        assert type(lc.make_lock("t.a")) is type(threading.Lock())


# --- guarded(): the runtime half of a guarded-by annotation -------------


class TestGuarded:
    def test_pass_when_held(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        lock = lc.make_lock("t.a")
        with lock:
            lc.guarded(lock, "C._x")
        assert lc.violations() == []

    def test_warn_records_and_emits(self, pkg, monkeypatch, event_log):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "warn")
        lc.guarded(lc.make_lock("t.a"), "C._x")  # seeded unguarded access
        vs = lc.violations()
        assert [v["kind"] for v in vs] == ["unguarded"] and vs[0]["lock"] == "t.a"
        recs = lockcheck_events(event_log)
        assert len(recs) == 1 and recs[0]["action"] == "unguarded" and recs[0]["lock"] == "t.a"
        assert not pkg.events.validate_record(recs[0])

    def test_strict_raises(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        with pytest.raises(lc.LockcheckError, match="unguarded"):
            lc.guarded(lc.make_lock("t.a"), "C._x")

    def test_condition_unwrap(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        cond = lc.make_condition("t.cond")
        with cond:
            lc.guarded(cond, "Q._dq")
        with pytest.raises(lc.LockcheckError):
            lc.guarded(cond, "Q._dq")

    def test_violation_counter(self, pkg, monkeypatch):
        lc, counter = pkg.lc, pkg.metrics.counter
        monkeypatch.setenv(lc.MODE_ENV, "warn")
        before = counter("lockcheck.violations",
                         "concurrency invariants the sanitizer saw violated").value(kind="unguarded")
        lc.guarded(lc.make_lock("t.a"), "C._x")
        assert counter("lockcheck.violations").value(kind="unguarded") == before + 1


# --- lock-order cycles: lockdep's trick, no hang required ---------------


class TestOrderCycle:
    def test_inversion_detected_single_thread(self, pkg, monkeypatch, event_log):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "warn")
        a, b = lc.make_lock("t.A"), lc.make_lock("t.B")
        with a:
            with b:
                pass
        with b:
            with a:  # seeded A->B / B->A inversion
                pass
        assert [v["kind"] for v in lc.violations()] == ["order-cycle"]
        recs = lockcheck_events(event_log)
        assert recs and recs[0]["action"] == "order-cycle" and set(recs[0]["cycle"]) == {"t.A", "t.B"}

    def test_inversion_detected_cross_thread(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "warn")
        a, b = lc.make_lock("t.A"), lc.make_lock("t.B")

        def forward():
            with a:
                with b:
                    pass

        t = threading.Thread(target=forward)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with b:
            with a:
                pass
        assert [v["kind"] for v in lc.violations()] == ["order-cycle"]

    def test_strict_raises_and_releases(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        a, b = lc.make_lock("t.A"), lc.make_lock("t.B")
        with a:
            with b:
                pass
        with pytest.raises(lc.LockcheckError, match="order cycle"):
            with b:
                with a:
                    pass
        # The raise leaves a consistent plane: nothing held, the inner
        # lock re-acquirable.
        assert lc.held_locks() == []
        assert a.acquire(timeout=0.5)
        a.release()

    def test_consistent_order_is_clean(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        a, b = lc.make_lock("t.A"), lc.make_lock("t.B")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert lc.violations() == []
        assert lc.order_graph() == {"t.A": ["t.B"]}

    def test_reentrant_is_not_an_edge(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        r = lc.make_rlock("t.R")
        with r:
            with r:
                assert lc.held_locks() == ["t.R"]
        assert lc.held_locks() == [] and lc.order_graph() == {} and lc.violations() == []


# --- the other violation kinds ------------------------------------------


class TestViolationKinds:
    def test_self_deadlock_strict(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        lock = lc.make_lock("t.a")
        lock.acquire()
        try:
            with pytest.raises(lc.LockcheckError, match="self-deadlock"):
                lock.acquire()
        finally:
            lock.release()

    def test_bad_release_strict(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        with pytest.raises(lc.LockcheckError, match="bad-release"):
            lc.make_lock("t.a").release()

    def test_stall_watchdog(self, pkg, monkeypatch, event_log):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")  # stalls never raise
        monkeypatch.setenv(lc.STALL_ENV, STALL_MS)
        assert _hold_while_waiting(lc.make_lock("t.slow"))
        stalls = [v for v in lc.violations() if v["kind"] == "stall"]
        assert len(stalls) == 1
        assert any(s["waiting"] == "t.slow" for s in stalls[0]["threads"])
        assert [r["action"] for r in lockcheck_events(event_log)] == ["stall"]


# --- bookkeeping exactness ----------------------------------------------


class TestBookkeeping:
    def test_condition_wait_notify(self, pkg, monkeypatch):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "strict")
        cond = lc.make_condition("t.cond")
        box = []

        def producer():
            with cond:
                box.append(1)
                cond.notify_all()

        t = threading.Thread(target=producer)
        with cond:
            assert lc.held_locks() == ["t.cond"]
            t.start()
            deadline = time.monotonic() + 5.0
            while not box:
                cond.wait(timeout=0.05)
                assert lc.held_locks() == ["t.cond"]  # re-acquired after every wait
                assert time.monotonic() < deadline
        t.join(timeout=10)
        assert not t.is_alive()
        assert lc.held_locks() == [] and lc.violations() == []

    def test_hold_histogram_labelled(self, pkg, monkeypatch):
        lc, histogram = pkg.lc, pkg.metrics.histogram
        monkeypatch.setenv(lc.MODE_ENV, "warn")
        lock = lc.make_lock("t.timed")
        before = histogram("lockcheck.hold_ms", "instrumented-lock hold time per acquisition",
                           buckets=lc.HOLD_MS_BUCKETS).value(lock="t.timed")["count"]
        for _ in range(3):
            with lock:
                pass
        assert histogram("lockcheck.hold_ms").value(lock="t.timed")["count"] == before + 3

    def test_graph_dump(self, pkg, monkeypatch, tmp_path):
        lc = pkg.lc
        monkeypatch.setenv(lc.MODE_ENV, "warn")
        out = tmp_path / "graph.json"
        monkeypatch.setenv(lc.GRAPH_ENV, str(out))
        a, b = lc.make_lock("t.A"), lc.make_lock("t.B")
        with a:
            with b:
                pass
        lc._dump_graph()
        doc = json.loads(out.read_text())
        assert doc["kind"] == "tpuml-lockcheck-graph"
        assert doc["edges"] == {"t.A": ["t.B"]} and doc["violations"] == []


# --- one script through both modules: the same record --------------------


def _scripted(lc, dump_path: str) -> dict:
    """An acquisition script with an order cycle over three locks, an
    unguarded read, a bad release and a reentrant re-acquisition, under
    ``warn``: the violations, the graph and the exit dump it leaves."""
    a, b, c = lc.make_lock("s.A"), lc.make_lock("s.B"), lc.make_lock("s.C")
    r = lc.make_rlock("s.R")
    cond = lc.make_condition("s.cond")
    with a:
        with b:
            pass
    with b:
        with c:
            with r:
                with r:
                    pass
    with c:
        with a:  # closes A -> B -> C -> A
            pass
    lc.guarded(cond, "Q._dq")
    with cond:
        lc.guarded(cond, "Q._dq")
        with a:
            pass
    try:
        b.release()
    except RuntimeError:
        pass  # threading's own error on an unheld lock, after the report
    lc._dump_graph()
    doc = json.load(open(dump_path))
    return {
        "violations": [(v["kind"], v["lock"], sorted(v.get("cycle", []))) for v in lc.violations()],
        "graph": lc.order_graph(),
        "held": lc.held_locks(),
        "dump_keys": sorted(doc),
        "dump": {k: doc[k] for k in ("kind", "mode", "edges")},
        "dump_violation_keys": [sorted(v) for v in doc["violations"]],
    }


def test_a_scripted_run_leaves_the_references_record(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUML_LOCKCHECK", "warn")
    got = {}
    for name, p in PACKAGES.items():
        p.lc.reset()
        monkeypatch.setenv("TPUML_LOCKCHECK_GRAPH", str(tmp_path / f"{name}.json"))
        try:
            got[name] = _scripted(p.lc, str(tmp_path / f"{name}.json"))
        finally:
            p.lc.reset()
    assert got["port"] == got["reference"]
    kinds = [v[0] for v in got["port"]["violations"]]
    assert kinds == ["order-cycle", "unguarded", "bad-release"]
    assert got["port"]["graph"]["s.cond"] == ["s.A"] and got["port"]["held"] == []


def test_the_port_module_is_the_references_surface():
    for name in ("MODE_ENV", "STALL_ENV", "GRAPH_ENV", "MODES", "HOLD_MS_BUCKETS"):
        assert getattr(tlc, name) == getattr(jlc, name)
    public = {n for n in dir(jlc) if not n.startswith("__") and callable(getattr(jlc, n))}
    assert public <= {n for n in dir(tlc) if callable(getattr(tlc, n))}


# --- stall hooks and the flight recorder's stall strike -------------------


def test_stall_hooks_run_once_per_strike_and_can_be_removed(monkeypatch):
    monkeypatch.setenv(tlc.MODE_ENV, "warn")
    monkeypatch.setenv(tlc.STALL_ENV, STALL_MS)
    seen = []
    hook = seen.append
    tlc.reset()
    tlc.add_stall_hook(hook)
    tlc.add_stall_hook(hook)  # idempotent per function object
    try:
        assert _hold_while_waiting(tlc.make_lock("t.hooked"))
        assert [r["lock"] for r in seen] == ["t.hooked"]
    finally:
        tlc.remove_stall_hook(hook)
    tlc.remove_stall_hook(hook)  # absent: a no-op
    assert _hold_while_waiting(tlc.make_lock("t.unhooked"))
    assert len(seen) == 1
    tlc.reset()


def test_a_stall_strike_writes_one_flight_dump_with_both_threads(monkeypatch, tmp_path):
    """Two strikes (a storm) write ONE ``stall`` dump; its ``locks`` holds
    the holder's held lock and the waiter's waited lock; ``disarm`` takes
    the hook back, so a later strike writes nothing."""
    monkeypatch.setenv(tlc.MODE_ENV, "strict")
    monkeypatch.setenv(tlc.STALL_ENV, STALL_MS)
    monkeypatch.setenv(flightrec.FLIGHT_DIR_ENV, str(tmp_path))
    # As a process started under strict makes them: the recorder's own
    # locks instrumented, taken by the waiter inside its stall report.
    monkeypatch.setattr(flightrec, "_arm_lock", tlc.make_lock("flightrec.arm"))
    monkeypatch.setattr(flightrec, "_dump_lock", tlc.make_lock("flightrec.dump"))
    tlc.reset()
    flightrec.reset()
    flightrec.arm()
    try:
        lock = tlc.make_lock("t.flight")
        assert _hold_while_waiting(lock) and _hold_while_waiting(lock)
        dumps = sorted(tmp_path.glob("flight-*.json"))
        assert len(dumps) == 1
        doc = json.loads(dumps[0].read_text())
        assert doc["reason"] == "stall" and doc["detail"]["lock"] == "t.flight"
        by_role = {s["thread"]: s for s in doc["locks"]}
        assert by_role["holder"]["held"] == ["t.flight"]
        assert by_role[threading.current_thread().name]["waiting"] == "t.flight"
        assert tlc.order_graph() == {}  # the report's own acquisitions add no edge
        assert [v["kind"] for v in tlc.violations()] == ["stall", "stall"]
    finally:
        flightrec.disarm()
        flightrec.reset()
    dumps[0].unlink()
    assert _hold_while_waiting(tlc.make_lock("t.after"))
    assert list(tmp_path.glob("flight-*.json")) == []
    tlc.reset()


def test_a_dump_outside_a_stall_lists_no_locks_when_the_sanitizer_is_off(monkeypatch, tmp_path):
    monkeypatch.delenv(tlc.MODE_ENV, raising=False)
    tlc.reset()
    flightrec.reset()
    path = flightrec.dump("test", path=str(tmp_path / "f.json"))
    assert json.load(open(path))["locks"] == []
    flightrec.reset()


# --- every lock site of the port ----------------------------------------

#: Every lock the port makes, by sanitizer name, with the kind of
#: primitive it fronts: 31 sites threaded through the factories, plus the
#: ops server's own lock.
SITES = {
    "params.uid": "lock", "core_serving.program": "lock", "core_serving.programs": "rlock",
    "core_serving.capture": "lock", "tracing.events": "lock", "metrics.site.c": "lock",
    "metrics.registry": "lock", "events.run_context": "lock", "events.sink": "lock",
    "profiling.active": "lock", "slo.monitor": "lock", "slo.active": "lock", "heartbeat.state": "lock",
    "costs.ledger": "lock", "costs.config": "lock", "costs.device_timer": "lock", "costs.keys": "lock",
    "autotune.store": "lock", "autotune.tuner": "lock", "autotune.config": "lock", "faults.plan": "lock",
    "checkpoint.pending": "lock", "serving.batcher": "lock", "serving.admission": "condition",
    "serving.registry": "rlock", "serving.runtime_seq": "lock", "pipeline_fusion.kernels": "lock",
    "native.loader": "lock", "kernels.build": "lock", "flightrec.arm": "lock", "flightrec.dump": "lock",
    "opsplane.state": "lock",
}

#: Prints, for every lock site, what the factory gave it: module-level
#: locks as imported, instance locks from a fresh owner.
_SITE_PROBE = r"""
import json, sys, tempfile
import torch
from spark_rapids_ml_tpu_torch import native
from spark_rapids_ml_tpu_torch.core import params, serving as core_serving
from spark_rapids_ml_tpu_torch.observability import autotune, costs, events, flightrec, heartbeat, opsplane
from spark_rapids_ml_tpu_torch.observability import profiling, slo
from spark_rapids_ml_tpu_torch.observability.metrics import Registry, default_registry
from spark_rapids_ml_tpu_torch.ops.kernels import _build
from spark_rapids_ml_tpu_torch.pipeline_fusion import fuser
from spark_rapids_ml_tpu_torch.robustness import checkpoint, faults
from spark_rapids_ml_tpu_torch.serving import ModelRegistry, server
from spark_rapids_ml_tpu_torch.serving.admission import AdmissionQueue
from spark_rapids_ml_tpu_torch.serving.batcher import MicroBatcher
from spark_rapids_ml_tpu_torch.utils import lockcheck as lc, tracing

queue = AdmissionQueue(4)
store = autotune.TuneStore()
locks = {
    "params.uid": params._uid_lock,
    "core_serving.program": core_serving._Program(lambda x: x, (), {}, 8, 2, torch.float32,
                                                  torch.device("cpu")).lock,
    "core_serving.programs": core_serving._LOCK, "core_serving.capture": core_serving._CAPTURE_LOCK,
    "tracing.events": tracing._events_lock, "metrics.site.c": Registry().counter("site.c")._lock,
    "metrics.registry": default_registry._lock,
    "events.run_context": events.RunContext("r", "fit", "x")._lock, "events.sink": events._sink_lock,
    "profiling.active": profiling._lock, "slo.monitor": slo.SloMonitor()._lock, "slo.active": slo._active_lock,
    "heartbeat.state": heartbeat.GangHeartbeat(manual=True)._lock, "costs.ledger": costs.Ledger()._lock,
    "costs.config": costs._config_lock, "costs.device_timer": costs._TIMER._lock, "costs.keys": costs._keys_lock,
    "autotune.store": store._lock, "autotune.tuner": autotune.Autotuner(store)._lock,
    "autotune.config": autotune._config_lock,
    "faults.plan": faults.FaultPlan(faults.parse_spec("ingest.device_put=1"))._lock,
    "checkpoint.pending": checkpoint.FitCheckpointer(tempfile.mkdtemp(), "u", "h", "f", 1)._lock,
    "serving.batcher": MicroBatcher(queue)._lock, "serving.admission": queue._cond,
    "serving.registry": ModelRegistry()._lock, "serving.runtime_seq": server._runtime_seq_lock,
    "pipeline_fusion.kernels": fuser._KERNEL_LOCK, "native.loader": native._lock, "kernels.build": _build._lock,
    "flightrec.arm": flightrec._arm_lock, "flightrec.dump": flightrec._dump_lock, "opsplane.state": opsplane._lock,
}
out = {}
for name, lock in locks.items():
    inner = lc._unwrap(lock)
    out[name] = {"outer": type(lock).__name__, "inner": type(inner).__name__,
                 "instrumented": lc.is_instrumented(lock), "name": getattr(inner, "name", None),
                 "reentrant": getattr(inner, "reentrant", None)}
print(json.dumps({"mode": lc.mode(), "locks": out}))
"""


def _probe_sites(tmp_path, mode: str) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_LOCKCHECK")}
    if mode != "unset":
        env["TPUML_LOCKCHECK"] = mode
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", _SITE_PROBE], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


_PLAIN = {"lock": ("lock", "lock"), "rlock": ("RLock", "RLock"), "condition": ("Condition", "RLock")}


def test_every_lock_site_is_a_plain_primitive_with_the_sanitizer_unset(tmp_path):
    doc = _probe_sites(tmp_path, "unset")
    assert doc["mode"] == "off" and set(doc["locks"]) == set(SITES)
    for name, got in doc["locks"].items():
        assert not got["instrumented"], name
        assert (got["outer"], got["inner"]) == _PLAIN[SITES[name]], (name, got)


def test_every_lock_site_is_instrumented_under_its_name_under_strict(tmp_path):
    doc = _probe_sites(tmp_path, "strict")
    assert doc["mode"] == "strict" and set(doc["locks"]) == set(SITES)
    for name, got in doc["locks"].items():
        assert got["instrumented"] and got["name"] == name, (name, got)
        assert got["reentrant"] == (SITES[name] != "lock"), (name, got)
        assert got["outer"] == ("Condition" if SITES[name] == "condition" else "_InstrumentedLock"), (name, got)


def test_the_factories_are_the_only_lock_constructors_in_the_port():
    """No module of the port builds a ``threading`` lock itself: every
    one goes through ``utils/lockcheck.py``'s factories (which hold the
    sanitizer's own plain state lock)."""
    import re

    pattern = re.compile(r"threading\.(R?Lock|Condition)\(")
    found = []
    for path in sorted((REPO / "spark_rapids_ml_tpu_torch").rglob("*.py")):
        if path.name == "lockcheck.py":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line) and not line.lstrip().startswith("#"):
                found.append(f"{path.relative_to(REPO)}:{i}")
    assert found == []


# --- every family and a 16-thread runtime under strict --------------------

#: Fits one model of every family and serves a 16-thread closed loop,
#: unbatched and batched (then a hot swap and a retire), writing every
#: output to OUT.npz and the sanitizer's record to OUT.json.
FAMILIES_SCRIPT = r"""
import json, sys, threading
import numpy as np
import torch
from spark_rapids_ml_tpu_torch import device
from spark_rapids_ml_tpu_torch.classification import LogisticRegression, RandomForestClassifier
from spark_rapids_ml_tpu_torch.clustering import DBSCAN, KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.manifold import UMAP
from spark_rapids_ml_tpu_torch.neighbors import ApproximateNearestNeighbors, NearestNeighbors
from spark_rapids_ml_tpu_torch.regression import LinearRegression, RandomForestRegressor
from spark_rapids_ml_tpu_torch.serving import ServingRuntime
from spark_rapids_ml_tpu_torch.utils import lockcheck

device.set_platform("cpu")
rng = np.random.default_rng(21)
x = rng.normal(size=(120, 4))
y = (x[:, 0] > 0).astype(float)
x32 = x.astype(np.float32)
fits = {
    "kmeans": (KMeans().setK(3).setSeed(1), x, lambda m: m.predict(x)),
    "pca": (PCA().setK(2), x, lambda m: m.transform(x)),
    "linear": (LinearRegression().setRegParam(0.1), (x, x @ np.arange(4.0)), lambda m: m.predict(x)),
    "logistic": (LogisticRegression().setMaxIter(10), (x, y), lambda m: m.predictProbability(x)),
    "forest_classifier": (RandomForestClassifier().setNumTrees(3).setMaxDepth(3).setSeed(0), (x, y),
                          lambda m: m.predictProbability(x)),
    "forest_regressor": (RandomForestRegressor().setNumTrees(3).setMaxDepth(3).setSeed(0), (x, y),
                         lambda m: m.predict(x)),
    "dbscan": (DBSCAN().setEps(0.8).setMinSamples(3), x, lambda m: m.transform(x)),
    "umap": (UMAP().setNNeighbors(5).setNEpochs(10).setSeed(0), x32, lambda m: m.transform(x32)),
    "nearest_neighbors": (NearestNeighbors().setK(3), x, lambda m: m.kneighbors(x)),
    "ann": (ApproximateNearestNeighbors().setK(3).setAlgorithm("brute"), x, lambda m: m.kneighbors(x)),
}
arrays = {}
for name, (est, data, read) in fits.items():
    out = read(est.fit(data))
    for i, a in enumerate(out if isinstance(out, (tuple, list)) else (out,)):
        arrays[f"{name}_{i}"] = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

centres = rng.normal(size=(8, 4)) * 3
probes = rng.normal(size=(16, 20, 4)) * 3
for label, (max_batch, delay_ms) in {"unbatched": (1, 0.0), "batched": (16, 5.0)}.items():
    rt = ServingRuntime(max_batch=max_batch, max_delay_ms=delay_ms, queue_limit=4 * probes[..., 0].size)
    rt.register("km", KMeansModel("lc-km", centres))
    rt.warm("km", buckets=[1 << p for p in range(5) if (1 << p) <= max_batch])
    answers = np.zeros(probes.shape[:2], dtype=np.int64)

    def worker(t):
        for j in range(probes.shape[1]):
            answers[t, j] = rt.submit("km", probes[t, j]).result(timeout=60)[0]

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(probes.shape[0])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    swapped = rt.register("km", KMeansModel("lc-km2", centres + 0.5))
    rt.set_alias("km", "prod", swapped.version)
    arrays[f"serving_{label}_swap"] = np.asarray(rt.submit("km@prod", probes[0, 0]).result(timeout=60))
    rt.retire("km", 1)
    rt.close()
    arrays[f"serving_{label}"] = answers
np.savez(sys.argv[1] + ".npz", **arrays)
with open(sys.argv[1] + ".json", "w") as fh:
    json.dump({"mode": lockcheck.mode(), "violations": lockcheck.violations(),
               "graph": lockcheck.order_graph()}, fh, default=str)
"""


def acyclic(edges: dict) -> bool:
    """Whether the name -> successors graph has no cycle (DFS colouring)."""
    state = {}

    def visit(node) -> bool:
        state[node] = 1
        for nxt in edges.get(node, ()):
            if state.get(nxt) == 1 or (nxt not in state and not visit(nxt)):
                return False
        state[node] = 2
        return True

    return all(state.get(n) == 2 or visit(n) for n in list(edges))


def _run_families(tmp_path, mode: str, **knobs):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TPUML_LOCKCHECK", "TPUML_OPS"))}
    env.update(PYTHONPATH=str(REPO), TPUML_LOCKCHECK=mode, TPUML_COST_LEDGER="1", **knobs)
    out = tmp_path / mode
    r = subprocess.run([sys.executable, "-c", FAMILIES_SCRIPT, str(out)], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(f"{out}.npz")), json.loads(Path(f"{out}.json").read_text())


def test_every_family_and_a_16_thread_runtime_under_strict_are_bitwise_off(tmp_path):
    graph_path = tmp_path / "graph.json"
    off, off_doc = _run_families(tmp_path, "off")
    strict, doc = _run_families(tmp_path, "strict", TPUML_LOCKCHECK_GRAPH=str(graph_path))
    assert off_doc["mode"] == "off" and doc["mode"] == "strict"
    assert sorted(strict) == sorted(off) and len(off) >= 14
    for key in off:
        assert strict[key].dtype == off[key].dtype and strict[key].tobytes() == off[key].tobytes(), key
    assert doc["violations"] == []
    dumped = json.loads(graph_path.read_text())
    assert dumped["kind"] == "tpuml-lockcheck-graph" and dumped["violations"] == []
    assert dumped["edges"] == doc["graph"] and acyclic(dumped["edges"])
    names = set(dumped["edges"]) | {d for dsts in dumped["edges"].values() for d in dsts}
    assert {"core_serving.programs", "core_serving.capture", "serving.registry", "metrics.registry"} <= names
    assert names <= set(SITES) | {n for n in names if n.startswith("metrics.")}


def test_acyclic_finds_a_cycle():
    assert acyclic({"a": ["b"], "b": ["c"]}) and not acyclic({"a": ["b"], "b": ["c"], "c": ["a"]})


# --- lock order on the serving path, in one process -----------------------


def test_the_serving_path_takes_its_locks_in_one_order(monkeypatch):
    """Under ``strict``, a capture (here the CPU build of a program),
    replays from many threads, an eviction refill, a hot swap and a
    retire nest the program cache's locks in one order: the capture lock
    before the programs lock, each before the metrics; the registry's
    before the metrics. No edge runs back."""
    from spark_rapids_ml_tpu_torch import device as port_device
    from spark_rapids_ml_tpu_torch.clustering import KMeansModel
    from spark_rapids_ml_tpu_torch.core import serving as core_serving
    from spark_rapids_ml_tpu_torch.serving import ModelRegistry, ServingRuntime
    from spark_rapids_ml_tpu_torch.utils import lockcheck

    monkeypatch.setenv("TPUML_LOCKCHECK", "strict")
    monkeypatch.setenv("TPUML_SERVING_CACHE_SIZE", "2")
    port_device.set_platform("cpu")
    # Instance and module locks made now follow the mode: swap the
    # module-level ones for instrumented twins for this test only.
    monkeypatch.setattr(core_serving, "_LOCK", lockcheck.make_rlock("core_serving.programs"))
    monkeypatch.setattr(core_serving, "_CAPTURE_LOCK", lockcheck.make_lock("core_serving.capture"))
    lockcheck.reset()
    core_serving.clear_program_cache()
    try:
        rng = np.random.default_rng(3)
        centres = rng.normal(size=(6, 4))
        rt = ServingRuntime(ModelRegistry(), max_batch=4, max_delay_ms=1.0)
        rt.register("km", KMeansModel("order-km", centres))
        rows = rng.normal(size=(8, 12, 4))
        want = KMeansModel("order-km", centres).predict(rows.reshape(-1, 4)).reshape(8, 12)
        got = np.zeros((8, 12), dtype=np.int64)

        def worker(t):
            for j in range(rows.shape[1]):
                got[t, j] = rt.submit("km", rows[t, j]).result(timeout=60)[0]

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for n in (1, 3, 9, 1):  # over a cache of two: evictions, then a refill
            KMeansModel("order-km", centres).predict(rows[0, :n])
        swapped = rt.register("km", KMeansModel("order-km2", centres + 1.0))
        rt.set_alias("km", "prod", swapped.version)
        rt.submit("km@prod", rows[0, 0]).result(timeout=60)
        rt.retire("km", 1)
        rt.close()
        np.testing.assert_array_equal(got, want)
        graph = lockcheck.order_graph()
        assert lockcheck.violations() == [] and acyclic(graph)
        assert "core_serving.programs" in graph["core_serving.capture"]
        assert "core_serving.capture" not in graph.get("core_serving.programs", [])
        assert core_serving.program_cache_stats()["evictions"] >= 1
    finally:
        core_serving.clear_program_cache()
        lockcheck.reset()


# --- the static half ------------------------------------------------------


def test_the_lint_lock_family_finds_nothing_in_the_port():
    """``tools/tpuml_lint``'s lock checks (``lock-guarded``,
    ``lock-unknown``, ``lock-order``, ``lock-leak``) over every module of
    the port, and the annotations it proves are there."""
    findings, annotated = [], 0
    for path in sorted((REPO / "spark_rapids_ml_tpu_torch").rglob("*.py")):
        findings += [f"{f.path}:{f.line} {f.rule} {f.message}"
                     for f in tl.lint_file(REPO, path, (lint_locks.check,)) if f.rule.startswith("lock-")]
        annotated += sum("# guarded-by:" in line for line in path.read_text().splitlines())
    assert findings == []
    assert annotated >= 50


def test_the_lint_sees_a_seeded_unguarded_write_in_port_style(tmp_path):
    """The same family does flag a port-style module that breaks its
    annotation, so the clean sweep above means something."""
    f = tmp_path / "seeded.py"
    f.write_text(
        "from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock\n"
        "_lock = make_lock('seeded')\n"
        "_state = {}  # guarded-by: _lock\n"
        "def touch():\n"
        "    _state['x'] = 1\n"
    )
    rules = {x.rule for x in tl.lint_file(tmp_path, f, (lint_locks.check,))}
    assert rules == {"lock-guarded"}
