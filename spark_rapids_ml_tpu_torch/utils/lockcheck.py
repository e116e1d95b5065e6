"""Runtime concurrency sanitizer: instrumented locks, order/race checks.

The dynamic half of the repo's concurrency discipline. The static half
(``tools/tpuml_lint/locks.py``) proves ``# guarded-by:`` annotations
interprocedurally at lint time; this module checks the same invariants
on the *running* thread plane — the MicroBatcher dispatcher, the
admission queue, the async checkpoint writer, heartbeat/HBM daemons —
the way TSan/lockdep check compiled code:

  - :func:`make_lock` / :func:`make_rlock` / :func:`make_condition` are
    the factory every lock-holding module creates its primitives
    through. Under ``TPUML_LOCKCHECK=off`` (the default) they return
    plain ``threading`` primitives — zero overhead, zero allocation
    beyond the primitive itself, nothing to observe. Under ``warn`` or
    ``strict`` they return an :class:`_InstrumentedLock` that tracks
    its owner, the per-thread held-lock stack, and hold times.
  - Every first (non-reentrant) acquisition adds held-lock -> new-lock
    edges to one process-global acquisition-order graph; an edge that
    closes a cycle is a potential deadlock — two threads interleaving
    those scopes in opposite orders would wait on each other forever —
    reported the moment the *order* exists, no hang required (lockdep's
    trick). Reentrant re-acquisition is not an edge.
  - :func:`guarded` is the runtime mirror of a ``# guarded-by:``
    annotation: assert the calling thread holds the lock. On a plain
    primitive (sanitizer off) it is a type-check and a return.
  - A stall watchdog: a blocking acquire that waits longer than
    ``TPUML_LOCKCHECK_STALL_MS`` emits one structured ``lockcheck``
    event carrying every thread's held/waited locks, then keeps
    waiting. Stalls never raise, even under ``strict`` — a slow lock is
    evidence, not proof.
  - Hold times feed the ``lockcheck.hold_ms`` histogram (labelled by
    lock name) in the metrics registry (``observability/metrics.py``).

Violations (unguarded access, order cycle, self-deadlock on a
non-reentrant lock, releasing an unowned lock) raise
:class:`LockcheckError` under ``strict`` and emit a ``lockcheck`` event
under ``warn``; both modes record them for :func:`violations` and the
``TPUML_LOCKCHECK_GRAPH`` exit dump.

Import discipline: this module top-imports only stdlib and
``utils/envknobs``; metrics and events are imported lazily inside the
reporting paths, under a thread-local busy flag, because ``emit()`` and
``Histogram.observe()`` themselves acquire instrumented locks — the
flag suppresses nested bookkeeping so the sanitizer never recurses into
itself.

Port of the reference's ``utils/lockcheck.py``, stdlib only, with two
differences. :func:`remove_stall_hook` is added, so ``flightrec.disarm``
takes back the hook ``flightrec.arm`` installs. Stall hooks run under the
busy flag, and a busy thread's acquisitions leave the thread table as it
was: the port's flight-recorder locks are instrumented (the reference's
are plain), and the dump a stall hook writes from the waiting thread must
still show that thread waiting. Every lock of the port is made
here. Its names follow the reference's (``params.uid``,
``core_serving.programs``, ``serving.admission``, ...), and the locks
that only the port has take names in the same scheme:

  - ``kernels.build`` — one ``nvcc`` build at a time
    (``ops/kernels/_build.py``);
  - ``core_serving.program`` — one captured program's own lock (its
    graph, buckets and replays; ``core/serving.py``);
  - ``core_serving.capture`` — one CUDA graph capture at a time, per
    process (``core/serving.py``);
  - ``costs.device_timer`` — a device timer's pending event pairs
    (``observability/costs.py``);
  - ``costs.keys`` — the cache of program keys (``observability/costs.py``);
  - ``flightrec.arm`` and ``flightrec.dump`` — the flight recorder's
    hook installation and its once-per-reason dump set
    (``observability/flightrec.py``).
"""

from __future__ import annotations

import atexit
import json
import threading
import time
from typing import Dict, List, Optional, Set

from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice, env_float, env_str

MODE_ENV = "TPUML_LOCKCHECK"
STALL_ENV = "TPUML_LOCKCHECK_STALL_MS"
GRAPH_ENV = "TPUML_LOCKCHECK_GRAPH"

MODES = ("off", "warn", "strict")

#: Buckets for the hold-time histogram: locks here guard dict updates
#: and queue ops (sub-ms), with the long tail for lock-held compiles.
HOLD_MS_BUCKETS = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 1000.0, 10000.0
)


class LockcheckError(RuntimeError):
    """A concurrency invariant the sanitizer can prove was violated."""


def mode() -> str:
    """The sanitizer mode, read from the environment per call — the
    factories consult it at lock creation, the violation path at report
    time, so flipping the knob between tests needs no reconfigure."""
    return env_choice(MODE_ENV, MODES, "off")


def stall_ms() -> float:
    return float(env_float(STALL_ENV, default=30000.0, minimum=0.0))


# --- process-global state (guarded by one PLAIN lock: the sanitizer
# must never wait on an instrumented primitive) -------------------------

_state_lock = threading.Lock()
_order: Dict[str, Set[str]] = {}  # guarded-by: _state_lock
_threads: Dict[int, dict] = {}  # guarded-by: _state_lock
_violation_log: List[dict] = []  # guarded-by: _state_lock
_dump_registered = False  # guarded-by: _state_lock

_tls = threading.local()


def _held() -> List["_InstrumentedLock"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _busy() -> bool:
    return getattr(_tls, "busy", False)


class _quiet:
    """Suppress nested sanitizer bookkeeping on the current thread while
    the sanitizer itself calls into metrics/events."""

    def __enter__(self):
        self._prev = _busy()
        _tls.busy = True

    def __exit__(self, *exc):
        _tls.busy = self._prev
        return False


def _publish_thread_state(waiting: Optional[str]) -> None:
    if _busy():
        return  # the sanitizer's own acquisitions are not the thread's state
    ident = threading.get_ident()
    with _state_lock:
        _threads[ident] = {
            "thread": threading.current_thread().name,
            "held": [lk.name for lk in _held()],
            "waiting": waiting,
        }


def _path(adj: Dict[str, Set[str]], start: str, goal: str
          ) -> Optional[List[str]]:
    parent: Dict[str, Optional[str]] = {start: None}
    queue = [start]
    while queue:
        cur = queue.pop(0)
        if cur == goal:
            out = [cur]
            while parent[cur] is not None:
                cur = parent[cur]
                out.append(cur)
            return list(reversed(out))
        for nxt in sorted(adj.get(cur, ())):
            if nxt not in parent:
                parent[nxt] = cur
                queue.append(nxt)
    return None


def dump_state() -> List[dict]:
    """Every live thread's held/waited locks (the stall-event payload)."""
    alive = {t.ident for t in threading.enumerate()}
    with _state_lock:
        return [
            dict(state, ident=ident)
            for ident, state in sorted(_threads.items())
            if ident in alive and (state["held"] or state["waiting"])
        ]


def order_graph() -> Dict[str, List[str]]:
    """The acquisition-order edges observed so far (name -> successors)."""
    with _state_lock:
        return {src: sorted(dsts) for src, dsts in sorted(_order.items())}


def violations() -> List[dict]:
    with _state_lock:
        return [dict(v) for v in _violation_log]


def reset() -> None:
    """Drop the global order graph / thread table / violation log.
    Test isolation only — live locks keep working, they just re-derive
    their edges."""
    with _state_lock:
        _order.clear()
        _threads.clear()
        _violation_log.clear()


#: Stall-strike observers (``add_stall_hook``): called with the violation
#: record on every watchdog strike. The flight recorder registers one so
#: a wedged process dumps its ring BEFORE anyone has to kill it. Plain
#: list appends/iteration — lockcheck must not depend on observability
#: (the metrics registry's locks are built by THIS module).
_stall_hooks: List = []


def add_stall_hook(fn) -> None:
    """Register ``fn(record: dict)`` to run on every stall strike.
    Idempotent per function object."""
    if fn not in _stall_hooks:
        _stall_hooks.append(fn)


def remove_stall_hook(fn) -> None:
    """Unregister a hook :func:`add_stall_hook` installed (absent: no-op)."""
    if fn in _stall_hooks:
        _stall_hooks.remove(fn)


def _report(kind: str, lock_name: str, detail: str,
            fatal_in_strict: bool = True, **extra) -> None:
    """Record one violation; emit under warn, raise under strict."""
    rec = {"kind": kind, "lock": lock_name, "detail": detail, **extra}
    with _state_lock:
        _violation_log.append(rec)
    if kind == "stall":
        # Quiet: a hook's own acquisitions (the flight recorder's locks,
        # the metrics it snapshots) add no order edge and leave the
        # waiting thread's published state as it is, so a dump taken here
        # shows the thread still waiting.
        with _quiet():
            for fn in list(_stall_hooks):
                try:
                    fn(rec)
                except Exception:  # pragma: no cover - hooks must never kill
                    pass
    if not _busy():  # a violation seen DURING telemetry is logged only —
        # reporting it through telemetry again would recurse
        with _quiet():
            try:
                from spark_rapids_ml_tpu_torch.observability.events import emit
                from spark_rapids_ml_tpu_torch.observability.metrics import counter

                counter("lockcheck.violations",
                        "concurrency invariants the sanitizer saw violated"
                        ).inc(kind=kind)
                emit("lockcheck", action=kind, lock=lock_name, detail=detail,
                     **extra)
            except Exception:  # pragma: no cover - telemetry must never kill
                pass
    if fatal_in_strict and mode() == "strict":
        raise LockcheckError(f"{kind}: {detail}")


def _record_edges(held_names: List[str], new_name: str,
                  fatal: bool = True) -> None:
    cycles: List[List[str]] = []
    with _state_lock:
        for held_name in held_names:
            if held_name == new_name:
                continue
            dsts = _order.setdefault(held_name, set())
            if new_name in dsts:
                continue
            back = _path(_order, new_name, held_name)
            dsts.add(new_name)
            if back is not None:  # back runs new_name..held_name inclusive
                cycles.append([held_name] + back[:-1])
    for cyc in cycles:
        _report(
            "order-cycle", cyc[0],
            "lock acquisition-order cycle: " + " -> ".join(cyc + [cyc[0]])
            + " — two threads taking these locks in opposite orders "
            "deadlock",
            fatal_in_strict=fatal,
            cycle=list(cyc),
        )


def _register_dump() -> None:
    global _dump_registered
    with _state_lock:
        if _dump_registered:
            return
        _dump_registered = True
    atexit.register(_dump_graph)


def _dump_graph() -> None:
    path = env_str(GRAPH_ENV)
    if not path:
        return
    try:
        doc = {
            "kind": "tpuml-lockcheck-graph",
            "mode": mode(),
            "edges": order_graph(),
            "violations": violations(),
            "threads": dump_state(),
        }
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2)
    except Exception:  # pragma: no cover - exit dump is best-effort
        pass


# --- the instrumented primitive ----------------------------------------


class _InstrumentedLock:
    """A Lock/RLock front that tracks ownership, the per-thread held
    stack, order edges, hold times, and stalls. Implements the private
    protocol ``threading.Condition`` drives (``_is_owned`` /
    ``_release_save`` / ``_acquire_restore``), so ``wait()`` keeps the
    bookkeeping exact across the release-and-reacquire."""

    __slots__ = ("name", "reentrant", "_inner", "_owner", "_count", "_t0")

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0
        self._t0 = 0.0
        _register_dump()

    def __repr__(self) -> str:
        owner = self._owner
        state = f"held by {owner}" if owner is not None else "unlocked"
        kind = "rlock" if self.reentrant else "lock"
        return f"<lockcheck {kind} {self.name!r} {state}>"

    # --- acquisition ----------------------------------------------------

    def _wait_inner(self, blocking: bool, timeout: float) -> bool:
        """The actual wait, with the stall watchdog on indefinite ones."""
        if not blocking:
            return self._inner.acquire(False)
        if timeout >= 0:
            return self._inner.acquire(True, timeout)
        if self._inner.acquire(False):  # uncontended fast path
            return True
        limit_s = 0.0 if _busy() else stall_ms() / 1000.0
        _publish_thread_state(waiting=self.name)
        try:
            if limit_s <= 0:
                return self._inner.acquire()
            if self._inner.acquire(True, limit_s):
                return True
            _report(
                "stall", self.name,
                f"waited more than {limit_s * 1000:.0f} ms "
                f"({STALL_ENV}) to acquire {self.name!r}",
                fatal_in_strict=False,  # slow is evidence, not proof
                waited_ms=limit_s * 1000.0,
                threads=dump_state(),
            )
            return self._inner.acquire()
        finally:
            _publish_thread_state(waiting=None)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:
            if not self.reentrant:
                # Guaranteed self-deadlock: report BEFORE waiting on it.
                # strict raises here; warn proceeds into the wait (the
                # stall watchdog then documents the hang).
                _report(
                    "self-deadlock", self.name,
                    f"thread {threading.current_thread().name!r} "
                    f"re-acquired non-reentrant lock {self.name!r} "
                    "it already holds",
                )
            got = self._wait_inner(blocking, timeout)
            if got:
                self._count += 1
            return got
        got = self._wait_inner(blocking, timeout)
        if not got:
            return False
        held = _held()
        # Sanitizer-internal acquisitions (metric locks taken while
        # observing a hold, the event sink's lock during a report) must
        # not add user-visible order edges: they are leaf acquisitions
        # by construction and would only pollute the graph.
        if held and not _busy():
            try:
                _record_edges([lk.name for lk in held], self.name)
            except LockcheckError:
                self._inner.release()  # leave a consistent lock behind
                raise
        self._owner = me
        self._count = 1
        self._t0 = time.perf_counter()
        held.append(self)
        _publish_thread_state(waiting=None)
        return True

    # --- release --------------------------------------------------------

    def _observe_hold(self, t0: float) -> None:
        """Feed the hold-time histogram. MUST run after the physical
        release: the histogram lives in the metrics registry, whose own
        locks are instrumented — observing while still owning this lock
        would re-enter it (the registry lock's release observes its own
        hold through the registry)."""
        if _busy():
            return  # a hold inside sanitizer bookkeeping
        ms = (time.perf_counter() - t0) * 1000.0
        with _quiet():
            try:
                from spark_rapids_ml_tpu_torch.observability.metrics import (
                    histogram,
                )

                histogram(
                    "lockcheck.hold_ms",
                    "instrumented-lock hold time per acquisition",
                    buckets=HOLD_MS_BUCKETS,
                ).observe(ms, lock=self.name)
            except Exception:  # pragma: no cover - metrics unavailable
                pass

    def _forget_hold(self) -> None:
        """Drop owner/held-stack state for the outermost release."""
        self._owner = None
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        _publish_thread_state(waiting=None)

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner != me:
            _report(
                "bad-release", self.name,
                f"thread {threading.current_thread().name!r} released "
                f"{self.name!r} without owning it",
            )
            self._inner.release()  # surface threading's own error too
            return
        self._count -= 1
        if self._count == 0:
            t0 = self._t0
            self._forget_hold()
            self._inner.release()
            self._observe_hold(t0)
        else:
            self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._owner is not None

    # --- the protocol threading.Condition drives ------------------------

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        """Fully release (whatever the reentrancy depth) for a
        ``Condition.wait``; returns the state to restore."""
        count = self._count
        t0 = self._t0
        self._count = 0
        self._forget_hold()
        if self.reentrant:
            for _ in range(count):
                self._inner.release()
        else:
            self._inner.release()
        self._observe_hold(t0)
        return count

    def _acquire_restore(self, count) -> None:
        self._wait_inner(True, -1)
        if self.reentrant:
            for _ in range(int(count) - 1):
                self._inner.acquire()
        self._owner = threading.get_ident()
        self._count = int(count)
        self._t0 = time.perf_counter()
        held = _held()
        if held and not _busy():
            # Never fatal: raising inside Condition.wait's re-acquire
            # would hand back a broken condition — record and move on.
            _record_edges([lk.name for lk in held], self.name, fatal=False)
        held.append(self)
        _publish_thread_state(waiting=None)


# --- the factory -------------------------------------------------------


def make_lock(name: str):
    """A mutex for ``name`` (dotted ``module.lock`` by convention):
    plain ``threading.Lock`` when the sanitizer is off, instrumented
    otherwise."""
    if mode() == "off":
        return threading.Lock()
    return _InstrumentedLock(name, reentrant=False)


def make_rlock(name: str):
    if mode() == "off":
        return threading.RLock()
    return _InstrumentedLock(name, reentrant=True)


def make_condition(name: str, lock=None) -> threading.Condition:
    """A condition variable whose underlying lock is instrumented when
    the sanitizer is on (``threading.Condition`` drives the private
    owner-tracking protocol, so ``wait()`` bookkeeping stays exact)."""
    if mode() == "off":
        return threading.Condition(lock)
    if lock is None:
        lock = _InstrumentedLock(name, reentrant=True)
    return threading.Condition(lock)


def _unwrap(lock):
    if isinstance(lock, threading.Condition):
        return lock._lock
    return lock


def guarded(lock, what: str = "") -> None:
    """Runtime mirror of a ``# guarded-by:`` annotation: assert the
    calling thread holds ``lock`` (a factory-made lock or condition).
    Where the static pass proves the invariant this is a double-check
    under strict runs; where it cannot (cross-module callers), it
    is the enforcement. No-op on plain primitives (sanitizer off)."""
    lock = _unwrap(lock)
    if not isinstance(lock, _InstrumentedLock):
        return
    if lock._is_owned():
        return
    subject = what or "state"
    _report(
        "unguarded", lock.name,
        f"{subject} (guarded-by {lock.name}) touched by thread "
        f"{threading.current_thread().name!r} without holding the lock",
    )


def held_locks() -> List[str]:
    """Names of instrumented locks the calling thread holds (tests)."""
    return [lk.name for lk in _held()]


def is_instrumented(lock) -> bool:
    return isinstance(_unwrap(lock), _InstrumentedLock)
