"""RoutingRuntime — the multi-process serving front door.

Port of the reference's ``serving/router.py``: one router process
spreading micro-batch traffic across N :mod:`serving.worker` member
processes, each a full :class:`ServingRuntime` with its own admission
queue, micro-batcher and program cache (on the card, its own CUDA context
and CUDA graphs; several members may share one card). The façade is the
``submit`` / ``submit_many`` / ``close`` contract the in-process runtime
exposes, so callers scale from one process to a gang by swapping the
constructor.

Three mechanisms carry the design:

- **Backpressure-driven member selection.** Every worker reply
  piggy-backs its live queue depth; the router picks the member with the
  lowest ``outstanding + reported depth`` (weighted least-loaded). A
  member that sheds answers with its ``Overloaded.retry_after_ms`` hint
  (p95 of ITS latency histogram) and the router skips it for exactly
  that window while transparently retrying the request on the next-best
  member. Only when every member is shedding or backed off does the
  caller see an :class:`Overloaded` (with the soonest-recovery hint).

- **Replicated registry with version-atomic hot swap.** Registry
  mutations replicate as an lsn-ordered op log; ``ModelRegistry``
  assigns versions monotonically per name, so identical log order yields
  identical version numbers on every member (asserted on every ack).
  Alias flips are two-phase: warm the target version on EVERY member,
  replicate the alias, and only then flip the ROUTER's alias, the
  resolution traffic actually reads. Every request ships a concrete
  ``(name, version)``, and each member's coalescing key carries the
  version, so no batch anywhere can mix versions and no request sheds
  over a swap.

- **Sharded oversized requests.** A single request too big for any one
  member's admission budget would shed everywhere; the router instead
  executes it locally over the device mesh (``parallel/distributed.
  global_mesh``): rows padded to the data shards and placed as
  :class:`~spark_rapids_ml_tpu_torch.parallel.mesh.ShardedRows`, weights
  replicated once per ``(name, version)``, the signature's kernel run on
  each shard, the shards concatenated and the padding cut off. The
  reference runs the same request through ``core/serving``'s plain-jit
  GSPMD fallback; the port's ``core/serving`` has no sharded path, so the
  route is built here on the port's own mesh. On dyadic rows its answer
  equals a member's bit for bit.

The trace carrier rides every routed request, so the router's route
event and the member's enqueue/dispatch/complete events merge into ONE
trace per request across the process hop (``tools/tpuml_trace.py``).

**Elastic membership.** The gang is not static: :meth:`add_member` grows
it under live load (spawn, connect, replay the retained lsn-ordered op
log, and only then admit the member to the selection set), so a join
sheds zero requests. :meth:`retire_member` is the inverse,
drain-then-detach. Every member's frame loop reports its heartbeat age
over the wire (``beat`` frames); :meth:`retire_stalled` force-detaches a
member whose age says STUCK before its socket ever EOFs.
``serving/elastic.py`` drives all three from the load signals the router
already tracks.

**Platform.** The router's platform (``device.get_platform()`` when it
is built) rides each spawned member's command line, since the port's
platform is set in code, not inherited from the environment: members of
a router on the CPU serve on the CPU, members of a router on ``cuda``
serve on the card, and a member that finds no card fails its launch,
which raises here naming it. Models and results cross the wire as host
state (``serving/ipc.py``); results are the port's own, so KMeans labels
arrive as int64 (the reference's are int32).
"""

from __future__ import annotations

import socket
import subprocess
import tempfile
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Set

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.ingest import numpy_dtype
from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.core.serving import HOST_DTYPE, bucket_rows
from spark_rapids_ml_tpu_torch.observability import autotune as _autotune
from spark_rapids_ml_tpu_torch.observability import opsplane
from spark_rapids_ml_tpu_torch.observability.events import (
    begin_trace,
    current_trace_context,
    emit,
    inject_env,
    new_run_id,
    trace_scope,
)
from spark_rapids_ml_tpu_torch.observability.metrics import gauge, histogram
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.serving import ipc
from spark_rapids_ml_tpu_torch.serving.admission import DEFAULT_RETRY_AFTER_MS, Overloaded
from spark_rapids_ml_tpu_torch.serving.batcher import LATENCY_MS_BUCKETS
from spark_rapids_ml_tpu_torch.serving.registry import ModelRegistry, ModelVersion
from spark_rapids_ml_tpu_torch.serving.signature import spec_bytes, tree_map
from spark_rapids_ml_tpu_torch.serving.worker import (
    CONNECT_TIMEOUT_ENV,
    DEFAULT_CONNECT_TIMEOUT_S,
    MEMBER_ENV,
    RENDEZVOUS_ENV,
    decode_error,
    spawn_command,
)
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_int
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock, make_rlock
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

WORKERS_ENV = "TPUML_ROUTER_WORKERS"
SHARD_ROWS_ENV = "TPUML_ROUTER_SHARD_ROWS"

DEFAULT_WORKERS = 2

#: Live routers (weak): the serving report's router section. A router
#: leaves the set when it closes.
_ROUTERS: "weakref.WeakSet[RoutingRuntime]" = weakref.WeakSet()
_router_seq_lock = make_lock("serving.router_seq")
_router_seq = 0  # guarded-by: _router_seq_lock


def router_snapshots() -> List[dict]:
    """Point-in-time state of every live :class:`RoutingRuntime`."""
    return [rt.snapshot() for rt in list(_ROUTERS)]


def _routed_latency_hist():
    return histogram(
        "serving.router.latency_ms",
        "submit-to-result latency per routed request (router clock)",
        buckets=LATENCY_MS_BUCKETS,
    )


class _Member:
    """The router's handle on one worker process: socket, receiver
    thread, live load signals, per-member accounting."""

    def __init__(self, member_id: int, card: dict, sock):
        self.id = int(member_id)
        self.card = card
        self.sock = sock
        self.send_lock = make_lock("serving.router.member_send")
        self.recv_thread: Optional[threading.Thread] = None
        self.proc: Optional[subprocess.Popen] = None
        # Live load signals + accounting, read and written under the
        # router's _lock.
        self.last_depth = 0
        self.outstanding = 0
        self.backoff_until = 0.0
        self.dead = False
        self.routed = 0
        self.completed = 0
        self.shed = 0
        self.retries = 0
        self.mem_budget = 0
        self.queue_limit = 0
        # Elastic lifecycle. joining: connected but the op-log replay
        # hasn't finished, invisible to selection. retiring: draining
        # out, no NEW selections, broadcasts skip it (it never returns).
        self.joining = False
        self.retiring = False
        self.down_reason = "connection lost"
        # Frame-loop liveness as the member last reported it (``beat``
        # frames): its heartbeat age plus WHEN we heard it, so the
        # effective age keeps growing if the reporter itself dies.
        self.reported_age = 0.0
        self.age_at = 0.0

    def effective_age(self, now: float) -> Optional[float]:
        """Seconds since the member's frame loop last provably moved
        (None until the first beat report). Read under the router's _lock."""
        if self.age_at <= 0.0:
            return None
        return self.reported_age + (now - self.age_at)

    def send(self, msg: dict) -> None:
        with self.send_lock:
            ipc.send_msg(self.sock, msg)


class RoutingRuntime:
    """Multi-process serving façade: ``submit``/``submit_many``/``close``
    over a gang of :mod:`serving.worker` members.

    ``launch="spawn"`` (default) starts one worker subprocess per member
    with :func:`parallel.distributed.member_env`: each inherits the
    telemetry dir, the launch trace carrier and a distinct gang process
    index, and gets the router's platform on its command line.
    ``launch="barrier"`` runs the members as one Spark barrier stage
    (``spark.barrier.serving_gang_run``) on a background driver thread.
    ``launch="attach"`` connects to ``workers`` members something else
    already published into the rendezvous directory.
    """

    def __init__(
        self,
        workers: Optional[int] = None,
        *,
        launch: str = "spawn",
        rdd=None,
        rendezvous: Optional[str] = None,
        registry: Optional[ModelRegistry] = None,
        max_batch: Optional[int] = None,
        max_delay_ms: Optional[float] = None,
        queue_limit: Optional[int] = None,
        mem_budget: Optional[int] = None,
        connect_timeout: Optional[float] = None,
        shard_rows: Optional[int] = None,
    ):
        global _router_seq
        if launch not in ("spawn", "barrier", "attach"):
            raise ValueError(f"unknown launch mode {launch!r}")
        self.workers = (
            int(workers)
            if workers is not None
            else env_int(WORKERS_ENV, DEFAULT_WORKERS, minimum=1)
        )
        self.launch = launch
        self.platform = _device.get_platform()
        self.registry = registry if registry is not None else ModelRegistry()
        self.connect_timeout = (
            float(connect_timeout)
            if connect_timeout is not None
            else env_float(CONNECT_TIMEOUT_ENV, DEFAULT_CONNECT_TIMEOUT_S, minimum=1.0)
        )
        self.shard_rows = (
            int(shard_rows)
            if shard_rows is not None
            else env_int(SHARD_ROWS_ENV, 0, minimum=0)
        )
        self._serve_knobs = {
            "TPUML_SERVE_MAX_BATCH": max_batch,
            "TPUML_SERVE_MAX_DELAY_MS": max_delay_ms,
            "TPUML_SERVE_QUEUE": queue_limit,
            "TPUML_SERVE_MEM_BUDGET": mem_budget,
        }
        if rendezvous is None:
            rendezvous = tempfile.mkdtemp(prefix="tpuml-router-")
        self.rendezvous = rendezvous
        self._closed = False
        self._lock = make_lock("serving.router")
        self._op_lock = make_rlock("serving.router.oplog")
        self._mesh_lock = make_lock("serving.router.mesh")
        self._pending: Dict[int, dict] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._lsn = 0  # guarded-by: _op_lock
        # The retained op log: every broadcast registry op in lsn order,
        # each with the version the gang assigned (register ops). A
        # joining member replays it from lsn 0: identical log order gives
        # identical version numbers, so replay is indistinguishable from
        # having been there all along.
        self._oplog: List[dict] = []  # guarded-by: _op_lock
        self._members: Dict[int, _Member] = {}
        self._barrier_thread: Optional[threading.Thread] = None
        self._barrier_result: list = []
        self._shard_pool: Optional[ThreadPoolExecutor] = None
        self._mesh = None  # guarded-by: _mesh_lock
        self._replicated: Dict[tuple, Any] = {}  # guarded-by: _mesh_lock
        self._rejected = 0  # guarded-by: _lock
        self._oversized = 0  # guarded-by: _lock
        with _router_seq_lock:
            _router_seq += 1
            self.router_id = f"serving-router-{_router_seq}"
        # The launch trace: every member joins it via the env carrier, so
        # gang bring-up is one merged trace even before the first request.
        self._launch_trace = current_trace_context() or begin_trace()
        try:
            with trace_scope(self._launch_trace):
                if launch == "spawn":
                    self._spawn_members()
                elif launch == "barrier":
                    if rdd is None:
                        raise ValueError("launch='barrier' needs an rdd")
                    self._launch_barrier(rdd)
                else:
                    for i in range(self.workers):
                        self._members[i] = _Member(i, {}, sock=None)
                self._connect_members()
        except BaseException:
            # A failed launch must not leave member processes behind.
            self._abandon_launch()
            raise
        _ROUTERS.add(self)
        # The gang-wide scrape: if this process runs an ops server, the
        # router claims /statusz on it (dynamic lookup, so registration
        # order vs server start doesn't matter).
        self._statusz_endpoint = lambda: _statusz_body(self)
        opsplane.add_endpoint("/statusz", self._statusz_endpoint)

    # --- launch ---------------------------------------------------------

    def _member_proc(self, member_id: int, gang_size: int) -> subprocess.Popen:
        """Start one spawned member on the router's platform."""
        from spark_rapids_ml_tpu_torch.parallel.distributed import member_env

        env = member_env(member_id, gang_size)
        env[RENDEZVOUS_ENV] = self.rendezvous
        env[MEMBER_ENV] = str(member_id)
        for knob, value in self._serve_knobs.items():
            if value is not None:
                env[knob] = str(value)
        return subprocess.Popen(spawn_command(self.platform), env=env)

    def _spawn_members(self) -> None:
        for i in range(self.workers):
            proc = self._member_proc(i, self.workers)
            member = _Member(i, {"pid": proc.pid}, sock=None)
            member.proc = proc
            self._members[i] = member

    def _launch_barrier(self, rdd) -> None:
        from spark_rapids_ml_tpu_torch.spark.barrier import serving_gang_run

        def run():
            try:
                self._barrier_result.append(serving_gang_run(rdd, self.rendezvous))
            except BaseException as exc:  # noqa: BLE001 - surfaced at close
                self._barrier_result.append(exc)

        self._barrier_thread = threading.Thread(target=run, name="tpuml-router-gang", daemon=True)
        self._barrier_thread.start()
        for i in range(self.workers):
            self._members[i] = _Member(i, {}, sock=None)

    def _abandon_launch(self) -> None:
        """Tear down what a failed launch started: sockets, then spawned
        processes (killed: they never served)."""
        for member in self._members.values():
            member.dead = True
            if member.sock is not None:
                try:
                    member.sock.close()
                except OSError:
                    pass
            if member.proc is not None and member.proc.poll() is None:
                member.proc.kill()
                try:
                    member.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            gauge("serving.router.member.depth", "").remove(router=self.router_id, member=str(member.id))

    def _connect_members(self) -> None:
        deadline = time.monotonic() + self.connect_timeout
        for member in self._members.values():
            self._connect_one(member, deadline)

    def _connect_one(self, member: _Member, deadline: float) -> None:
        card = None
        while card is None:
            card = ipc.read_member(self.rendezvous, member.id)
            if card is None:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"serving member {member.id} did not publish "
                        f"into {self.rendezvous!r} within "
                        f"{self.connect_timeout:.0f}s "
                        f"({CONNECT_TIMEOUT_ENV})"
                    )
                if member.proc is not None and member.proc.poll() is not None:
                    raise RuntimeError(
                        f"serving member {member.id} exited with code "
                        f"{member.proc.returncode} before publishing "
                        f"(platform {self.platform!r})"
                    )
                time.sleep(0.05)
        member.card = card
        sock = socket.create_connection(
            (card["host"], card["port"]),
            timeout=max(1.0, deadline - time.monotonic()),
        )
        sock.settimeout(None)
        member.sock = sock
        member.recv_thread = threading.Thread(
            target=self._recv_loop, args=(member,),
            name=f"tpuml-router-recv-{member.id}", daemon=True,
        )
        member.recv_thread.start()
        hello = self._request(
            member, {"t": "hello"},
            timeout=max(1.0, deadline - time.monotonic()),
        )
        member.mem_budget = int(hello.get("mem_budget") or 0)
        member.queue_limit = int(hello.get("queue_limit") or 0)
        gauge(
            "serving.router.member.depth",
            "per-member queue depth as last reported to the router",
        ).set_function(
            lambda m=member: m.last_depth,
            router=self.router_id, member=str(member.id),
        )
        emit(
            "serving", action="member_up", router=self.router_id,
            member=member.id, pid=card.get("pid"),
            mem_budget=member.mem_budget,
        )

    # --- wire plumbing --------------------------------------------------

    def _register_pending(self, entry: dict) -> int:
        with self._lock:
            self._next_id += 1
            mid = self._next_id
            self._pending[mid] = entry
            return mid

    def _request(self, member: _Member, msg: dict, timeout: Optional[float] = None) -> dict:
        """One synchronous request/reply round trip to ``member``."""
        fut: Future = Future()
        mid = self._register_pending({"kind": "control", "future": fut, "member": member.id})
        msg["id"] = mid
        member.send(msg)
        reply = fut.result(timeout=timeout if timeout is not None else self.connect_timeout)
        if not reply.get("ok"):
            raise decode_error(reply["error"])
        return reply

    def _recv_loop(self, member: _Member) -> None:
        while True:
            try:
                msg = ipc.recv_msg(member.sock)
            except OSError:
                msg = None
            if msg is None:
                self._member_lost(member)
                return
            if msg.get("t") == "beat":
                self._note_beat(member, msg)
                continue
            self._handle_reply(member, msg)

    def _note_beat(self, member: _Member, msg: dict) -> None:
        """A member's liveness report: its frame-loop heartbeat age (plus
        a free queue-depth refresh: idle members stay current without
        traffic)."""
        with self._lock:
            member.reported_age = float(msg.get("age") or 0.0)
            member.age_at = time.monotonic()
            if "depth" in msg:
                member.last_depth = int(msg["depth"])

    def _member_lost(self, member: _Member) -> None:
        """EOF from a member: fail or re-route everything it owed."""
        with self._lock:
            if member.dead:
                return
            member.dead = True
            orphans = [(mid, e) for mid, e in self._pending.items() if e.get("member") == member.id]
            for mid, _ in orphans:
                del self._pending[mid]
        gauge("serving.router.member.depth", "").remove(router=self.router_id, member=str(member.id))
        if not self._closed:
            emit(
                "serving", action="member_down", router=self.router_id,
                member=member.id, reason=member.down_reason,
            )
        for _, entry in orphans:
            if entry.get("kind") == "submit":
                # A died-mid-request member is a shed without a hint:
                # retry elsewhere, surface only when nowhere is left.
                self._redispatch(entry, RuntimeError(f"serving member {member.id} lost mid-request"))
            else:
                entry["future"].set_exception(RuntimeError(f"serving member {member.id} connection lost"))

    def _handle_reply(self, member: _Member, msg: dict) -> None:
        with self._lock:
            entry = self._pending.pop(msg.get("id"), None)
            if "depth" in msg:
                member.last_depth = int(msg["depth"])
        if entry is None:
            return
        if entry.get("kind") != "submit":
            entry["future"].set_result(msg)
            return
        with self._lock:
            member.outstanding -= 1
        if msg.get("ok"):
            with self._lock:
                member.completed += 1
            _routed_latency_hist().observe((time.monotonic() - entry["t0"]) * 1e3)
            fut = entry["future"]
            # Freshness attribution: the member executed exactly the
            # (name, version) the router resolved at admission.
            fut.model_name = entry["name"]
            fut.model_version = entry["version"]
            if fut.set_running_or_notify_cancel():
                fut.set_result(msg["result"])
            return
        exc = decode_error(msg["error"])
        if isinstance(exc, Overloaded):
            now = time.monotonic()
            with self._lock:
                member.shed += 1
                if exc.retry_after_ms > 0:
                    member.backoff_until = max(member.backoff_until, now + exc.retry_after_ms / 1e3)
            bump_counter("serving.router.shed")
            with trace_scope(entry["trace"]):
                emit(
                    "serving", action="route_shed", router=self.router_id,
                    member=member.id, model=entry["name"],
                    version=entry["version"], run_id=entry["run_id"],
                    reason=exc.reason,
                    retry_after_ms=round(exc.retry_after_ms, 3),
                )
            self._redispatch(entry, exc)
            return
        fut = entry["future"]
        if fut.set_running_or_notify_cancel():
            fut.set_exception(exc)

    # --- member selection ----------------------------------------------

    def _pick_member(self, tried: Set[int]) -> Optional[_Member]:
        """Weighted least-loaded: router-local outstanding count plus the
        member's last piggy-backed queue depth; shed members sit out
        their advertised backoff window. Caller must NOT hold _lock."""
        now = time.monotonic()
        with self._lock:
            candidates = [
                m for m in self._members.values()
                if not m.dead and not m.joining and not m.retiring
                and m.id not in tried and m.backoff_until <= now
            ]
            if not candidates:
                return None
            best = min(candidates, key=lambda m: (m.outstanding + m.last_depth, m.id))
            best.outstanding += 1
            best.routed += 1
            return best

    def _all_members_overloaded(self, name: str) -> Overloaded:
        """The aggregate shed when no member can take a request: retry
        after the SOONEST backoff window expires."""
        now = time.monotonic()
        with self._lock:
            self._rejected += 1
            alive = [m for m in self._members.values() if not m.dead and not m.joining and not m.retiring]
            hints = [(m.backoff_until - now) * 1e3 for m in alive if m.backoff_until > now]
            depth = max((m.last_depth for m in alive), default=0)
            limit = max((m.queue_limit for m in alive), default=0)
        retry_ms = min(hints) if hints else DEFAULT_RETRY_AFTER_MS
        bump_counter("serving.router.rejected")
        emit(
            "serving", action="route_shed", router=self.router_id,
            member=None, model=name, reason="all-members",
            retry_after_ms=round(retry_ms, 3),
        )
        return Overloaded("queue", name, queue_depth=depth, queue_limit=limit,
                          retry_after_ms=max(retry_ms, 0.0))

    def _dispatch(self, entry: dict, member: _Member) -> None:
        entry["member"] = member.id
        mid = self._register_pending(entry)
        frame = {
            "t": "submit", "id": mid, "name": entry["name"],
            "version": entry["version"], "x": entry["x"],
            "timeout": entry["timeout"], "carrier": entry["carrier"],
        }
        try:
            member.send(frame)
        except OSError:
            with self._lock:
                self._pending.pop(mid, None)
            self._member_lost(member)
            raise

    def _redispatch(self, entry: dict, last_exc: BaseException) -> None:
        """Transparent retry on the next-best member after a shed or a
        lost member; the caller only sees a failure when every member
        has been tried or is backed off."""
        entry["tried"].add(entry["member"])
        while True:
            member = self._pick_member(entry["tried"])
            if member is None:
                fut = entry["future"]
                exc = (last_exc if isinstance(last_exc, Overloaded)
                       else self._all_members_overloaded(entry["name"]))
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(exc)
                return
            with self._lock:
                member.retries += 1
            bump_counter("serving.router.retry")
            try:
                self._dispatch(entry, member)
                return
            except OSError:
                entry["tried"].add(member.id)
                continue

    # --- the request path -----------------------------------------------

    def submit(
        self,
        name: str,
        x: Any,
        *,
        timeout: Optional[float] = None,
        version: Optional[Any] = None,
    ) -> Future:
        """Route one request: the contract of :meth:`ServingRuntime.submit`.
        Resolution to a CONCRETE version happens here, once, against the
        router's registry mirror: the member executes exactly
        ``(name, version)``, which is what makes hot swaps version-atomic
        across the whole gang. Rows travel as host float64, the dtype
        every member serves host rows in."""
        if self._closed:
            raise RuntimeError("serving router is closed")
        mv = self.registry.resolve(name, version)
        sig = mv.signature
        xh = to_host(x)
        if xh.ndim == 1:
            xh = xh[None, :]
        if xh.ndim != 2:
            raise ValueError(f"serving input must be 1-D or 2-D, got {xh.ndim}-D")
        if xh.shape[1] != sig.n_features:
            raise ValueError(
                f"model {mv.name!r} v{mv.version} expects {sig.n_features} "
                f"features, got {xh.shape[1]}"
            )
        dtype = np.dtype(numpy_dtype(HOST_DTYPE))
        xh = np.ascontiguousarray(xh, dtype=dtype)
        n = int(xh.shape[0])
        run_id = new_run_id("route")
        tc = current_trace_context()
        if tc is None:
            tc = begin_trace()
        bump_counter("serving.router.requests")
        bump_counter("serving.router.rows", n)

        if self._is_oversized(mv, n, dtype):
            return self._submit_sharded(mv, xh, run_id, tc)

        member = self._pick_member(set())
        if member is None:
            raise self._all_members_overloaded(mv.name)
        # The env-var names of the spawn carrier, as a per-request dict:
        # the member rebuilds the TraceContext and the whole hop joins
        # one trace.
        with trace_scope(tc):
            carrier = inject_env({})
            emit(
                "serving", action="route", router=self.router_id,
                member=member.id, model=mv.name, version=mv.version,
                rows=n, run_id=run_id,
            )
        entry = {
            "kind": "submit",
            "future": Future(),
            "name": mv.name,
            "version": mv.version,
            "x": xh,
            "timeout": timeout,
            "carrier": carrier,
            "tried": set(),
            "member": member.id,
            "run_id": run_id,
            "trace": tc,
            "t0": time.monotonic(),
        }
        try:
            self._dispatch(entry, member)
        except OSError:
            # First-choice member died at send time: fall through the
            # retry ladder before surfacing anything.
            self._redispatch(entry, RuntimeError("member lost at dispatch"))
        return entry["future"]

    def submit_many(
        self,
        name: str,
        xs: Iterable[Any],
        *,
        timeout: Optional[float] = None,
        version: Optional[Any] = None,
    ) -> List[Future]:
        """One future per element; resolved ONCE up front so the set is
        version-consistent even across a concurrent hot swap."""
        mv = self.registry.resolve(name, version)
        return [self.submit(mv.name, x, timeout=timeout, version=mv.version) for x in xs]

    # --- oversized requests: the sharded path ---------------------------

    def _member_budget_floor(self) -> int:
        with self._lock:
            budgets = [m.mem_budget for m in self._members.values() if not m.dead and m.mem_budget > 0]
        return min(budgets) if budgets else 0

    def _is_oversized(self, mv: ModelVersion, n: int, dtype) -> bool:
        shard_rows = self.shard_rows
        if not shard_rows:
            # No explicit cutoff: with the autotuner on, derive one from
            # the fitted wall model: shard a request whose predicted
            # single-program wall would monopolize a member for several
            # batch windows of the hot bucket.
            tuner = _autotune.active()
            if tuner is not None:
                shard_rows = tuner.recommend_shard_rows(mv.signature.name) or 0
        if shard_rows and n >= shard_rows:
            return True
        floor = self._member_budget_floor()
        if not floor:
            return False
        sig = mv.signature
        bucket = bucket_rows(max(n, 1))
        declared = bucket * sig.n_features * np.dtype(dtype).itemsize + spec_bytes(
            sig.output_spec(bucket, HOST_DTYPE)
        )
        return declared > floor

    def _global_mesh(self):
        from spark_rapids_ml_tpu_torch.parallel.distributed import global_mesh

        with self._mesh_lock:
            if self._mesh is None:
                self._mesh = global_mesh()
            return self._mesh

    def _replicated_weights(self, mv: ModelVersion, mesh) -> Dict[torch.device, Any]:
        """The host-route weights placed ONCE per (name, version) on every
        device of the mesh's data axis, keyed by device: oversized traffic
        must not re-upload per request. The first device's copy is the
        checkpoint layer's mesh placement."""
        from spark_rapids_ml_tpu_torch.robustness.checkpoint import replicate_state_onto_mesh

        with self._mesh_lock:
            cached = self._replicated.get(mv.key)
        if cached is not None:
            return cached
        sig = mv.signature
        weights = sig.host_weights if sig.host_weights is not None else sig.weights
        first = tree_map(lambda a: replicate_state_onto_mesh((a,), mesh)[0], weights)
        placed = {mesh.first_device: first}
        for dev in mesh.grid[:, 0]:
            if dev not in placed:
                placed[dev] = tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a, first)
        with self._mesh_lock:
            self._replicated.setdefault(mv.key, placed)
            return self._replicated[mv.key]

    def _submit_sharded(self, mv: ModelVersion, xh: np.ndarray, run_id: str, tc) -> Future:
        with self._lock:
            self._oversized += 1
            if self._shard_pool is None:
                self._shard_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpuml-router-shard")
            pool = self._shard_pool
        bump_counter("serving.router.oversized")
        with trace_scope(tc):
            emit(
                "serving", action="route_oversized", router=self.router_id,
                model=mv.name, version=mv.version, rows=int(xh.shape[0]),
                run_id=run_id,
            )

        def run():
            from spark_rapids_ml_tpu_torch.parallel.mesh import shard_tensor_rows

            with trace_scope(tc), torch.no_grad():
                sig = mv.signature
                mesh = self._global_mesh()
                n = int(xh.shape[0])
                # Rows zero-padded to the data shards, one block per shard
                # on its device; the kernel is row-wise, so each shard's
                # rows come out as a member's would.
                rows = shard_tensor_rows(torch.from_numpy(xh).to(mesh.first_device), mesh)
                weights = self._replicated_weights(mv, mesh)
                outs = []
                for i in range(len(rows.blocks)):
                    shard = rows.shard(i)
                    outs.append(tree_map(to_host, sig.kernel(shard, *weights[shard.device], **sig.static)))
                merged = _zip_trees(lambda *leaves: np.concatenate(leaves)[:n], outs, rows.rows_per)
                emit(
                    "serving", action="complete", router=self.router_id,
                    model=mv.name, version=mv.version, rows=n,
                    run_id=run_id, path="mesh-sharded",
                )
                return merged

        t0 = time.monotonic()
        fut = pool.submit(run)
        # Version resolution already happened at admission: the sharded
        # path carries the same freshness attribution as a routed reply.
        fut.model_name = mv.name
        fut.model_version = mv.version
        fut.add_done_callback(
            lambda f: _routed_latency_hist().observe((time.monotonic() - t0) * 1e3)
            if f.exception() is None else None
        )
        return fut

    # --- the replicated registry ----------------------------------------

    def _broadcast_op(self, op: dict, timeout: Optional[float] = None) -> List[dict]:
        """Send one op frame to every live member and gather the acks.
        Caller holds _op_lock, so ops hit every member in one global
        order: the determinism the version numbering relies on.

        A member that dies between send and ack is classified SKIPPED,
        not fatal: it left the gang mid-broadcast (its orphaned control
        future fails when ``_member_lost`` fires), the survivors carry
        the op. Every surviving ack must echo the op's lsn: a
        discontinuity means a member applied ops out of order, which
        breaks version determinism and is worth crashing on. Members
        joining (the replay path covers them) or retiring (they never
        take another request) are excluded up front. The op is retained
        in the lsn-ordered ``_oplog`` for future joins."""
        with self._lock:
            alive = [m for m in self._members.values() if not m.dead and not m.joining and not m.retiring]
        if not alive:
            raise RuntimeError("serving router has no live members")
        futs = []
        for member in alive:
            fut: Future = Future()
            mid = self._register_pending({"kind": "control", "future": fut, "member": member.id})
            frame = dict(op)
            frame["t"] = "op"
            frame["id"] = mid
            try:
                member.send(frame)
            except OSError:
                with self._lock:
                    self._pending.pop(mid, None)
                self._member_lost(member)
                continue
            futs.append((member, fut))
        replies = []
        budget = timeout if timeout is not None else self.connect_timeout
        for member, fut in futs:
            try:
                reply = fut.result(timeout=budget)
            except Exception:
                with self._lock:
                    dead = member.dead
                if not dead:
                    raise  # a live member that won't ack is a real hang
                emit(
                    "serving", action="replicate_skip",
                    router=self.router_id, member=member.id,
                    op=op.get("op"), lsn=op.get("lsn"),
                )
                continue
            if not reply.get("ok"):
                raise decode_error(reply["error"])
            acked = reply.get("lsn")
            if acked is not None and op.get("lsn") is not None and int(acked) != int(op["lsn"]):
                raise RuntimeError(
                    f"lsn discontinuity on serving member {member.id}: "
                    f"op lsn {op['lsn']}, acked {acked}"
                )
            replies.append(reply)
        if not replies:
            raise RuntimeError("no serving member survived the registry op broadcast")
        with self._op_lock:
            self._oplog.append({"frame": dict(op)})
        return replies

    def _next_lsn(self) -> int:
        with self._op_lock:
            self._lsn += 1
            return self._lsn

    def register(
        self,
        name: str,
        model: Any,
        *,
        alias: Optional[str] = None,
        warm_buckets: Iterable[int] = (),
        warm_dtype: Any = None,
    ) -> ModelVersion:
        """Replicate a registration to every member, then mirror it
        locally. Every member's ack carries the version IT assigned;
        divergence from the router's own monotonic assignment is a bug
        worth crashing on, not routing around. With ``alias=`` the flip
        follows the same warmed two-phase path as :meth:`set_alias`. The
        model crosses as host state; each member places it on its own
        device."""
        blob = ipc.dumps_model(model)
        warm_buckets = tuple(warm_buckets)
        with self._op_lock:
            lsn = self._next_lsn()
            replies = self._broadcast_op({"op": "register", "lsn": lsn, "name": name, "model": blob})
            mv = self.registry.register(name, model)
            got = {int(r["version"]) for r in replies}
            if got != {mv.version}:
                raise RuntimeError(
                    f"registry divergence for {name!r}: router assigned "
                    f"v{mv.version}, members assigned {sorted(got)}"
                )
            # A future join's replay must land the SAME version on the
            # new member: remember what the gang assigned.
            self._oplog[-1]["expect_version"] = mv.version
            emit(
                "serving", action="replicate", router=self.router_id,
                op="register", lsn=lsn, model=name, version=mv.version,
                members=len(replies),
            )
            if warm_buckets:
                self.warm(name, version=mv.version, buckets=warm_buckets, dtype=warm_dtype)
            if alias is not None:
                self.set_alias(name, alias, mv.version, warm_buckets=warm_buckets or (1,))
        return mv

    def set_alias(
        self,
        name: str,
        alias: str,
        version: int,
        *,
        warm_buckets: Iterable[int] = (1,),
    ) -> None:
        """The cross-member hot swap, two-phase: (1) warm the target
        version on EVERY member so the first post-flip batch is
        capture-free everywhere; (2) replicate the alias move, then flip
        the ROUTER's alias last. Traffic resolves against the router's
        registry, so the flip is one atomic alias move here: no member
        ever sees a half-swapped gang, and nothing sheds over the swap."""
        with self._op_lock:
            if warm_buckets:
                self.warm(name, version=version, buckets=warm_buckets)
            lsn = self._next_lsn()
            self._broadcast_op(
                {"op": "set_alias", "lsn": lsn, "name": name,
                 "alias": alias, "version": int(version)}
            )
            self.registry.set_alias(name, alias, int(version))
            emit(
                "serving", action="replicate", router=self.router_id,
                op="set_alias", lsn=lsn, model=name, alias=alias,
                version=int(version),
            )

    def warm(
        self,
        name: str,
        *,
        version: Optional[int] = None,
        buckets: Iterable[int] = (),
        dtype: Any = None,
    ) -> int:
        """Replicated warm-up; returns the max bucket count any member
        warmed (they share the op, not the cache)."""
        with self._op_lock:
            lsn = self._next_lsn()
            replies = self._broadcast_op(
                {"op": "warm", "lsn": lsn, "name": name, "version": version,
                 "buckets": tuple(buckets),
                 "dtype": str(dtype) if dtype is not None else None}
            )
        return max((int(r.get("warmed", 0)) for r in replies), default=0)

    def rollback(self, name: str, alias: str = "prod", *, warm_buckets: Iterable[int] = (1,)) -> int:
        """The one-op alias revert, replicated with the same zero-shed
        two-phase shape as the forward flip: (1) warm the rollback
        TARGET on every member (a swapped-out version may have dropped
        its programs); (2) replicate the rollback lsn-ordered, then move
        the ROUTER's alias last: traffic resolves here, so no member ever
        sees a half-rolled-back gang. Returns the version now serving.
        Each member re-derives the same target from its own replicated
        previous-pointer (identical op order, identical pointer), and the
        router cross-checks the acks."""
        with self._op_lock:
            target = self.registry.rollback_target(name, alias)
            if warm_buckets:
                self.warm(name, version=target, buckets=warm_buckets)
            lsn = self._next_lsn()
            replies = self._broadcast_op({"op": "rollback", "lsn": lsn, "name": name, "alias": alias})
            got = {int(r["version"]) for r in replies if "version" in r}
            if got and got != {target}:
                raise RuntimeError(
                    f"rollback divergence for {name!r}@{alias}: router "
                    f"targets v{target}, members reverted to {sorted(got)}"
                )
            v = self.registry.rollback(name, alias)
            self._oplog[-1]["expect_version"] = v
            emit(
                "serving", action="replicate", router=self.router_id,
                op="rollback", lsn=lsn, model=name, alias=alias, version=v,
            )
        return v

    def retire(self, name: str, version: int) -> None:
        with self._op_lock:
            lsn = self._next_lsn()
            self._broadcast_op({"op": "retire", "lsn": lsn, "name": name, "version": int(version)})
            self.registry.retire(name, int(version))
            with self._mesh_lock:
                self._replicated.pop((name, int(version)), None)
            emit(
                "serving", action="replicate", router=self.router_id,
                op="retire", lsn=lsn, model=name, version=int(version),
            )

    # --- elastic membership ---------------------------------------------

    def live_member_ids(self) -> List[int]:
        """Members currently in (or joining toward) the selection set."""
        with self._lock:
            return sorted(m.id for m in self._members.values() if not m.dead and not m.retiring)

    def add_member(self, *, timeout: Optional[float] = None) -> int:
        """Grow the gang by one member under live load, shedding nothing.

        The join protocol: spawn (``member.launch`` chaos site), connect
        and handshake exactly like launch-time members, then, holding
        ``_op_lock`` so no live op can interleave (``member.join`` chaos
        site), replay the retained op log from lsn 0 into the new member
        and verify every register ack against the version the gang
        originally assigned. Warm ops are IN the log, so replay leaves
        the member's programs as hot as its peers'. Only then does the
        member become selectable; until that instant ``_pick_member``
        cannot see it, so no request is ever routed to a half-caught-up
        member and the join sheds zero requests. A failed join tears the
        member down without ever having touched the selection set."""
        if self._closed:
            raise RuntimeError("serving router is closed")
        if self.launch != "spawn":
            raise RuntimeError(
                f"add_member needs launch='spawn' members the router owns; "
                f"this router launched {self.launch!r}"
            )
        budget = timeout if timeout is not None else self.connect_timeout
        with self._lock:
            member_id = max(self._members, default=-1) + 1
            gang_size = len(self._members) + 1
        fault_point("member.launch")
        with trace_scope(self._launch_trace):
            proc = self._member_proc(member_id, gang_size)
            member = _Member(member_id, {"pid": proc.pid}, sock=None)
            member.proc = proc
            member.joining = True
            with self._lock:
                self._members[member_id] = member
            try:
                self._connect_one(member, time.monotonic() + budget)
                with self._op_lock:
                    fault_point("member.join")
                    replayed = self._replay_oplog(member, budget)
                    # Admit while STILL holding _op_lock: there is no
                    # instant where a new op could miss both the replay
                    # and the live broadcast.
                    with self._lock:
                        member.joining = False
                    lsn = self._lsn
                emit(
                    "serving", action="member_join", router=self.router_id,
                    member=member_id, lsn=lsn, ops_replayed=replayed,
                )
            except BaseException:
                self._abort_join(member)
                raise
        return member_id

    def _replay_oplog(self, member: _Member, budget: float) -> int:
        """Replay every retained op, in lsn order, to ONE member."""
        with self._op_lock:
            for rec in self._oplog:
                frame = dict(rec["frame"])
                frame["t"] = "op"
                reply = self._request(member, frame, timeout=budget)
                acked = reply.get("lsn")
                if acked is not None and int(acked) != int(frame["lsn"]):
                    raise RuntimeError(
                        f"join replay lsn discontinuity on member {member.id}: "
                        f"sent {frame['lsn']}, acked {acked}"
                    )
                expect = rec.get("expect_version")
                if expect is not None and int(reply.get("version", -1)) != int(expect):
                    raise RuntimeError(
                        f"join replay divergence on member {member.id}: "
                        f"{frame.get('name')!r} got v{reply.get('version')}, "
                        f"gang assigned v{expect}"
                    )
            return len(self._oplog)

    def _abort_join(self, member: _Member) -> None:
        """A join that failed before admission: erase the member as if
        it never existed (it was never selectable, so nothing routed)."""
        with self._lock:
            member.dead = True
            member.down_reason = "join failed"
            self._members.pop(member.id, None)
        gauge("serving.router.member.depth", "").remove(router=self.router_id, member=str(member.id))
        if member.sock is not None:
            try:
                member.sock.close()
            except OSError:
                pass
        if member.proc is not None:
            member.proc.kill()
            try:
                member.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        emit(
            "serving", action="member_down", router=self.router_id,
            member=member.id, reason="join failed",
        )

    def retire_member(self, member_id: int, *, timeout: Optional[float] = None) -> None:
        """Shrink the gang by one member, drain-then-detach: stop
        selecting it, wait for its outstanding requests to finish, then
        a draining shutdown (the worker quiesces its op log and queue,
        acks, and exits, flushing its telemetry shard and retiring its
        own gauges; EOF here retires the router-side depth series). The
        last live member cannot be retired: the gang must keep serving."""
        budget = timeout if timeout is not None else self.connect_timeout
        with self._lock:
            member = self._members.get(int(member_id))
            if member is None:
                raise KeyError(f"no serving member {member_id}")
            if member.dead or member.retiring:
                return
            others = [m for m in self._members.values() if not m.dead and not m.retiring and m.id != member.id]
            if not others:
                raise RuntimeError("cannot retire the last live serving member")
            member.retiring = True
            member.down_reason = "retired"
        emit("serving", action="member_retire", router=self.router_id, member=member.id)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            with self._lock:
                if member.outstanding <= 0 or member.dead:
                    break
            time.sleep(0.01)
        try:
            self._request(member, {"t": "shutdown", "drain": True}, timeout=budget)
        except Exception:  # noqa: BLE001 - it may already be gone
            pass
        if member.recv_thread is not None:
            member.recv_thread.join(timeout=budget)
        if member.sock is not None:
            try:
                member.sock.close()
            except OSError:
                pass
        if member.proc is not None:
            try:
                member.proc.wait(timeout=budget)
            except subprocess.TimeoutExpired:
                member.proc.kill()
                member.proc.wait(timeout=10)
        with self._lock:
            already = member.dead
            member.dead = True
        if not already:
            gauge("serving.router.member.depth", "").remove(router=self.router_id, member=str(member.id))
            emit(
                "serving", action="member_down", router=self.router_id,
                member=member.id, reason="retired",
            )

    def stalled_members(self, max_age: float) -> List[int]:
        """Members whose reported frame-loop heartbeat age exceeds
        ``max_age``: alive at the socket level, provably stuck."""
        now = time.monotonic()
        out = []
        with self._lock:
            for m in self._members.values():
                if m.dead or m.joining or m.retiring:
                    continue
                age = m.effective_age(now)
                if age is not None and age > max_age:
                    out.append(m.id)
        return sorted(out)

    def retire_stalled(self, max_age: float) -> List[int]:
        """Force-detach every stalled member BEFORE its socket EOFs: the
        stuck-but-alive failure mode a connection-loss detector never
        sees. Outstanding requests redispatch through the normal
        lost-member ladder; the process is killed, not drained: a frozen
        frame loop cannot drain."""
        retired = []
        now = time.monotonic()
        for mid in self.stalled_members(max_age):
            with self._lock:
                member = self._members.get(mid)
                if member is None or member.dead:
                    continue
                age = member.effective_age(now)
                member.down_reason = "stalled"
                member.retiring = True
            emit(
                "serving", action="member_stalled", router=self.router_id,
                member=mid, age_s=round(age or 0.0, 3), max_age_s=max_age,
            )
            if member.proc is not None:
                member.proc.kill()
            if member.sock is not None:
                # Wake the blocked recv thread: shutdown() interrupts a
                # blocked recv where close() alone may not.
                try:
                    member.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    member.sock.close()
                except OSError:
                    pass
            if member.proc is not None:
                try:
                    member.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            retired.append(mid)
        return retired

    # --- lifecycle ------------------------------------------------------

    def member_status(self) -> List[dict]:
        """One ``status`` round trip per live member (registry snapshot +
        serving counters as THAT member sees them)."""
        with self._lock:
            alive = [m for m in self._members.values() if not m.dead]
        return [self._request(m, {"t": "status"}) for m in alive]

    def close(self, drain: bool = True) -> None:
        """Shut the gang down. ``drain=True`` lets every member finish
        its queue first. Idempotent."""
        if self._closed:
            return
        self._closed = True
        _ROUTERS.discard(self)
        opsplane.remove_endpoint("/statusz", self._statusz_endpoint)
        with self._lock:
            members = list(self._members.values())
        for member in members:
            if member.dead or member.sock is None:
                continue
            try:
                self._request(member, {"t": "shutdown", "drain": drain})
            except Exception:  # noqa: BLE001 - close must not raise per member
                pass
        for member in members:
            if member.recv_thread is not None:
                member.recv_thread.join(timeout=self.connect_timeout)
            if member.sock is not None:
                try:
                    member.sock.close()
                except OSError:
                    pass
            if member.proc is not None:
                try:
                    member.proc.wait(timeout=self.connect_timeout)
                except subprocess.TimeoutExpired:
                    member.proc.kill()
                    member.proc.wait(timeout=10)
            with self._lock:
                was_dead = member.dead
                member.dead = True
            if not was_dead:
                gauge("serving.router.member.depth", "").remove(router=self.router_id, member=str(member.id))
        if self._barrier_thread is not None:
            self._barrier_thread.join(timeout=self.connect_timeout)
            self._barrier_thread = None
            if self._barrier_result and isinstance(self._barrier_result[0], BaseException):
                raise self._barrier_result[0]
        if self._shard_pool is not None:
            self._shard_pool.shutdown(wait=True)
            self._shard_pool = None
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
        for entry in leftovers:
            fut = entry["future"]
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError("serving router closed before reply"))
        emit("serving", action="close", router=self.router_id, drain=drain)

    def __enter__(self) -> "RoutingRuntime":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # --- introspection --------------------------------------------------

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            members = []
            for m in self._members.values():
                age = m.effective_age(now)
                members.append({
                    "member": m.id,
                    "pid": m.card.get("pid"),
                    "dead": m.dead,
                    "joining": m.joining,
                    "retiring": m.retiring,
                    "heartbeat_age_s": round(age, 3) if age is not None else None,
                    "depth": m.last_depth,
                    "outstanding": m.outstanding,
                    "backoff_remaining_ms": round(max(0.0, (m.backoff_until - now) * 1e3), 3),
                    "routed": m.routed,
                    "completed": m.completed,
                    "shed": m.shed,
                    "retries": m.retries,
                    "mem_budget": m.mem_budget,
                })
            rejected, oversized = self._rejected, self._oversized
        return {
            "router": self.router_id,
            "closed": self._closed,
            "launch": self.launch,
            "workers": self.workers,
            "rendezvous": self.rendezvous,
            "rejected": rejected,
            "oversized": oversized,
            "members": members,
            "models": self.registry.snapshot(),
        }

    def statusz(self) -> dict:
        """The gang-merged live view: this process's own registry
        snapshot plus every live member's ``/varz`` metrics (scraped via
        the ops port its contact card published), folded with the merge
        semantics of the post-hoc ``tpuml_trace`` merge
        (:func:`observability.trace.merge_metrics`: counters sum, gauges
        max, histograms bucket-wise sum): a live scrape of a quiesced
        gang and a post-mortem assemble of its telemetry dir agree to the
        counter."""
        import json as _json
        import urllib.request

        from spark_rapids_ml_tpu_torch.observability import slo as _slo
        from spark_rapids_ml_tpu_torch.observability.metrics import default_registry
        from spark_rapids_ml_tpu_torch.observability.trace import merge_metrics

        with self._lock:
            cards = {m.id: dict(m.card) for m in self._members.values() if not m.dead}
        snapshots = [default_registry.snapshot()]
        members: Dict[str, dict] = {}
        for mid, card in sorted(cards.items()):
            ops_port = card.get("ops_port")
            cell: dict = {"pid": card.get("pid"), "ops_port": ops_port}
            if ops_port:
                try:
                    with urllib.request.urlopen(
                        f"http://{card.get('host', '127.0.0.1')}:{ops_port}/varz",
                        timeout=5.0,
                    ) as resp:
                        doc = _json.loads(resp.read().decode("utf-8"))
                    cell["ok"] = True
                    cell["process"] = doc.get("process")
                    snap = doc.get("metrics")
                    if isinstance(snap, dict):
                        snapshots.append(snap)
                except Exception as exc:  # noqa: BLE001 - a dead member
                    cell["ok"] = False  # must not 500 the gang scrape
                    cell["error"] = type(exc).__name__
            else:
                cell["ok"] = False
                cell["error"] = "no ops_port on contact card"
            members[str(mid)] = cell
        return {
            "router": self.snapshot(),
            "members": members,
            "slo": _slo.burn_rates(),
            "merged": merge_metrics(snapshots),
        }


def _zip_trees(fn, trees: List[Any], rows_per: int) -> Any:
    """Merge per-shard output trees leaf by leaf: a leaf whose leading
    axis is the shard's rows is ``fn(*leaves)`` (concatenated, padding
    cut), any other leaf (a per-batch scalar) is the first shard's."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_zip_trees(fn, list(parts), rows_per) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_zip_trees(fn, list(parts), rows_per) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: _zip_trees(fn, [t[k] for t in trees], rows_per) for k in first}
    if np.ndim(first) >= 1 and np.shape(first)[0] == rows_per:
        return fn(*trees)
    return np.asarray(first)


def _statusz_body(router: "RoutingRuntime"):
    """The /statusz endpoint body (registered on the ops server)."""
    import json as _json

    return (
        200,
        "application/json",
        _json.dumps(router.statusz(), indent=2, default=str) + "\n",
    )
