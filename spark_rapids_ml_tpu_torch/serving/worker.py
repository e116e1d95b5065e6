"""One serving-tier member: a socket front end over a ServingRuntime.

Port of the reference's ``serving/worker.py``. The worker process the
router (``serving/router.py``) fans micro-batches out to. Each member
owns a full in-process :class:`ServingRuntime` (admission queue,
micro-batcher, program cache; on the card its own CUDA context and its
own CUDA graph per bucket), so admission prices every member against ITS
OWN bytes, and a shed is a per-member signal the router can route
around.

Lifecycle: bind a loopback socket, publish a ``member-<id>.json`` contact
card into the rendezvous directory (``serving/ipc.py``), accept the ONE
router connection, then serve frames until a ``shutdown`` frame (or EOF:
a vanished router drains and exits rather than leaking a process).
Registry mutations arrive as an lsn-ordered op log and apply on a
dedicated thread in that order, so a multi-second ``warm`` never stalls
the request path; ``ModelRegistry.register`` assigns versions
monotonically per name, so identical op-log order yields identical
version numbers on every member, the replication invariant the router's
two-phase alias flip builds on.

Every reply piggy-backs the member's live queue depth: the router's
weighted least-loaded pick reads it for free, with no status polling on
the hot path. Requests carry the trace carrier, so a member's
enqueue/dispatch/complete events join the router's per-request trace in
the merged telemetry view. Results cross back as host numpy: a member
never ships a device tensor. On exit the runtime closes (retiring its
``serving.queue.depth``/``serving.inflight`` gauges), the heartbeat stops
(retiring its age gauge), and the telemetry shard flushes: a drained gang
leaves no stale gauges behind.

Spawn-mode entry: ``python -c "from spark_rapids_ml_tpu_torch.serving.
worker import main; raise SystemExit(main())" --platform cuda|cpu`` with
``TPUML_ROUTER_RENDEZVOUS`` + ``TPUML_ROUTER_MEMBER`` in the environment.
The platform rides the command line the router builds (the reference's
member inherits ``JAX_PLATFORMS`` instead): a member told ``cuda`` that
finds no card fails its launch before it publishes. Barrier mode:
``spark.barrier.serving_gang_run`` runs :func:`serve_member` as the gang
task body, on the executor's platform.
"""

from __future__ import annotations

import argparse
import os
import queue
import select
import socket
import sys
import threading
import traceback
from typing import Any, List, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.observability import events as _ev
from spark_rapids_ml_tpu_torch.observability import opsplane
from spark_rapids_ml_tpu_torch.observability.heartbeat import GangHeartbeat, heartbeat_scope
from spark_rapids_ml_tpu_torch.serving import ipc
from spark_rapids_ml_tpu_torch.serving.admission import DeadlineExceeded, Overloaded
from spark_rapids_ml_tpu_torch.serving.server import ServingRuntime
from spark_rapids_ml_tpu_torch.serving.signature import tree_map
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_int, env_str
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter, counter_value

RENDEZVOUS_ENV = "TPUML_ROUTER_RENDEZVOUS"
MEMBER_ENV = "TPUML_ROUTER_MEMBER"
CONNECT_TIMEOUT_ENV = "TPUML_ROUTER_CONNECT_TIMEOUT"

DEFAULT_CONNECT_TIMEOUT_S = 120.0

#: How often the frame loop proves liveness (a manual heartbeat beat +
#: a select() wake) and the reporter ships the age to the router. Small
#: enough that a stall-retire threshold of ~0.5 s is testable; the beat
#: frame is a few dozen bytes on an otherwise-idle loopback socket.
BEAT_EVERY_S = 0.2

#: The code a spawned member's command line runs (``-c``, not ``-m``:
#: runpy would re-execute this module after the serving package had
#: imported it). Its arguments follow on the command line.
SPAWN_CODE = "from spark_rapids_ml_tpu_torch.serving.worker import main; raise SystemExit(main())"


def spawn_command(platform: str) -> List[str]:
    """The command line that starts one member on ``platform``."""
    return [sys.executable, "-c", SPAWN_CODE, "--platform", platform]


def encode_error(exc: BaseException) -> dict:
    """A structured wire form of the serving exceptions the router must
    reconstruct faithfully (the backpressure signal rides in the fields)."""
    if isinstance(exc, Overloaded):
        return {
            "kind": "overloaded",
            "reason": exc.reason,
            "model": exc.model,
            "queue_depth": exc.queue_depth,
            "queue_limit": exc.queue_limit,
            "reserved_bytes": exc.reserved_bytes,
            "request_bytes": exc.request_bytes,
            "mem_budget": exc.mem_budget,
            "retry_after_ms": exc.retry_after_ms,
        }
    if isinstance(exc, DeadlineExceeded):
        return {
            "kind": "deadline",
            "model": exc.model,
            "waited_ms": exc.waited_ms,
            "deadline_ms": exc.deadline_ms,
        }
    return {
        "kind": "error",
        "exc": type(exc).__name__,
        "msg": str(exc),
        "trace": traceback.format_exc(limit=8),
    }


def decode_error(err: dict) -> BaseException:
    """The router-side inverse of :func:`encode_error`."""
    if err["kind"] == "overloaded":
        extra = (
            dict(
                reserved_bytes=err["reserved_bytes"],
                request_bytes=err["request_bytes"],
                mem_budget=err["mem_budget"],
            )
            if err["reason"] == "memory"
            else {}
        )
        return Overloaded(
            err["reason"], err["model"],
            queue_depth=err["queue_depth"], queue_limit=err["queue_limit"],
            retry_after_ms=err["retry_after_ms"], **extra,
        )
    if err["kind"] == "deadline":
        return DeadlineExceeded(err["model"], err["waited_ms"], err["deadline_ms"])
    return RuntimeError(f"worker {err.get('exc')}: {err.get('msg')}")


def _to_host(tree: Any) -> Any:
    """Results cross the wire as numpy: a CUDA tensor pickled into a reply
    would bring CUDA up in the router."""
    return tree_map(lambda leaf: to_host(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf), tree)


class ServingWorker:
    """The frame loop over one member's :class:`ServingRuntime`."""

    def __init__(self, member: int, runtime: ServingRuntime):
        self.member = int(member)
        self.runtime = runtime
        self.drain = True  # shutdown mode the router requested
        self.served = 0
        self._send_lock = make_lock("serving.worker.send")
        self._conn: Optional[socket.socket] = None
        # Registry ops apply on their own thread IN ARRIVAL (= lsn)
        # order: a slow warm must not stall the submit path, but two ops
        # must never reorder (version determinism depends on it).
        self._ops: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._op_thread: Optional[threading.Thread] = None

    # --- wire helpers ---

    def _reply(self, msg_id: Any, payload: dict) -> None:
        payload["id"] = msg_id
        payload["depth"] = self.runtime.queue_depth()
        conn = self._conn
        if conn is None:  # connection already torn down
            return
        with self._send_lock:
            try:
                ipc.send_msg(conn, payload)
            except OSError:  # router gone; the recv loop will see EOF
                pass

    # --- the op log ---

    def _apply_op(self, msg: dict) -> dict:
        op = msg["op"]
        rt = self.runtime
        if op == "register":
            model = ipc.loads_model(msg["model"])
            mv = rt.register(msg["name"], model)
            return {"ok": True, "version": mv.version}
        if op == "warm":
            warmed = rt.warm(
                msg["name"], version=msg.get("version"),
                buckets=msg.get("buckets") or (),
                dtype=msg.get("dtype"),
            )
            return {"ok": True, "warmed": warmed}
        if op == "set_alias":
            rt.set_alias(msg["name"], msg["alias"], msg["version"])
            return {"ok": True}
        if op == "retire":
            rt.retire(msg["name"], msg["version"])
            return {"ok": True}
        if op == "rollback":
            v = rt.rollback(msg["name"], msg.get("alias", "prod"))
            return {"ok": True, "version": v}
        raise ValueError(f"unknown registry op {op!r}")

    def _op_loop(self) -> None:
        while True:
            msg = self._ops.get()
            if msg is None:
                return
            try:
                out = self._apply_op(msg)
            except BaseException as exc:  # noqa: BLE001 - reply, don't die
                out = {"ok": False, "error": encode_error(exc)}
            out["lsn"] = msg.get("lsn")
            bump_counter("serving.worker.ops")
            _ev.emit(
                "serving", action="replicate", member=self.member,
                op=msg["op"], lsn=msg.get("lsn"), model=msg.get("name"),
                ok=out["ok"],
            )
            self._reply(msg.get("id"), out)

    # --- the request path ---

    def _handle_submit(self, msg: dict) -> None:
        carrier = msg.get("carrier") or {}
        tc = None
        trace_id = carrier.get(_ev.TRACE_ID_ENV)
        if trace_id:
            tc = _ev.TraceContext(trace_id, carrier.get(_ev.TRACE_PARENT_ENV))
        msg_id = msg["id"]
        try:
            with _ev.trace_scope(tc):
                fut = self.runtime.submit(
                    msg["name"], msg["x"],
                    timeout=msg.get("timeout"), version=msg.get("version"),
                )
        except BaseException as exc:  # noqa: BLE001 - Overloaded et al.
            self._reply(msg_id, {"ok": False, "error": encode_error(exc)})
            return

        def _done(f):
            try:
                result = _to_host(f.result())
            except BaseException as exc:  # noqa: BLE001 - per-request
                self._reply(msg_id, {"ok": False, "error": encode_error(exc)})
                return
            self.served += 1
            # The member-side batcher stamped the (name, version) whose
            # weights actually executed; echo it so the router can
            # cross-check its admission-time resolution.
            self._reply(msg_id, {
                "ok": True, "result": result,
                "model": getattr(f, "model_name", None),
                "version": getattr(f, "model_version", None),
            })

        fut.add_done_callback(_done)

    def _status(self) -> dict:
        return {
            "ok": True,
            "member": self.member,
            "snapshot": self.runtime.snapshot(),
            "counters": {
                name: counter_value(name)
                for name in (
                    "serving.requests", "serving.batch.dispatch",
                    "serving.shed.queue", "serving.shed.memory",
                    "serving.deadline.expired", "serving.worker.ops",
                )
            },
        }

    # --- frame-loop liveness ---

    def _beat_reporter(self, hb: GangHeartbeat, stop: threading.Event) -> None:
        """Ship the frame loop's heartbeat age to the router every
        ``BEAT_EVERY_S``. Its OWN thread on purpose: when the frame loop
        wedges (a ``:stall`` fault, a GIL-holding bug), the beats it
        reports keep flowing with a growing age, which is what lets the
        router retire a stuck member whose socket never EOFs."""
        while not stop.wait(BEAT_EVERY_S):
            self._reply(None, {
                "t": "beat", "member": self.member,
                "age": hb.age_seconds(),
            })

    # --- the frame loop ---

    def serve(self, conn: socket.socket, hb: Optional[GangHeartbeat] = None) -> None:
        """Serve one router connection until shutdown or EOF.

        With a (manual-mode) heartbeat the loop select()-gates the
        blocking read so it beats every ``BEAT_EVERY_S`` even while
        idle: an idle member and a wedged one must not look alike."""
        self._conn = conn
        self._op_thread = threading.Thread(
            target=self._op_loop, name=f"tpuml-member-{self.member}-ops",
            daemon=True,
        )
        self._op_thread.start()
        stop_reporter = threading.Event()
        if hb is not None:
            threading.Thread(
                target=self._beat_reporter, args=(hb, stop_reporter),
                name=f"tpuml-member-{self.member}-beats", daemon=True,
            ).start()
        try:
            while True:
                if hb is not None:
                    hb.beat()
                    readable, _, _ = select.select([conn], [], [], BEAT_EVERY_S)
                    if not readable:
                        continue
                msg = ipc.recv_msg(conn)
                if msg is None:  # router vanished: drain and exit
                    break
                t = msg.get("t")
                if t == "submit":
                    self._handle_submit(msg)
                elif t == "op":
                    self._ops.put(msg)
                elif t == "hello":
                    self._reply(msg.get("id"), {
                        "ok": True,
                        "member": self.member,
                        "pid": os.getpid(),
                        "mem_budget": self.runtime.mem_budget,
                        "queue_limit": self.runtime.queue_limit,
                    })
                elif t == "status":
                    self._reply(msg.get("id"), self._status())
                elif t == "shutdown":
                    self.drain = bool(msg.get("drain", True))
                    # Ack AFTER the op log quiesces so a shutdown that
                    # raced a replication op still leaves every member
                    # with the full log applied.
                    self._ops.put(None)
                    self._op_thread.join(timeout=60.0)
                    self._op_thread = None
                    self._reply(msg.get("id"), {"ok": True})
                    return
                else:
                    self._reply(msg.get("id"), {
                        "ok": False,
                        "error": {"kind": "error", "exc": "ValueError",
                                  "msg": f"unknown frame type {t!r}"},
                    })
        finally:
            stop_reporter.set()
            if self._op_thread is not None:
                self._ops.put(None)
                self._op_thread.join(timeout=60.0)
                self._op_thread = None
            self._conn = None


def serve_member(
    member: int,
    rendezvous: str,
    *,
    runtime: Optional[ServingRuntime] = None,
    accept_timeout: Optional[float] = None,
) -> dict:
    """One member's whole lifecycle: publish, accept, serve, tear down.

    Returns a small summary dict (the barrier task's collected output).
    An orphaned member (no router connection within the accept timeout)
    raises ``TimeoutError`` instead of parking a process forever. The
    member computes on this process's platform (``device.set_platform``).
    """
    if not _ev.enabled():
        _ev.configure()
    timeout = (
        accept_timeout
        if accept_timeout is not None
        else env_float(CONNECT_TIMEOUT_ENV, DEFAULT_CONNECT_TIMEOUT_S, minimum=1.0)
    )
    rt = runtime if runtime is not None else ServingRuntime()
    worker = ServingWorker(member, rt)
    # A SIGTERM'd member (preemption, a kill-based retire) must still
    # publish its manifest: the flush rides the signal handler, not just
    # the happy-path finally below. Off the main thread it is a no-op.
    undo_sigterm = _ev.install_sigterm_flush()
    # The ops plane, if armed: each spawned member inherits
    # TPUML_OPS_PORT (0 = ephemeral, the only collision-free gang
    # setting) and publishes its bound port on the contact card below.
    ops = opsplane.maybe_start_from_env()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        srv.settimeout(timeout)
        port = srv.getsockname()[1]
        ipc.publish_member(rendezvous, member, "127.0.0.1", port,
                           ops_port=ops.port if ops is not None else None)
        _ev.emit("serving", action="member_up", member=member, port=port,
                 mem_budget=rt.mem_budget)
        # Manual-mode heartbeat: the FRAME LOOP beats it, so the age is
        # a statement about the loop that serves requests (the one a
        # stall freezes), not about a side thread that would keep
        # beating through the freeze.
        with heartbeat_scope(member, what="serving", manual=True) as hb:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                raise TimeoutError(
                    f"serving member {member} saw no router connection in "
                    f"{timeout:.0f}s ({CONNECT_TIMEOUT_ENV})"
                ) from None
            try:
                worker.serve(conn, hb=hb)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
    finally:
        try:
            srv.close()
        except OSError:
            pass
        # The drained-gang contract: close retires the runtime's callable
        # gauges, the heartbeat scope above retired its age gauge, and
        # the shard flush publishes this member's manifest + metrics.
        rt.close(drain=worker.drain)
        _ev.emit("serving", action="member_down", member=member,
                 drain=worker.drain, served=worker.served)
        _ev.flush_telemetry()
        undo_sigterm()
    return {"member": int(member), "served": worker.served, "drain": worker.drain}


def main(argv: Optional[List[str]] = None) -> int:
    """Spawn-mode entry (:data:`SPAWN_CODE`, ``--platform cuda|cpu``).
    On ``cuda`` without a card the member raises before it publishes, so
    the router's launch fails naming it."""
    parser = argparse.ArgumentParser(prog="serving-member")
    parser.add_argument("--platform", choices=_device.PLATFORMS, default=_device.get_platform())
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    rendezvous = env_str(RENDEZVOUS_ENV)
    member = env_int(MEMBER_ENV)
    if not rendezvous or member is None:
        raise SystemExit(
            f"{RENDEZVOUS_ENV} and {MEMBER_ENV} must be set for a spawned "
            "serving member"
        )
    _device.set_platform(args.platform)
    _device.resolve_device()  # on "cuda" without a card: raise, never serve on the CPU
    serve_member(member, rendezvous)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
