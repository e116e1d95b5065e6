"""Length-prefixed pickle framing for the router <-> worker socket hop.

Port of the reference's ``serving/ipc.py``; the wire format is the
reference's, byte for byte. The distributed serving tier
(``serving/router.py`` front door, one ``serving/worker.py`` process per
member) talks over one persistent loopback TCP connection per member.
Frames are ``4-byte big-endian length + pickle``; every request dict
carries an ``id`` the reply echoes, so the router can pipeline many
requests down one connection and a receiver thread demultiplexes replies
onto per-request futures.

Only host objects cross the wire: numpy row blocks and results go
through the protocol-5 fast path, and a model is pickled by value (its
device state materialises as host arrays, ``core/lazy_state.py``), so
the receiving process never meets a CUDA tensor and places the model on
its own device. Models go through cloudpickle where it is installed, as
the reference's do, with a fallback to plain pickle (port models pickle
by value, ``core/params.py``).

Workers only ever bind 127.0.0.1 and members rendezvous through a
shared directory of ``member-<id>.json`` files (atomic tmp+rename
writes), mirroring the coordinator handoff in ``parallel/distributed``.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import struct
import tempfile
from typing import Any, Optional

from spark_rapids_ml_tpu_torch.robustness.faults import fault_point

_LEN = struct.Struct(">I")

#: Frames above this are refused before allocation: a corrupt length
#: prefix must fail loudly, not trigger a multi-GB read.
MAX_FRAME_BYTES = 1 << 31


def dumps_model(model: Any) -> bytes:
    """Serialize a model object for registry replication."""
    try:
        import cloudpickle
    except ImportError:
        return pickle.dumps(model, protocol=pickle.HIGHEST_PROTOCOL)
    return cloudpickle.dumps(model)


def loads_model(blob: bytes) -> Any:
    return pickle.loads(blob)


def send_msg(sock: socket.socket, msg: dict) -> None:
    """One framed message. The caller serializes access per socket.

    ``ipc.send`` is a chaos site: an armed plan makes this frame die
    before any byte hits the wire, so the peer sees a clean EOF when the
    faulted process exits (the half-written-conversation shape a crash
    between frames produces)."""
    fault_point("ipc.send")
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:  # orderly EOF mid-frame or between frames
            return None
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """The next framed message, or None on orderly EOF.

    ``ipc.recv`` is a chaos site, checked BEFORE the blocking read: a
    member armed with ``ipc.recv=1`` dies mid-conversation (its serve
    loop re-raises), ``ipc.recv=always:stall`` freezes the frame loop,
    the stuck-member shape the heartbeat retire path exists for."""
    fault_point("ipc.recv")
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"ipc frame of {length} bytes exceeds the bound")
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    return pickle.loads(payload)


# --- the rendezvous directory ------------------------------------------


def member_path(rendezvous: str, member: int) -> str:
    return os.path.join(rendezvous, f"member-{int(member)}.json")


def publish_member(rendezvous: str, member: int, host: str, port: int,
                   ops_port: Optional[int] = None) -> str:
    """Atomically publish one member's contact card (tmp + rename, the
    torn-write posture of the checkpoint layer). ``ops_port`` (when the
    member runs an ops server) rides the card so the router can scrape
    the member's live ``/varz`` for the gang ``/statusz``."""
    os.makedirs(rendezvous, exist_ok=True)
    card = {"member": int(member), "pid": os.getpid(), "host": host,
            "port": int(port)}
    if ops_port is not None:
        card["ops_port"] = int(ops_port)
    fd, tmp = tempfile.mkstemp(dir=rendezvous, prefix=f".member-{member}-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(card, f)
        path = member_path(rendezvous, member)
        os.replace(tmp, path)
        return path
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_member(rendezvous: str, member: int) -> Optional[dict]:
    """The member's contact card, or None while it hasn't published."""
    path = member_path(rendezvous, member)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
