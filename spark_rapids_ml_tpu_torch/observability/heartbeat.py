"""Gang heartbeats — distinguishing a STUCK member from a slow one.

Port of the reference's ``observability/heartbeat.py``. The failure
detector the gang already has (the collectives' timeout,
``TPUML_HEARTBEAT_TIMEOUT``) only fires when a process is DEAD; a
member that is alive but wedged — stuck in a collective its
peers never entered, spinning in host code — looks identical to a slow
one until the stage deadline fires. A heartbeat record per
process per interval makes the difference observable BEFORE then:

  - each gang member runs one daemon thread (``heartbeat_scope``)
    writing a ``heartbeat`` event (sequence number, interval,
    process id) to the event log every ``TPUML_GANG_HEARTBEAT_EVERY``
    seconds (default 5; ``0`` disables);
  - the ``gang.heartbeat.age_seconds`` gauge (labeled by process) reads
    the age of the LAST beat at scrape time — a wedged worker's age
    grows while its peers' stay near zero, so ``grep heartbeat`` on the
    merged event stream or one Prometheus scrape names the stuck rank.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Optional

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.observability.metrics import gauge
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float

HEARTBEAT_EVERY_ENV = "TPUML_GANG_HEARTBEAT_EVERY"
DEFAULT_INTERVAL = 5.0

AGE_GAUGE = "gang.heartbeat.age_seconds"


def heartbeat_interval() -> float:
    """Seconds between beats; 0 disables the thread."""
    return env_float(HEARTBEAT_EVERY_ENV, DEFAULT_INTERVAL, minimum=0.0)


class GangHeartbeat:
    """One process's heartbeat stream: a daemon thread beating every
    ``interval`` seconds until :meth:`stop`.

    Each beat emits a ``heartbeat`` event and refreshes the last-beat
    timestamp behind the ``gang.heartbeat.age_seconds`` gauge (a
    callable gauge, so scrapes read the CURRENT age, not a stale one).
    """

    def __init__(self, process_id: int = 0, interval: Optional[float] = None,
                 what: str = "gang", manual: bool = False):
        self.process_id = int(process_id)
        self.interval = heartbeat_interval() if interval is None else float(interval)
        self.what = what
        # Manual mode: no beat thread — the OWNER's loop calls beat(), so
        # the age gauge measures THAT loop's liveness, not a thread that
        # would happily keep beating while the loop is wedged. Beats can
        # arrive much faster than ``interval``; heartbeat EVENTS are
        # throttled to one per interval (0 disables events entirely, the
        # same contract as the threaded mode — the gauge stays live).
        self.manual = bool(manual)
        # The beat thread and the caller's thread (beat 1, stop, gauge
        # scrapes) both touch the beat state: one lock owns it.
        self._lock = threading.Lock()
        self.seq = 0  # guarded-by: _lock
        self._last = time.monotonic()  # guarded-by: _lock
        self._last_emit = float("-inf")  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registered = False

    def age_seconds(self) -> float:
        with self._lock:
            last = self._last
        return time.monotonic() - last

    def beat(self) -> None:
        # Snapshot under the lock, emit outside it: the event sink does
        # its own locking and must not nest inside ours.
        with self._lock:
            self.seq += 1
            now = time.monotonic()
            self._last = now
            seq = self.seq
            if self.manual:
                if self.interval <= 0 or now - self._last_emit < self.interval:
                    return
                self._last_emit = now
        emit(
            "heartbeat",
            seq=seq,
            interval=self.interval,
            what=self.what,
            process=self.process_id,
        )

    def start(self) -> "GangHeartbeat":
        if self._thread is not None or (not self.manual and self.interval <= 0):
            return self
        if self._registered:
            return self
        gauge(
            AGE_GAUGE, "seconds since this process's last gang heartbeat"
        ).set_function(self.age_seconds, process=str(self.process_id))
        self._registered = True
        self.beat()  # beat 1 lands immediately: liveness from t=0
        if self.manual:
            return self  # the owner's loop beats from here on

        def _loop():
            while not self._stop.wait(self.interval):
                self.beat()

        # The beat thread runs under a COPY of the caller's context, so
        # every beat carries the member's run_id and trace id — not just
        # the first one (which lands from the calling thread above).
        ctx = contextvars.copy_context()
        self._thread = threading.Thread(
            target=ctx.run, args=(_loop,),
            name=f"tpuml-heartbeat-{self.process_id}", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
            self._thread = None
        if self._registered:
            # A finished member must not keep reporting an ever-growing
            # age into merged gang snapshots: retire the series.
            gauge(AGE_GAUGE).remove(process=str(self.process_id))
            self._registered = False


@contextlib.contextmanager
def heartbeat_scope(process_id: int = 0, interval: Optional[float] = None,
                    what: str = "gang", manual: bool = False):
    """Heartbeats for the duration of a block (a gang member's fit)."""
    hb = GangHeartbeat(process_id, interval, what=what, manual=manual)
    hb.start()
    try:
        yield hb
    finally:
        hb.stop()
