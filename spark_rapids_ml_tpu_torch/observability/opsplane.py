"""Per-process ops server — the live face of the observability tier.

Port of the reference's ``observability/opsplane.py``. Everything else
in this package is post-hoc: dump-at-exit snapshots, merged after the
gang is gone. ``TPUML_OPS_PORT=<port>`` (0 = ephemeral) puts a stdlib
``http.server`` daemon thread, bound to 127.0.0.1, in every process that
imports the package, serving the live registries:

  - ``/metrics`` — Prometheus text from the live registry, rendered by
    the SAME function as ``TPUML_METRICS_DUMP``
    (:func:`metrics.render_prometheus_snapshot`);
  - ``/healthz`` — liveness synthesized from gang-heartbeat age
    (``TPUML_OPS_STALL_S``), lockcheck stall-watchdog strikes, and any
    registered component probes (a serving runtime's dispatcher-thread
    aliveness); 503 the moment a member is wedged, not when its socket
    finally EOFs;
  - ``/varz`` — one JSON document: counters/gauges/histograms, the
    cost-ledger rollup, autotune incumbents, serving registry
    versions+aliases, admission budgets, and every live router's
    snapshot (``routers``);
  - ``/tracez`` — recent closed spans plus every thread's currently-open
    span stack (``utils.tracing.open_spans``).

The bound port is published in the telemetry manifest
(``events.flush_telemetry``). :func:`add_endpoint` registers extra
paths (the reference's router puts its gang-merged ``/statusz`` there).
Unset (the default), nothing starts and nothing is allocated.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from spark_rapids_ml_tpu_torch.utils.envknobs import (
    EnvKnobError,
    env_float,
    env_int,
)
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock

OPS_PORT_ENV = "TPUML_OPS_PORT"
OPS_STALL_ENV = "TPUML_OPS_STALL_S"

#: An endpoint returns ``(status, content_type, body)``.
Endpoint = Callable[[], Tuple[int, str, str]]

_lock = make_lock("opsplane.state")
_server: Optional["OpsServer"] = None  # guarded-by: _lock
#: Extra endpoints (``/statusz`` from a router) — resolved per request,
#: so registration order vs server start does not matter.
_extra_endpoints: Dict[str, Endpoint] = {}  # guarded-by: _lock
#: Component health probes: name -> fn() -> truthy when healthy.
_probes: Dict[str, Callable[[], bool]] = {}  # guarded-by: _lock


def add_endpoint(path: str, fn: Endpoint) -> None:
    """Register an extra GET endpoint (e.g. the router's ``/statusz``)."""
    if not path.startswith("/"):
        raise ValueError(f"endpoint path must start with '/': {path!r}")
    with _lock:
        _extra_endpoints[path] = fn


def remove_endpoint(path: str, fn: Optional[Endpoint] = None) -> None:
    """Unregister ``path``. With ``fn`` given, remove only when the
    registration is still ``fn`` — a closing router must not tear down
    a ``/statusz`` a newer router has since claimed."""
    with _lock:
        if fn is None or _extra_endpoints.get(path) is fn:
            _extra_endpoints.pop(path, None)


def add_probe(name: str, fn: Callable[[], bool]) -> None:
    """Register a liveness probe folded into ``/healthz`` (a probe that
    returns falsy or raises marks the process unhealthy)."""
    with _lock:
        _probes[name] = fn


def remove_probe(name: str) -> None:
    with _lock:
        _probes.pop(name, None)


# --- the built-in endpoint bodies --------------------------------------


def _json_body(doc: dict, status: int = 200) -> Tuple[int, str, str]:
    return status, "application/json", json.dumps(doc, indent=2, default=str) + "\n"


def metrics_body() -> Tuple[int, str, str]:
    from spark_rapids_ml_tpu_torch.observability.metrics import default_registry

    return (
        200,
        "text/plain; version=0.0.4; charset=utf-8",
        default_registry.render_prometheus(),
    )


def healthz_doc() -> dict:
    """The liveness synthesis: heartbeat age, stall strikes, probes."""
    import time

    from spark_rapids_ml_tpu_torch.observability.heartbeat import AGE_GAUGE
    from spark_rapids_ml_tpu_torch.observability.metrics import default_registry
    from spark_rapids_ml_tpu_torch.utils import lockcheck

    checks: Dict[str, dict] = {}
    # 1) gang heartbeat age: a wedged member's manual-beat loop stops
    #    beating, its age grows, and THIS flips before any socket EOFs.
    limit_s = env_float(OPS_STALL_ENV, 30.0, minimum=0.0)
    ages = {}
    hb = default_registry.metrics().get(AGE_GAUGE)
    if hb is not None:
        ages = {
            ",".join(f"{k}={v}" for k, v in key) or "_": v
            for key, v in hb._snapshot_series().items()
        }
    worst = max(ages.values()) if ages else None
    checks["heartbeat"] = {
        "ok": (
            limit_s <= 0
            or worst is None
            or (worst == worst and worst <= limit_s)
        ),
        "max_age_s": worst,
        "limit_s": limit_s,
        "series": ages,
    }
    # 2) lockcheck stall strikes: slow is evidence — a watchdog strike
    #    means some thread waited past TPUML_LOCKCHECK_STALL_MS.
    stalls = [v for v in lockcheck.violations() if v.get("kind") == "stall"]
    checks["lockcheck"] = {"ok": not stalls, "stall_strikes": len(stalls)}
    # 3) registered component probes (dispatcher-thread aliveness, ...).
    with _lock:
        probes = dict(_probes)
    for name, fn in sorted(probes.items()):
        try:
            checks[name] = {"ok": bool(fn())}
        except Exception as exc:  # a dead probe IS a failed probe
            checks[name] = {"ok": False, "exc": type(exc).__name__}
    return {
        "ok": all(c["ok"] for c in checks.values()),
        "ts": time.time(),
        "checks": checks,
    }


def healthz_body() -> Tuple[int, str, str]:
    doc = healthz_doc()
    return _json_body(doc, status=200 if doc["ok"] else 503)


def varz_doc() -> dict:
    import os
    import time

    from spark_rapids_ml_tpu_torch.observability import events as _ev
    from spark_rapids_ml_tpu_torch.observability.metrics import default_registry

    doc = {
        "pid": os.getpid(),
        "process": _ev._resolve_process_index(),
        "ts": time.time(),
        "mono": time.monotonic(),
        "ops_port": active_port(),
        "metrics": default_registry.snapshot(),
    }
    try:
        from spark_rapids_ml_tpu_torch.observability import costs as _costs

        snap = (
            _costs.ledger_snapshot() if _costs.active() is not None else None
        )
        doc["costs"] = (
            {"families": _costs.family_rollup(snap), "programs": len(
                snap.get("programs", []))}
            if snap
            else None
        )
    except Exception:  # pragma: no cover - a rollup bug must not 500 /varz
        doc["costs"] = None
    try:
        from spark_rapids_ml_tpu_torch.observability import autotune as _autotune

        doc["autotune"] = (
            _autotune.tuner_snapshot()
            if _autotune.active() is not None
            else None
        )
    except Exception:  # pragma: no cover
        doc["autotune"] = None
    # Serving registries + admission budgets: every live in-process
    # runtime (queue_limit, mem_budget, models/versions/aliases) and
    # every live router.
    try:
        from spark_rapids_ml_tpu_torch.serving import server as _server_mod

        doc["serving"] = _server_mod.runtime_snapshots()
    except Exception:
        doc["serving"] = []
    try:
        from spark_rapids_ml_tpu_torch.serving import router as _router_mod

        doc["routers"] = _router_mod.router_snapshots()
    except Exception:
        doc["routers"] = []
    return doc


def varz_body() -> Tuple[int, str, str]:
    return _json_body(varz_doc())


def tracez_doc() -> dict:
    from spark_rapids_ml_tpu_torch.utils import tracing

    return {
        "open": tracing.open_spans(),
        "recent": [
            {"name": name, "start": start, "end": end,
             "dur": round(end - start, 6)}
            for name, start, end in tracing.recent_events()[-200:]
        ],
    }


def tracez_body() -> Tuple[int, str, str]:
    return _json_body(tracez_doc())


_BUILTIN: Dict[str, Endpoint] = {
    "/metrics": metrics_body,
    "/healthz": healthz_body,
    "/varz": varz_body,
    "/tracez": tracez_body,
}


# --- the server ---------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpuml-ops"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler protocol
        path = self.path.partition("?")[0]
        with _lock:
            fn = _extra_endpoints.get(path)
            extra = list(_extra_endpoints)
        if fn is None:
            fn = _BUILTIN.get(path)
        if fn is None:
            body = json.dumps(
                {"error": "not found",
                 "endpoints": sorted(list(_BUILTIN) + extra)}
            ) + "\n"
            self._reply(404, "application/json", body)
            return
        try:
            status, ctype, body = fn()
        except Exception as exc:  # noqa: BLE001 - a scrape must not kill
            self._reply(
                500, "application/json",
                json.dumps({"error": type(exc).__name__}) + "\n",
            )
            return
        self._reply(status, ctype, body)

    def _reply(self, status: int, ctype: str, body: str) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, format, *args):  # noqa: A002 - protocol name
        pass  # scrape logging belongs to metrics, not stderr


class OpsServer:
    """One process's ops HTTP server: loopback-only, daemon threads."""

    def __init__(self, port: int = 0):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"tpuml-ops-{self.port}",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start(port: int = 0) -> OpsServer:
    """Start (or return) THE per-process ops server."""
    global _server
    with _lock:
        if _server is not None:
            return _server
        _server = OpsServer(port)
        srv = _server
    try:
        from spark_rapids_ml_tpu_torch.observability.events import emit

        emit("telemetry", action="ops_up", path=srv.url)
    except Exception:  # pragma: no cover
        pass
    return srv


def maybe_start_from_env() -> Optional[OpsServer]:
    """Start the server iff ``TPUML_OPS_PORT`` is set (idempotent;
    called at package import and by long-lived serving processes)."""
    with _lock:
        if _server is not None:
            return _server
    try:
        port = env_int(OPS_PORT_ENV, minimum=0)
    except EnvKnobError:
        return None
    if port is None:
        return None
    return start(port)


def active() -> Optional[OpsServer]:
    with _lock:
        return _server


def active_port() -> Optional[int]:
    with _lock:
        return _server.port if _server is not None else None


def stop() -> None:
    """Shut the server down (test isolation; production servers are
    daemon threads that die with the process)."""
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.close()
