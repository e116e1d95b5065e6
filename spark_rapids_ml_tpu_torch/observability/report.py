"""End-of-call reports — per-fit attribution. Port of the reference's
``observability/report.py``.

The estimator base class runs each ``fit`` inside a :class:`RunRecorder`,
and the finished :class:`RunReport` hangs off the model
(``model.fit_report()``) with

  - the **stage-timing tree** rebuilt from the run's spans (TraceRange
    records span id / parent / depth / ok / exception type, so the
    ingest, solver and collective ranges nest the way the code did);
  - aggregate **stage totals** (seconds and call counts per range name);
    a span's time is host time: around a CUDA launch it is the enqueue,
    not the card's work, as the reference's spans time JAX's dispatch;
  - the **counter deltas** the call produced (checkpoint writes and
    restores, retry attempts, serving cache traffic, ingest, persistence);
  - **device memory stats** for every local CUDA device (the reference's
    keys ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), also
    published as ``device.memory.*`` gauges.

``RunReport.costs`` and ``.hbm`` stay empty: the cost ledger is ROADMAP
A.9 step 5's later part, and ``TPUML_COST_LEDGER`` raises at the recorder.
:func:`serving_report` reads the router and the autotuner in the
reference, and waits for item 17b. :func:`gang_report` merges a gang's
telemetry shards.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from spark_rapids_ml_tpu_torch.observability import events
from spark_rapids_ml_tpu_torch.observability.metrics import default_registry, gauge
from spark_rapids_ml_tpu_torch.observability.profiling import maybe_profile
from spark_rapids_ml_tpu_torch.utils.envknobs import reject_step5_later

SERVING_REPORT_ITEM = (
    "serving_report is not ported yet: the reference's reads the distributed "
    "serving tier's routers and the autotuner, ROADMAP A.9, item 17b"
)

#: Counter prefixes a report folds into its summary.
_REPORT_PREFIXES = ("serving.", "checkpoint.", "retry.", "gang.", "ingest.",
                    "persistence.", "degrade.")


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{device index: stats}`` for every local CUDA device, in the
    reference's keys: ``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``), ``bytes_limit`` (the
    device's total memory, from ``mem_get_info`` where the process holds
    memory there), ``bytes_reserved`` and ``peak_bytes_reserved`` (the
    caching allocator's). Without CUDA, or before it is initialised, it
    returns ``{}``, as the reference does on the CPU. Each scrape also
    refreshes the ``device.memory.bytes_in_use`` / ``.peak_bytes_in_use``
    / ``.bytes_limit`` gauges, labeled by device."""
    import torch

    out: Dict[str, Dict[str, int]] = {}
    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return out
        count = torch.cuda.device_count()
    except Exception:  # a report must never fail a fit
        return out
    for i in range(count):
        try:
            stats = torch.cuda.memory_stats(i)
            reserved = int(stats.get("reserved_bytes.all.current", 0))
            limit = (torch.cuda.mem_get_info(i)[1] if reserved
                     else torch.cuda.get_device_properties(i).total_memory)
            out[str(i)] = {
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                "bytes_limit": int(limit),
                "bytes_reserved": reserved,
                "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
            }
        except Exception:
            continue
        for field, metric in (
            ("bytes_in_use", "device.memory.bytes_in_use"),
            ("peak_bytes_in_use", "device.memory.peak_bytes_in_use"),
            ("bytes_limit", "device.memory.bytes_limit"),
        ):
            gauge(metric, f"per-device {field}").set(out[str(i)][field], device=str(i))
    return out


def build_stage_tree(spans: List[dict]) -> List[dict]:
    """Nest a span window into a stage tree via parent ids: each node is
    ``{name, dur, ok, exc, thread, children}``. Spans whose parent closed
    outside the window root themselves."""
    by_id: Dict[int, dict] = {}
    roots: List[dict] = []
    for s in spans:
        by_id[s["span"]] = {
            "name": s["name"],
            "dur": s["dur"],
            "ok": s["ok"],
            "exc": s["exc"],
            "thread": s["thread"],
            "children": [],
        }
    for s in spans:
        node = by_id[s["span"]]
        parent = by_id.get(s.get("parent"))
        (parent["children"] if parent is not None else roots).append(node)
    return roots


def stage_totals(spans: List[dict]) -> Dict[str, Dict[str, float]]:
    """``{range name: {seconds, calls}}`` aggregated over a span window."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        cell = out.setdefault(s["name"], {"seconds": 0.0, "calls": 0})
        cell["seconds"] += s["dur"]
        cell["calls"] += 1
    return out


class RunReport:
    """One finished run's attribution. Plain data — picklable, JSON-able
    via :meth:`summary`."""

    def __init__(
        self,
        run_id: str,
        kind: str,
        label: str,
        wall_seconds: float,
        spans: List[dict],
        counters: Dict[str, float],
        device_memory: Dict[str, Dict[str, int]],
        ok: bool = True,
        costs: Optional[List[dict]] = None,
        hbm: Optional[dict] = None,
    ):
        self.run_id = run_id
        self.kind = kind
        self.label = label
        self.wall_seconds = wall_seconds
        self.spans = spans
        self.counters = counters
        self.device_memory = device_memory
        self.ok = ok
        #: Per-program cost-ledger rows for this run, and HBM growth by
        #: span: empty until the cost ledger is ported (ROADMAP A.9, step
        #: 5's later part).
        self.costs = costs or []
        self.hbm = hbm or {}

    def stage_tree(self) -> List[dict]:
        return build_stage_tree(self.spans)

    def stage_totals(self) -> Dict[str, Dict[str, float]]:
        return stage_totals(self.spans)

    def compile_count(self) -> int:
        """Compiles attributed to this run: compile-named spans plus the
        serving-layer compile counter delta (whichever layer saw them)."""
        from_spans = sum(1 for s in self.spans if "compile" in s["name"])
        return max(from_spans, int(self.counters.get("serving.compile", 0)))

    def checkpoint_activity(self) -> Dict[str, float]:
        return {
            k: v for k, v in self.counters.items() if k.startswith("checkpoint.")
        }

    def cost_table(self) -> List[dict]:
        """The run's per-program flops/bytes attribution (empty until the
        cost ledger is ported)."""
        return self.costs

    def top_hot_spot(self) -> Optional[dict]:
        """The costliest ledger row by wall time — the next demolition
        target once the current hot spots are optimized. Returns the row
        dict plus its ``wall_share`` of the run's total attributed wall,
        or None when the ledger is off or recorded no wall time."""
        timed = [r for r in self.costs if r.get("wall_seconds")]
        if not timed:
            return None
        total = sum(r["wall_seconds"] for r in timed)
        top = max(timed, key=lambda r: r["wall_seconds"])
        out = dict(top)
        out["wall_share"] = top["wall_seconds"] / total if total > 0 else 0.0
        return out

    def summary(self) -> dict:
        out = {
            "run_id": self.run_id,
            "kind": self.kind,
            "label": self.label,
            "ok": self.ok,
            "wall_seconds": self.wall_seconds,
            "stages": self.stage_totals(),
            "compiles": self.compile_count(),
            "counters": self.counters,
            "checkpoint": self.checkpoint_activity(),
            "device_memory": self.device_memory,
        }
        if self.costs:
            out["costs"] = self.costs
        if self.hbm:
            out["hbm"] = self.hbm
        return out

    def _render_tree(self, nodes: List[dict], indent: int, lines: List[str]) -> None:
        for n in nodes:
            flag = "" if n["ok"] else f"  !! {n['exc'] or 'failed'}"
            lines.append(
                f"{'  ' * indent}{n['name']:<32s} {n['dur'] * 1e3:10.2f} ms{flag}"
            )
            self._render_tree(n["children"], indent + 1, lines)

    def __str__(self) -> str:
        lines = [
            f"{self.kind} report  [{self.label}]  run_id={self.run_id}",
            f"  wall: {self.wall_seconds:.3f}s  ok: {self.ok}  "
            f"compiles: {self.compile_count()}",
            "  stages:",
        ]
        self._render_tree(self.stage_tree(), 2, lines)
        interesting = {
            k: v for k, v in sorted(self.counters.items()) if v
        }
        if interesting:
            lines.append("  counters:")
            for k, v in interesting.items():
                lines.append(f"    {k} = {v}")
        for dev, stats in self.device_memory.items():
            if "bytes_in_use" in stats:
                lines.append(
                    f"  device {dev}: {stats['bytes_in_use']} bytes in use"
                )
        if self.costs:
            hot = self.top_hot_spot()
            lines.append("  where the FLOPs and bytes went:")
            lines.append(
                f"    {'program':<40s} {'kind':<8s} {'calls':>6s} "
                f"{'flops/call':>12s} {'bytes/call':>12s} {'wall ms':>9s} "
                f"{'GFLOP/s':>8s} {'util':>6s}"
            )
            for row in self.costs:
                flops = row.get("flops")
                byts = row.get("bytes_accessed")
                rate = row.get("achieved_flops_per_sec")
                util = row.get("utilization")
                # Flag the top residual hot spot: the row that would pay
                # the most to optimize next.
                is_hot = (
                    hot is not None
                    and row.get("family") == hot.get("family")
                    and row.get("kind") == hot.get("kind")
                )
                mark = (
                    f"  << hot spot ({hot['wall_share']:.0%} of wall)"
                    if is_hot
                    else ""
                )
                lines.append(
                    f"    {str(row.get('family'))[:40]:<40s} "
                    f"{str(row.get('kind')):<8s} "
                    f"{row.get('invocations', 0):>6d} "
                    f"{(f'{flops:.3g}' if flops is not None else 'n/a'):>12s} "
                    f"{(f'{byts:.3g}' if byts is not None else 'n/a'):>12s} "
                    f"{(row.get('wall_seconds') or 0.0) * 1e3:>9.2f} "
                    f"{(f'{rate / 1e9:.2f}' if rate else '-'):>8s} "
                    f"{(f'{util:.1%}' if util is not None else '-'):>6s}"
                    f"{mark}"
                )
        if self.hbm.get("by_span"):
            lines.append(
                f"  HBM peak growth: {self.hbm.get('delta', 0)} bytes"
            )
            for span_name, grew in sorted(
                self.hbm["by_span"].items(), key=lambda kv: -kv[1]
            ):
                lines.append(f"    {span_name:<40s} +{grew} bytes")
        return "\n".join(lines)


class RunRecorder:
    """Context manager wrapping one fit/transform: opens (or joins) a
    run scope, optionally a ``torch.profiler`` session (``TPUML_PROFILE_DIR``),
    snapshots counters, and on exit builds the :class:`RunReport`,
    emits the ``counters`` flush + ``report`` events, and refreshes the
    device-memory gauges. ``attach(model)`` hangs the report on the
    fitted model (``model.fit_report()``)."""

    def __init__(self, kind: str, label: str = ""):
        self.kind = kind
        self.label = label
        self.report: Optional[RunReport] = None
        self._scope = None
        self._profile = None

    def __enter__(self) -> "RunRecorder":
        reject_step5_later("TPUML_COST_LEDGER", "TPUML_COST_LEDGER_DUMP")
        self._profile = maybe_profile(f"{self.kind}:{self.label}")
        self._profile.__enter__()
        self._scope = events.run_scope(self.kind, self.label)
        self._ctx = self._scope.__enter__()
        self._span_start = self._ctx.span_count()
        self._t0 = time.monotonic()
        self._counters0 = default_registry.counters_snapshot()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.monotonic() - self._t0
        try:
            spans = self._ctx.span_window(self._span_start)
            now = default_registry.counters_snapshot()
            delta = {
                k: v - self._counters0.get(k, 0)
                for k, v in now.items()
                if k.startswith(_REPORT_PREFIXES)
                and v != self._counters0.get(k, 0)
            }
            self.report = RunReport(
                run_id=self._ctx.run_id,
                kind=self.kind,
                label=self.label,
                wall_seconds=wall,
                spans=spans,
                counters=delta,
                device_memory=device_memory_stats(),
                ok=exc_type is None,
            )
            if events.enabled():
                events.emit("counters", counters=delta, kind=self.kind,
                            label=self.label)
                events.emit("report", kind=self.kind,
                            summary=self.report.summary())
        finally:
            self._scope.__exit__(exc_type, exc, tb)
            self._profile.__exit__(exc_type, exc, tb)
        return False

    def attach(self, obj: Any, attr: str = "_fit_report") -> None:
        if obj is not None and self.report is not None:
            try:
                setattr(obj, attr, self.report)
            except AttributeError:  # __slots__ objects opt out
                pass


# --- the serving-side report ------------------------------------------


def serving_report() -> dict:
    """Not ported: the reference's reads the routers of the distributed
    serving tier and the autotuner (:data:`SERVING_REPORT_ITEM`)."""
    raise NotImplementedError(SERVING_REPORT_ITEM)


# --- the gang-wide report ----------------------------------------------


def gang_report(telemetry_dir: Optional[str] = None) -> dict:
    """The whole-gang section: per-member telemetry shards under
    ``telemetry_dir`` (default: the active ``TPUML_TELEMETRY_DIR``)
    merged into one view — summed counters, merged histograms, max
    gauges — with the per-member breakdown kept alongside, plus one
    entry per assembled trace (span count, member processes, critical
    path). This is what a launcher prints after a gang fit to see all N
    members at once. The reference also merges the members' cost-ledger
    shards here; the port writes none (the ledger is step 5's later
    part)."""
    from spark_rapids_ml_tpu_torch.observability.events import telemetry_dir as _tdir
    from spark_rapids_ml_tpu_torch.observability.trace import assemble

    tdir = telemetry_dir if telemetry_dir is not None else _tdir()
    if not tdir:
        raise ValueError(
            "gang_report needs a telemetry dir (pass one or set "
            "TPUML_TELEMETRY_DIR)"
        )
    merged = assemble(tdir)
    members = []
    by_pid = {m.get("pid"): m for m in merged["manifests"]}
    for cell in merged["metrics"]["members"]:
        snap = cell["snapshot"]
        pid = None
        # metrics-<pid>.json — recover the member identity from the name.
        stem = cell["file"].rsplit(".", 1)[0]
        if "-" in stem:
            try:
                pid = int(stem.rsplit("-", 1)[1])
            except ValueError:
                pid = None
        manifest = by_pid.get(pid, {})
        members.append(
            {
                "pid": pid,
                "process": manifest.get("process"),
                "trace_roots": manifest.get("trace_roots", []),
                "emitted": manifest.get("emitted"),
                "counters": snap.get("counters", {}),
                "gauges": snap.get("gauges", {}),
            }
        )
    return {
        "dir": tdir,
        "members": members,
        "merged": merged["metrics"]["merged"],
        "traces": merged["traces"],
        "problems": merged["problems"] + merged["orphan_problems"],
        "warnings": merged["warnings"],
    }
