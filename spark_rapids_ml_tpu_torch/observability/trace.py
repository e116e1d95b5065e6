"""Gang-wide trace assembly — merging per-process telemetry shards.

Port of the reference's ``observability/trace.py`` (pure Python, kept
equal to it), over the same shard, manifest and flight-dump formats, so
either package's assembler reads the other's telemetry directory.

A multi-process run under ``TPUML_TELEMETRY_DIR`` leaves N event-log
shards (``events-<pid>.jsonl``), N metrics snapshots and N manifests
(``events.flush_telemetry``). Individually they are islands; this module
is the join (the profiling discipline of "Large Scale Distributed Linear
Algebra With TPUs": measure per member, reason about the whole):

  - :func:`read_shards` loads everything under a dir, schema-validating
    each record with the SAME validator the event log declares;
  - :func:`align_records` puts every record on ONE clock: per process,
    the median (wall − monotonic) offset maps its monotonic stamps onto
    wall time, keeping monotonic intra-process precision while anchoring
    processes to each other (span endpoints derive from the emit-time
    monotonic stamp minus the recorded duration, so ``perf_counter`` vs
    ``monotonic`` epoch differences never leak in);
  - :func:`build_traces` groups records by trace id and resolves every
    span's parent ACROSS shards (span ids are globally unique), naming
    roots and orphans;
  - :func:`critical_path` walks from the last-ending span up to its
    root — the chain that determined the trace's completion time;
  - :func:`chrome_trace` renders Chrome/Perfetto trace-event JSON
    (one Perfetto row per process, spans as complete events, everything
    else as instants);
  - :func:`merge_metrics` folds the per-member snapshots into gang-wide
    totals: counters SUM, histogram buckets/sums/counts SUM (same-name
    series share fixed buckets by construction), gauges take the MAX —
    per-member values stay visible through their labels and the
    per-member section.

``observability.report.gang_report`` is the fit-report integration
(the reference's CLI, ``tools/tpuml_trace.py``, reads the port's
directories as they are).
"""

from __future__ import annotations

import glob
import json
import os
import statistics
from typing import Any, Dict, List

from spark_rapids_ml_tpu_torch.observability.events import validate_record

SHARD_GLOB = "events-*.jsonl"
MANIFEST_GLOB = "manifest-*.json"
METRICS_GLOB = "metrics-*.json"
FLIGHT_GLOB = "flight-*.json"


def read_shards(telemetry_dir: str) -> dict:
    """Load every shard under ``telemetry_dir``.

    Returns ``{"records", "manifests", "metrics", "flights",
    "problems"}`` — ``records`` in shard order with line provenance kept
    out-of-band in ``problems`` strings (``shard:line: <why>``),
    ``metrics`` as ``{"file", "snapshot"}`` pairs, ``manifests`` as
    decoded dicts.

    A ``flight-<pid>.json`` crash dump (``observability/flightrec``) is
    a merge SOURCE: for a pid that left no manifest (killed before its
    atexit flush) the flight doc stands in as
    its manifest; its metrics snapshot joins the merge when that pid
    wrote no ``metrics-<pid>.json``; and its event ring joins the record
    stream when that pid left no event shard at all. A pid that DID
    flush contributes nothing from its dump — the ring is a suffix of
    the shard, and double-merging would double-count."""
    records: List[dict] = []
    problems: List[str] = []
    manifests: List[dict] = []
    metrics: List[dict] = []
    flights: List[dict] = []
    shard_paths = sorted(glob.glob(os.path.join(telemetry_dir, SHARD_GLOB)))
    for path in shard_paths:
        name = os.path.basename(path)
        with open(path) as f:
            for i, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as exc:
                    problems.append(f"{name}:{i}: not JSON ({exc})")
                    continue
                for p in validate_record(rec):
                    problems.append(f"{name}:{i}: {p}")
                rec["_shard"] = name
                records.append(rec)
    for path in sorted(glob.glob(os.path.join(telemetry_dir, MANIFEST_GLOB))):
        try:
            with open(path) as f:
                manifests.append(json.load(f))
        except (OSError, json.JSONDecodeError) as exc:
            problems.append(f"{os.path.basename(path)}: unreadable ({exc})")
    for path in sorted(glob.glob(os.path.join(telemetry_dir, METRICS_GLOB))):
        try:
            with open(path) as f:
                metrics.append(
                    {"file": os.path.basename(path), "snapshot": json.load(f)}
                )
        except (OSError, json.JSONDecodeError) as exc:
            problems.append(f"{os.path.basename(path)}: unreadable ({exc})")
    shard_pids = {rec.get("pid") for rec in records}
    manifest_pids = {m.get("pid") for m in manifests}
    metrics_pids = set()
    for m in metrics:
        stem = m["file"][len("metrics-"):-len(".json")]
        if stem.isdigit():
            metrics_pids.add(int(stem))
    for path in sorted(glob.glob(os.path.join(telemetry_dir, FLIGHT_GLOB))):
        name = os.path.basename(path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            problems.append(f"{name}: unreadable ({exc})")
            continue
        if not isinstance(doc, dict) or doc.get("kind") != "tpuml-flight":
            problems.append(f"{name}: not a flight-recorder dump")
            continue
        flights.append({"file": name, "doc": doc})
        pid = doc.get("pid")
        if pid not in shard_pids:
            for i, rec in enumerate(doc.get("ring") or [], start=1):
                if not isinstance(rec, dict):
                    problems.append(f"{name}:ring[{i}]: not an object")
                    continue
                for p in validate_record(rec):
                    problems.append(f"{name}:ring[{i}]: {p}")
                rec = dict(rec)
                rec["_shard"] = name
                records.append(rec)
        if pid not in manifest_pids:
            manifests.append(
                {
                    "pid": pid,
                    "process": doc.get("process"),
                    "shard": name,
                    "metrics": name if doc.get("metrics") else None,
                    "costs": None,
                    "ops_port": None,
                    "trace_roots": doc.get("trace_roots", []),
                    "emitted": doc.get("emitted"),
                    "ts": doc.get("ts"),
                    "mono": doc.get("mono"),
                    "flight": doc.get("reason", True),
                }
            )
        if doc.get("metrics") and pid not in metrics_pids:
            metrics.append({"file": name, "snapshot": doc["metrics"]})
    if not shard_paths and not flights:
        problems.append(f"no {SHARD_GLOB} shards under {telemetry_dir}")
    return {
        "records": records,
        "manifests": manifests,
        "metrics": metrics,
        "flights": flights,
        "problems": problems,
    }


def align_records(records: List[dict]) -> None:
    """Annotate every record with mono-clock-aligned wall times (in
    place): ``_t`` (event instant), and for spans ``_start``/``_end``.

    Each process's offset is the median of its records' (ts − mono)
    pairs — median, because a single stalled write (GC pause between the
    two clock reads) must not skew the whole shard."""
    offsets: Dict[Any, float] = {}
    by_pid: Dict[Any, List[float]] = {}
    for rec in records:
        ts, mono = rec.get("ts"), rec.get("mono")
        if isinstance(ts, (int, float)) and isinstance(mono, (int, float)):
            by_pid.setdefault(rec.get("pid"), []).append(ts - mono)
    for pid, deltas in by_pid.items():
        offsets[pid] = statistics.median(deltas)
    for rec in records:
        off = offsets.get(rec.get("pid"))
        mono = rec.get("mono")
        if off is None or not isinstance(mono, (int, float)):
            continue
        t = mono + off
        rec["_t"] = t
        if rec.get("event") == "span" and isinstance(
            rec.get("dur"), (int, float)
        ):
            # The span record is emitted at exit: the emit-time monotonic
            # stamp IS (to within emit overhead) the span end.
            rec["_end"] = t
            rec["_start"] = t - rec["dur"]


def build_traces(records: List[dict]) -> Dict[Any, dict]:
    """Group records into traces and resolve span parentage across
    shards. Each trace cell carries ``spans`` / ``events`` / ``roots`` /
    ``orphans`` / ``children`` (parent id → child spans) plus the
    process and pid sets the trace touched. The ``None`` key collects
    untraced records (pre-trace bootstrap like ``shard_open``)."""
    traces: Dict[Any, dict] = {}
    span_ids = {
        rec.get("span") for rec in records if rec.get("event") == "span"
    }
    for rec in records:
        tid = rec.get("trace")
        cell = traces.setdefault(
            tid,
            {
                "trace_id": tid,
                "spans": [],
                "events": [],
                "roots": [],
                "orphans": [],
                "children": {},
                "processes": set(),
                "pids": set(),
            },
        )
        cell["processes"].add(rec.get("process"))
        cell["pids"].add(rec.get("pid"))
        if rec.get("event") == "span":
            cell["spans"].append(rec)
            parent = rec.get("parent")
            if parent is None:
                cell["roots"].append(rec)
            elif parent in span_ids:
                cell["children"].setdefault(parent, []).append(rec)
            else:
                cell["orphans"].append(rec)
        else:
            cell["events"].append(rec)
    return traces


def critical_path(cell: dict) -> List[dict]:
    """The chain of spans that determined this trace's completion: from
    the LAST-ending span up through its parents to a root, oldest first.
    Needs :func:`align_records` annotations; falls back to raw ``mono``
    where alignment was impossible."""
    spans = cell["spans"]
    if not spans:
        return []
    by_id = {s.get("span"): s for s in spans}

    def end_of(s: dict) -> float:
        return s.get("_end", s.get("mono", 0.0))

    node = max(spans, key=end_of)
    path, seen = [], set()
    while node is not None and node.get("span") not in seen:
        seen.add(node.get("span"))
        path.append(node)
        node = by_id.get(node.get("parent"))
    path.reverse()
    return [
        {
            "name": s.get("name"),
            "span": s.get("span"),
            "process": s.get("process"),
            "pid": s.get("pid"),
            "dur": s.get("dur"),
            "start": s.get("_start"),
            "end": s.get("_end"),
        }
        for s in path
    ]


def chrome_trace(records: List[dict]) -> dict:
    """Chrome trace-event JSON (load at ``ui.perfetto.dev`` or
    ``chrome://tracing``): spans as complete (``X``) events on their
    process/thread rows, other records as thread instants, plus process
    metadata rows naming each gang member."""
    events: List[dict] = []
    named = set()
    for rec in records:
        pid = rec.get("pid", 0)
        if pid not in named:
            named.add(pid)
            events.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": pid,
                    "args": {
                        "name": f"process {rec.get('process', '?')} (pid {pid})"
                    },
                }
            )
        if rec.get("event") == "span" and "_start" in rec:
            events.append(
                {
                    "ph": "X",
                    "name": rec.get("name", "?"),
                    "cat": "span",
                    "ts": rec["_start"] * 1e6,
                    "dur": max(rec.get("dur", 0.0), 0.0) * 1e6,
                    "pid": pid,
                    "tid": rec.get("thread", 0),
                    "args": {
                        "trace": rec.get("trace"),
                        "span": rec.get("span"),
                        "parent": rec.get("parent"),
                        "run_id": rec.get("run_id"),
                        "ok": rec.get("ok"),
                        "exc": rec.get("exc"),
                    },
                }
            )
        elif "_t" in rec:
            label = rec.get("event", "?")
            if rec.get("action"):
                label = f"{label}:{rec['action']}"
            events.append(
                {
                    "ph": "i",
                    "name": label,
                    "cat": rec.get("event", "?"),
                    "ts": rec["_t"] * 1e6,
                    "pid": pid,
                    "tid": rec.get("thread", 0),
                    "s": "p",
                    "args": {
                        "trace": rec.get("trace"),
                        "run_id": rec.get("run_id"),
                    },
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_metrics(snapshots: List[dict]) -> dict:
    """Fold per-member registry snapshots into one gang-wide view:
    counters sum, histograms merge bucket-wise, gauges take the max
    (each member's own value remains in the per-member section)."""
    merged: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        for name, v in snap.get("counters", {}).items():
            if isinstance(v, (int, float)):
                merged["counters"][name] = merged["counters"].get(name, 0) + v
        for name, v in snap.get("gauges", {}).items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            if fv != fv:  # NaN (a dead callable at snapshot time)
                continue
            cur = merged["gauges"].get(name)
            if cur is None or fv > cur:
                merged["gauges"][name] = fv
        for name, series in snap.get("histograms", {}).items():
            dst = merged["histograms"].setdefault(name, {})
            for sname, cell in series.items():
                d = dst.get(sname)
                if d is None:
                    dst[sname] = {
                        "buckets": dict(cell.get("buckets", {})),
                        "sum": cell.get("sum", 0.0),
                        "count": cell.get("count", 0),
                    }
                else:
                    for le, c in cell.get("buckets", {}).items():
                        d["buckets"][le] = d["buckets"].get(le, 0) + c
                    d["sum"] += cell.get("sum", 0.0)
                    d["count"] += cell.get("count", 0)
    return merged


def _trace_summary(cell: dict) -> dict:
    return {
        "trace_id": cell["trace_id"],
        "spans": len(cell["spans"]),
        "events": len(cell["events"]),
        "roots": len(cell["roots"]),
        "orphans": [s.get("span") for s in cell["orphans"]],
        "processes": sorted(
            p for p in cell["processes"] if p is not None
        ),
        "pids": sorted(p for p in cell["pids"] if p is not None),
        "critical_path": critical_path(cell),
    }


def assemble(telemetry_dir: str) -> dict:
    """One merged view of a telemetry dir: aligned records, per-trace
    trees + critical paths, merged metrics, and two problem lists —
    ``problems`` (malformed shards/records: the ``--validate`` gate) and
    ``orphan_problems`` (spans whose parent is in no shard: the strict
    cross-process-join oracle, separate because a PARTIAL collection —
    say one process's shard shipped without its launcher's — is a
    legitimate thing to render, just not a complete trace) — plus
    ``warnings`` for shards with no manifest: a hard-killed member
    (preemption, chaos ``os._exit``) never runs its atexit flush, and
    its shard is exactly the evidence a post-mortem needs, so the merge
    must report it without rejecting it."""
    bundle = read_shards(telemetry_dir)
    records = bundle["records"]
    align_records(records)
    traces = build_traces(records)
    orphan_problems = [
        f"trace {tid}: span {s.get('span')!r} ({s.get('name')!r}) has "
        f"unresolvable parent {s.get('parent')!r}"
        for tid, cell in traces.items()
        if tid is not None
        for s in cell["orphans"]
    ]
    manifest_pids = {m.get("pid") for m in bundle["manifests"]}
    shard_pids = {rec.get("pid") for rec in records}
    missing = sorted(
        str(p) for p in (shard_pids - manifest_pids) if p is not None
    )
    warnings = []
    if bundle["manifests"] and missing:
        warnings.append(
            "shards without a manifest (process killed before its atexit "
            f"flush, or flush_telemetry never ran): pids {', '.join(missing)}"
        )
    return {
        "dir": telemetry_dir,
        "records": records,
        "record_count": len(records),
        "manifests": bundle["manifests"],
        "flights": [f["file"] for f in bundle["flights"]],
        "traces": {
            tid: _trace_summary(cell)
            for tid, cell in traces.items()
            if tid is not None
        },
        "trace_cells": traces,
        "metrics": {
            "members": bundle["metrics"],
            "merged": merge_metrics(
                [m["snapshot"] for m in bundle["metrics"]]
            ),
        },
        "problems": list(bundle["problems"]),
        "warnings": warnings,
        "orphan_problems": orphan_problems,
    }
