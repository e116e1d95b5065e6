"""Program cost ledger — port of the reference's ``observability/costs.py``.

Every program chokepoint reports the program it just built: the captured
serving graphs of ``core/serving.py`` (one ``torch.cuda.CUDAGraph`` per
row bucket; off CUDA the eager kernel on the padded bucket), its eager
run above the capture bound (``serving.cache.bypass``, recorded as a
``fallback``), and the segmented solver drivers in ``ops/``. Each entry
then accumulates run-time truth — invocations, wall seconds, rows served —
so reports render a roofline view per program: arithmetic intensity from
the counted work, achieved FLOP/s from the wall, and utilization against
the ``TPUML_PEAK_FLOPS`` / ``TPUML_PEAK_BYTES_PER_SEC`` ceilings when the
operator declares them.

Where each field comes from (the port compiles no XLA, so no
``cost_analysis()`` / ``memory_analysis()`` exists to read):

  - ``flops``, ``transcendentals``, ``bytes_accessed``: an analytic count
    of the program's work at its shapes, never of the code that does it.
    Serving kernels register a count with :func:`register_cost` (the
    hand-written kernels' own ``cost`` functions in ``ops/kernels`` and
    2·m·k·n for a GEMM; a fused pipeline sums its stages); a segment
    passes one to :func:`ledgered_call`. **A segment's entry counts ONE
    solver iteration** (one Lloyd step, one FISTA step, one L-BFGS
    evaluation, one layout epoch) at its shapes, however many iterations
    the segment ran. A program with no count lists ``"cost_analysis"``
    in ``unavailable``; it never carries a guess.
  - ``argument_bytes`` / ``output_bytes``: the bytes of the program's
    input and output tensors. ``temp_bytes``: on CUDA, the growth of
    ``torch.cuda.max_memory_allocated`` across the capture, less the
    static input and outputs — what the graph's private pool holds
    beyond them (the device's allocator peak is reset for that window).
    Off CUDA, and for segments and fallbacks, it is unknown:
    ``"memory_analysis"`` is listed in ``unavailable``.
    ``alias_bytes`` / ``generated_code_bytes`` are always None.
  - ``compiles`` / ``compile_seconds``: a graph capture is a compile, its
    host time (warm-up call included) the compile seconds; an eager
    segment's or fallback's first sight counts one compile of 0.0 s.
  - ``wall_seconds``: on CUDA, device time from a pair of
    ``torch.cuda.Event`` recorded on the program's stream around each
    invocation (a small reused pool of pairs). Pending pairs resolve by
    ``query()`` on later invocations, and with one synchronize only in
    :func:`ledger_snapshot`, :func:`dump_ledger`, :func:`run_delta` and
    ``events.flush_telemetry``: the serving and fit paths never
    synchronize for the ledger, and no event is recorded while a capture
    is in progress. An invocation counts, and feeds the autotuner's wall
    samples, when its pair resolves. Off CUDA it is host
    ``perf_counter`` time, as in the reference.

On top of the ledger, as in the reference: the **retrace watchdog**
(:meth:`Ledger.classify`; ``compile.<class>`` counters and one
:class:`RetraceStormWarning` at ``TPUML_RETRACE_STORM`` retraces per
family), the **HBM sampler** (:class:`HbmSampler`,
``TPUML_HBM_SAMPLE_EVERY_MS``, over ``torch.cuda.memory_allocated`` /
``max_memory_allocated`` of the CUDA devices this process holds memory
on), and **measured admission pricing** (:func:`measured_request_bytes`).

Everything is OFF by default: with ``TPUML_COST_LEDGER`` unset,
:func:`active` is one module-global ``None`` check and the chokepoints
allocate nothing. The document's schema is the reference's
(:data:`LEDGER_VERSION`, :data:`ENTRY_FIELDS`, :func:`ledger_key`, specs
rendered with numpy dtype names), so either package's
:func:`validate_ledger`, :func:`merge_ledger_docs`, :func:`family_rollup`
and ``tools/tpuml_prof.py`` read the other's documents. Shards ride
``TPUML_TELEMETRY_DIR`` (``costs-<pid>.json``); ``TPUML_COST_LEDGER_DUMP``
writes the snapshot at interpreter exit.
"""

from __future__ import annotations

import atexit
import json
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.observability.metrics import default_registry, gauge
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice, env_float, env_int, env_str
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock

COST_LEDGER_ENV = "TPUML_COST_LEDGER"
COST_DUMP_ENV = "TPUML_COST_LEDGER_DUMP"
HBM_SAMPLE_ENV = "TPUML_HBM_SAMPLE_EVERY_MS"
RETRACE_STORM_ENV = "TPUML_RETRACE_STORM"
PEAK_FLOPS_ENV = "TPUML_PEAK_FLOPS"
PEAK_BYTES_ENV = "TPUML_PEAK_BYTES_PER_SEC"

#: Ledger document schema version (the reference's).
LEDGER_VERSION = 1

#: Default retraces per program family before the storm warning fires.
DEFAULT_RETRACE_STORM = 3

#: Program kinds the chokepoints report.
KIND_AOT = "aot"            # a bucketed serving program (core/serving)
KIND_FALLBACK = "fallback"  # an eager run above the capture bound
KIND_SEGMENT = "segment"    # a segmented solver program (ops/ drivers)


class RetraceStormWarning(UserWarning):
    """One program family keeps recompiling for shapes its existing
    buckets already cover — the shape-bucketing contract is being
    bypassed and compiles are eating the run."""


#: Installed by observability.autotune: extra row counts that ARE
#: legitimate buckets (the learned exact-fit ladder rungs). None = off.
_ROW_BUCKET_PROBE: Optional[Callable[[int], bool]] = None

#: Installed by observability.autotune: called (family, rows, seconds)
#: when an invocation's wall is known — the tuner's wall-sample feed.
_INVOCATION_OBSERVER: Optional[Callable[[str, int, float], None]] = None


def set_row_bucket_probe(probe: Optional[Callable[[int], bool]]) -> None:
    global _ROW_BUCKET_PROBE
    _ROW_BUCKET_PROBE = probe


def set_invocation_observer(observer: Optional[Callable[[str, int, float], None]]) -> None:
    global _INVOCATION_OBSERVER
    _INVOCATION_OBSERVER = observer


def _is_row_bucket(rows: int) -> bool:
    """Whether ``rows`` is a value ``core.serving.bucket_rows`` can return
    (a power of two >= the minimum bucket), or a learned ladder rung."""
    if rows >= 8 and (rows & (rows - 1)) == 0:
        return True
    probe = _ROW_BUCKET_PROBE
    return probe is not None and bool(probe(rows))


# ---------------------------------------------------------------------------
# analytic counts
# ---------------------------------------------------------------------------

#: ``cost_fn(rows, d, dtype, weights, static) -> {"flops",
#: "transcendentals", "bytes_accessed"[, "out_width"]}`` by serving kernel.
_KERNEL_COSTS: Dict[Callable, Callable] = {}


def register_cost(kernel: Callable, cost_fn: Callable) -> Callable:
    """Register the analytic count of a serving kernel's work; returns
    ``kernel``. ``out_width`` in the count is the width of a 2-D output a
    fused successor reads."""
    _KERNEL_COSTS[kernel] = cost_fn
    return kernel


def kernel_cost(kernel: Callable, rows: int, d: int, dtype: Any, weights: tuple,
                static: dict) -> Optional[dict]:
    """The registered count of ``kernel`` at ``rows`` × ``d`` in ``dtype``
    with these weights and static config, or None when it has none."""
    cost_fn = _KERNEL_COSTS.get(kernel)
    if cost_fn is None:
        return None
    return cost_fn(int(rows), int(d), dtype, weights, static)


def itemsize(dtype: Any) -> int:
    """Bytes per element of a torch or numpy dtype."""
    import torch

    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def gemm_cost(m: int, k: int, n: int, item: int) -> dict:
    """A plain (m, k) · (k, n) product: 2·m·k·n operations, both operands
    read once and the product written once."""
    return {"flops": 2.0 * m * k * n, "transcendentals": 0.0,
            "bytes_accessed": float((m * k + k * n + m * n) * item)}


def sum_costs(parts: List[Optional[dict]]) -> Optional[dict]:
    """Stage counts summed (None if any stage has none)."""
    if not parts or any(p is None for p in parts):
        return None
    return {f: float(sum(p.get(f, 0.0) for p in parts))
            for f in ("flops", "transcendentals", "bytes_accessed")}


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


@dataclass
class ProgramCost:
    """One program's counted cost + cumulative run counters."""

    key: str
    family: str        # serving name / solver name ("kmeans.predict")
    kind: str          # KIND_AOT | KIND_FALLBACK | KIND_SEGMENT
    static: str        # rendered static config
    spec: str          # rendered input spec ("128x16:float32")
    rows: Optional[int]
    classification: str  # the watchdog's verdict for the FIRST compile
    flops: Optional[float] = None
    transcendentals: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    #: Which of the two the port could not provide ("cost_analysis": no
    #: registered count; "memory_analysis": no measured temp bytes).
    unavailable: List[str] = field(default_factory=list)
    compiles: int = 0
    compile_seconds: float = 0.0
    invocations: int = 0
    wall_seconds: float = 0.0
    rows_served: int = 0

    def measured_request_bytes(self) -> Optional[int]:
        """temp + output bytes — what one execution allocates beyond its
        resident inputs."""
        if self.temp_bytes is None or self.output_bytes is None:
            return None
        return int(self.temp_bytes) + int(self.output_bytes)

    def to_json(self) -> dict:
        return {
            "key": self.key,
            "family": self.family,
            "kind": self.kind,
            "static": self.static,
            "spec": self.spec,
            "rows": self.rows,
            "classification": self.classification,
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "unavailable": list(self.unavailable),
            "compiles": self.compiles,
            "compile_seconds": self.compile_seconds,
            "invocations": self.invocations,
            "wall_seconds": self.wall_seconds,
            "rows_served": self.rows_served,
        }


#: Fields every serialized ledger entry must carry (the reference's).
ENTRY_FIELDS = frozenset(
    {
        "key", "family", "kind", "static", "spec", "rows", "classification",
        "flops", "bytes_accessed", "unavailable", "compiles",
        "compile_seconds", "invocations", "wall_seconds",
    }
)

_MEMORY_FIELDS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "generated_code_bytes")


class Ledger:
    """The per-process cost ledger: programs by stable key, watermarks,
    retrace families, under one lock."""

    def __init__(self):
        self._lock = make_lock("costs.ledger")
        self._entries: Dict[str, ProgramCost] = {}  # guarded-by: _lock
        # (fn id, static, rows, d, dtype, args key) -> entry key: the
        # admission controller's measured-pricing index.
        self._request_index: Dict[tuple, str] = {}  # guarded-by: _lock
        # (family identity minus rows) -> {"rows": set, "retraces": n}
        self._families: Dict[tuple, dict] = {}  # guarded-by: _lock
        self._watermarks: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock
        self._retraces = 0  # guarded-by: _lock

    # --- recording -----------------------------------------------------

    def record(
        self,
        key: str,
        *,
        family: str,
        kind: str,
        static: str,
        spec: str,
        rows: Optional[int],
        classification: str,
        cost: Optional[dict] = None,
        memory: Optional[dict] = None,
        compile_seconds: float = 0.0,
        index_key: Optional[tuple] = None,
    ) -> str:
        """Upsert one program: the counted work ``cost`` (None: no count)
        and the ``memory`` fields known for it (a temp of None marks
        ``memory_analysis`` unavailable). Idempotent per key — a
        recompile bumps ``compiles`` on the same entry."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = ProgramCost(key=key, family=family, kind=kind, static=static,
                                    spec=spec, rows=rows, classification=classification)
                self._entries[key] = entry
            entry.compiles += 1
            entry.compile_seconds += float(compile_seconds)
            if cost is not None:
                entry.flops = float(cost.get("flops", 0.0))
                entry.transcendentals = float(cost.get("transcendentals", 0.0))
                entry.bytes_accessed = float(cost.get("bytes_accessed", 0.0))
            elif "cost_analysis" not in entry.unavailable:
                entry.unavailable.append("cost_analysis")
            for f, v in (memory or {}).items():
                if v is not None:
                    setattr(entry, f, int(v))
            if entry.temp_bytes is None and "memory_analysis" not in entry.unavailable:
                entry.unavailable.append("memory_analysis")
            if index_key is not None and entry.measured_request_bytes() is not None:
                self._request_index[index_key] = key
        return key

    def note_invocation(self, key: str, seconds: float, rows: int = 0) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            entry.invocations += 1
            entry.wall_seconds += float(seconds)
            entry.rows_served += int(rows)
            family = entry.family
        # Outside self._lock: the observer (the autotuner) takes its own.
        observer = _INVOCATION_OBSERVER
        if observer is not None:
            observer(family, int(rows), float(seconds))

    # --- the retrace watchdog ------------------------------------------

    def classify(self, family_key: tuple, family_name: str, rows: Optional[int], *,
                 evicted: bool, bucketed: bool) -> str:
        """Classify one compile event and run the storm watchdog.

        ``family_key`` is the program identity MINUS the row count;
        ``bucketed`` says whether this kind takes part in the row-bucket
        contract (serving programs do; segments and fallbacks build one
        program per shape)."""
        storm = env_int(RETRACE_STORM_ENV, DEFAULT_RETRACE_STORM, minimum=1)
        with self._lock:
            fam = self._families.get(family_key)
            if fam is None:
                fam = self._families[family_key] = {"rows": set(), "retraces": 0}
                cls = "new_program"
            elif evicted:
                cls = "eviction_refill"
            elif bucketed and rows is not None and (rows in fam["rows"] or not _is_row_bucket(rows)):
                # This bucket compiled before (and was not evicted), or
                # the row count is no bucket at all: bucketing bypassed.
                cls = "retrace"
                fam["retraces"] += 1
                self._retraces += 1
            else:
                cls = "new_bucket" if bucketed else "new_program"
            if rows is not None:
                fam["rows"].add(rows)
            retraces = fam["retraces"]
        default_registry.counter(f"compile.{cls}").inc()
        emit("compile", classification=cls, kernel=family_name, rows=rows)
        if cls == "retrace" and retraces == storm:
            warnings.warn(
                RetraceStormWarning(
                    f"program family {family_name!r} has recompiled "
                    f"{retraces} times for shapes inside its existing row "
                    f"buckets — shape bucketing is being bypassed "
                    f"({RETRACE_STORM_ENV}={storm})"
                ),
                stacklevel=3,
            )
        return cls

    def reset_families(self) -> None:
        """Forget the watchdog's family history (a program-cache reset is
        a reconfiguration boundary: its refills are not retraces)."""
        with self._lock:
            self._families.clear()

    # --- watermarks ----------------------------------------------------

    def observe_watermark(self, device: str, in_use: int, peak: int) -> None:
        with self._lock:
            cell = self._watermarks.setdefault(device, {"in_use": 0, "peak_bytes": 0})
            cell["in_use"] = max(cell["in_use"], int(in_use))
            cell["peak_bytes"] = max(cell["peak_bytes"], int(peak))

    # --- views ---------------------------------------------------------

    def measured_bytes(self, index_key: tuple) -> Optional[int]:
        with self._lock:
            key = self._request_index.get(index_key)
            entry = self._entries.get(key) if key is not None else None
        return entry.measured_request_bytes() if entry is not None else None

    def entries(self) -> List[ProgramCost]:
        with self._lock:
            return list(self._entries.values())

    def invocation_snapshot(self) -> Dict[str, Tuple[int, float, int]]:
        """{key: (invocations, wall_seconds, rows_served)} — the marks a
        RunRecorder diffs to attribute ledger traffic to one run."""
        with self._lock:
            return {k: (e.invocations, e.wall_seconds, e.rows_served) for k, e in self._entries.items()}

    def snapshot(self) -> dict:
        import os

        with self._lock:
            entries = [e.to_json() for e in self._entries.values()]
            watermarks = {k: dict(v) for k, v in self._watermarks.items()}
            families: Dict[str, int] = {}
            for fkey, fam in self._families.items():
                if fam["retraces"]:
                    name = str(fkey[-1])  # family keys end with the name
                    families[name] = families.get(name, 0) + fam["retraces"]
            retraces = {"total": self._retraces, "families": families}
        return {
            "version": LEDGER_VERSION,
            "ts": time.time(),
            "pid": os.getpid(),
            "entries": entries,
            "watermarks": watermarks,
            "retraces": retraces,
            "peaks": device_peaks(),
            "precision_modes": _precision_modes(),
        }


# ---------------------------------------------------------------------------
# module state: the one-None-check discipline
# ---------------------------------------------------------------------------

_LEDGER: Optional[Ledger] = None  # None = disabled: active() is one read
_SAMPLER: Optional["HbmSampler"] = None
_config_lock = make_lock("costs.config")


def active() -> Optional[Ledger]:
    """The live ledger, or None when ``TPUML_COST_LEDGER`` is off — the
    single check every chokepoint makes before touching anything."""
    return _LEDGER


def configure(enable: Optional[bool] = None) -> Optional[Ledger]:
    """(Re)wire the ledger from ``TPUML_COST_LEDGER`` (or an explicit
    ``enable``), and start/stop the HBM sampler per
    ``TPUML_HBM_SAMPLE_EVERY_MS``. Idempotent; enabling twice keeps the
    existing ledger."""
    global _LEDGER, _SAMPLER
    with _config_lock:
        if enable is None:
            enable = env_choice(COST_LEDGER_ENV, ("0", "1"), "0") == "1"
        if enable:
            if _LEDGER is None:
                _LEDGER = Ledger()
        else:
            _LEDGER = None
        period = env_float(HBM_SAMPLE_ENV, 0.0, minimum=0.0)
        if _LEDGER is not None and period and period > 0:
            if _SAMPLER is None or not _SAMPLER.alive():
                _SAMPLER = HbmSampler(period_ms=period)
                _SAMPLER.start()
        elif _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None
        return _LEDGER


def reset_for_tests() -> None:
    """Drop the ledger, the sampler, the pending event pairs and the
    chokepoints' key caches, then re-read the knobs (test isolation)."""
    global _LEDGER, _SAMPLER
    with _config_lock:
        if _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None
        _LEDGER = None
    _TIMER.clear()
    with _keys_lock:
        _FALLBACK_KEYS.clear()
        _SEGMENT_KEYS.clear()
    configure()


# ---------------------------------------------------------------------------
# keys — stable across processes so gang shards merge
# ---------------------------------------------------------------------------


def _fn_name(fn: Callable) -> str:
    return f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"


def dtype_name(dtype: Any) -> str:
    """A torch or numpy dtype under its numpy name (``float32``)."""
    import torch

    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _render(value: Any) -> str:
    """One static value, stable across processes: callables by name,
    dtypes by their numpy names."""
    import torch

    if isinstance(value, torch.dtype):
        return repr(dtype_name(value))
    if callable(value) and not isinstance(value, type):
        return _fn_name(value)
    return repr(value)


def _static_repr(static: dict) -> str:
    return ",".join(f"{k}={_render(v)}" for k, v in sorted(static.items()))


def _flatten(tree: Any) -> Tuple[str, List[Any]]:
    """(structure string, leaves) of a tuple/list/dict/named-tuple tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [_flatten(item) for item in tree]
        return (f"{type(tree).__name__}({','.join(p[0] for p in parts)})",
                [leaf for p in parts for leaf in p[1]])
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(item) for item in tree]
        open_, close = ("(", ")") if isinstance(tree, tuple) else ("[", "]")
        return open_ + ",".join(p[0] for p in parts) + close, [leaf for p in parts for leaf in p[1]]
    if isinstance(tree, dict):
        parts = [(k, _flatten(tree[k])) for k in sorted(tree)]
        return ("{" + ",".join(f"{k}:{p[0]}" for k, p in parts) + "}",
                [leaf for _, p in parts for leaf in p[1]])
    return "*", [tree]


def _leaf_aval(leaf: Any) -> tuple:
    import torch

    if isinstance(leaf, torch.Tensor):
        return (tuple(int(s) for s in leaf.shape), dtype_name(leaf.dtype))
    if isinstance(leaf, np.ndarray):
        return (tuple(int(s) for s in leaf.shape), str(leaf.dtype))
    if isinstance(leaf, np.generic):
        return ((), str(leaf.dtype))
    return ((), type(leaf).__name__)


def args_aval_key(args: tuple) -> tuple:
    """Hashable (structure, leaf shapes and dtypes) identity of an
    argument tree of tensors, arrays and scalars."""
    structure, leaves = _flatten(args)
    return (structure, tuple(_leaf_aval(leaf) for leaf in leaves))


def _avals_render(avals: tuple) -> str:
    return ";".join("x".join(str(s) for s in shape) + f":{dt}" for shape, dt in avals[1])


def ledger_key(name: str, kind: str, static: str, spec: str, args_key: tuple) -> str:
    """Deterministic entry key: human prefix + stable digest of the full
    identity (the same program in two gang members = the same key)."""
    import hashlib

    ident = f"{name}|{kind}|{static}|{spec}|{args_key!r}"
    digest = hashlib.sha1(ident.encode()).hexdigest()[:10]
    return f"{name}|{kind}|{spec}|{digest}"


def tensor_bytes(tree: Any) -> int:
    """Bytes of the tensors of an argument tree."""
    import torch

    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in _flatten(tree)[1] if isinstance(leaf, torch.Tensor)))


def _first_rows(args: tuple) -> Optional[int]:
    for leaf in _flatten(args)[1]:
        shape = np.shape(leaf) if not hasattr(leaf, "shape") else tuple(leaf.shape)
        if len(shape):
            return int(shape[0])
    return None


# ---------------------------------------------------------------------------
# device-time walls: CUDA event pairs, resolved without a synchronize
# ---------------------------------------------------------------------------


class _DeviceTimer:
    """Pending (start, end, key, rows) event pairs in launch order, and a
    pool of spare pairs per device. :meth:`poll` resolves the pairs whose
    end has fired (``query()``, no synchronize); :meth:`drain` waits for
    them all. At :data:`CAPACITY` pending pairs a new invocation runs
    untimed (counter ``costs.untimed``) rather than wait."""

    CAPACITY = 1024

    def __init__(self):
        self._lock = make_lock("costs.device_timer")
        self._pending: "deque[tuple]" = deque()  # guarded-by: _lock
        self._spare: Dict[int, List[tuple]] = {}  # guarded-by: _lock

    def begin(self, stream) -> Optional[tuple]:
        """A (start, end) pair with start recorded on ``stream``, or None
        (ring full, or the stream is capturing)."""
        import torch

        if torch.cuda.is_current_stream_capturing():
            return None
        index = stream.device.index
        with self._lock:
            if len(self._pending) >= self.CAPACITY:
                pair = None
            else:
                spare = self._spare.get(index)
                pair = spare.pop() if spare else ()
        if pair is None:
            default_registry.counter("costs.untimed").inc()
            return None
        if not pair:
            with torch.cuda.device(stream.device):
                pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record(stream)
        return pair

    def end(self, pair: tuple, stream, key: str, rows: int) -> None:
        pair[1].record(stream)
        with self._lock:
            self._pending.append((pair, key, int(rows), stream.device.index))
        self.poll()

    def _take_ready(self, wait: bool) -> List[tuple]:
        done = []
        with self._lock:
            while self._pending:
                pair, key, rows, index = self._pending[0]
                if not wait and not pair[1].query():
                    break
                self._pending.popleft()
                if wait:
                    pair[1].synchronize()
                seconds = pair[0].elapsed_time(pair[1]) / 1e3
                self._spare.setdefault(index, []).append(pair)
                done.append((key, seconds, rows))
        return done

    def poll(self, wait: bool = False) -> None:
        """Resolve the ready pairs (all of them with ``wait``) into the
        ledger, outside the lock."""
        done = self._take_ready(wait)
        led = _LEDGER
        if led is not None:
            for key, seconds, rows in done:
                led.note_invocation(key, seconds, rows)

    def drain(self) -> None:
        with self._lock:
            empty = not self._pending
        if not empty:
            self.poll(wait=True)

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._spare.clear()


_TIMER = _DeviceTimer()


def timed_invocation(led: Ledger, key: str, rows: int, device: Any, call: Callable[[], Any],
                     stream: Any = None) -> Any:
    """Run ``call`` as one invocation of ``key``: on a CUDA ``device``
    between an event pair on ``stream`` (default: the device's current
    stream), resolved later; elsewhere under ``perf_counter``."""
    if getattr(device, "type", None) == "cuda":
        import torch

        stream = stream if stream is not None else torch.cuda.current_stream(device)
        pair = _TIMER.begin(stream)
        out = call()
        if pair is not None:
            _TIMER.end(pair, stream, key, rows)
        return out
    t0 = time.perf_counter()
    out = call()
    led.note_invocation(key, time.perf_counter() - t0, rows=rows)
    return out


def resolve_walls() -> None:
    """Wait for every pending event pair and fold it into the ledger: the
    one synchronize of the ledger's views."""
    _TIMER.drain()


# ---------------------------------------------------------------------------
# chokepoint helpers
# ---------------------------------------------------------------------------


def record_aot(fn: Callable, *, name: str, static: dict, rows: int, d: int, dtype: Any, args: tuple,
               identity: Any, cost: Optional[dict], memory: Optional[dict], compile_seconds: float,
               evicted: bool) -> str:
    """One bucketed serving program (core/serving._get_program): ``rows``
    is its bucket, ``identity`` the weights' identity (a graph binds its
    weights' addresses, so two models of one shape are two programs)."""
    led = _LEDGER
    if led is None:
        return ""
    dt = dtype_name(dtype)
    akey = args_aval_key(args)
    static_r = _static_repr(static)
    spec = f"{int(rows)}x{int(d)}:{dt}"
    family_key = (id(fn), static_r, int(d), dt, akey, identity, name)
    cls = led.classify(family_key, name, int(rows), evicted=evicted, bucketed=True)
    key = ledger_key(name, KIND_AOT, static_r, spec, akey)
    return led.record(
        key, family=name, kind=KIND_AOT, static=static_r, spec=spec, rows=int(rows),
        classification=cls, cost=cost, memory=memory, compile_seconds=compile_seconds,
        index_key=(id(fn), static_r, int(rows), int(d), dt, akey),
    )


#: (fn, static, aval key) -> ledger key of recorded fallbacks and segments:
#: one record per distinct shape.
_FALLBACK_KEYS: Dict[tuple, str] = {}  # guarded-by: _keys_lock
_SEGMENT_KEYS: Dict[tuple, str] = {}  # guarded-by: _keys_lock
_keys_lock = make_lock("costs.keys")


def _keys_of(kind: str) -> Dict[tuple, str]:
    """The key cache of ``kind`` (callers hold ``_keys_lock``)."""
    return _FALLBACK_KEYS if kind == KIND_FALLBACK else _SEGMENT_KEYS


def _record_once(kind: str, fn: Callable, name: str, static: dict, args: tuple,
                 cost: Optional[Callable[[], Optional[dict]]]) -> str:
    led = _LEDGER
    akey = args_aval_key(args)
    static_r = _static_repr(static)
    cache_key = (id(fn), static_r, akey)
    with _keys_lock:
        key = _keys_of(kind).get(cache_key)
    if key is not None:
        return key
    rows = _first_rows(args)
    spec = _avals_render(akey)
    family_key = (id(fn), static_r, akey, name) if kind == KIND_FALLBACK else (id(fn), static_r, name)
    cls = led.classify(family_key, name, rows, evicted=False, bucketed=False)
    key = ledger_key(name, kind, static_r, spec, akey)
    led.record(
        key, family=name, kind=kind, static=static_r, spec=spec, rows=rows, classification=cls,
        cost=cost() if cost is not None else None,
        memory={"argument_bytes": tensor_bytes(args)},
    )
    with _keys_lock:
        return _keys_of(kind).setdefault(cache_key, key)


def record_fallback(fn: Callable, *, name: str, static: dict, args: tuple,
                    cost: Optional[Callable[[], Optional[dict]]] = None) -> str:
    """One eager program above the capture bound: counted once per
    distinct shape (``cost`` is a thunk, called then); its memory is not
    measured."""
    if _LEDGER is None:
        return ""
    return _record_once(KIND_FALLBACK, fn, name, static, args, cost)


def _device_of(args: tuple) -> Any:
    import torch

    for leaf in _flatten(args)[1]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def ledgered_call(fn: Callable, args: tuple, *, static: dict, name: str,
                  cost: Optional[Callable[[], Optional[dict]]] = None):
    """Run a solver segment, ledgered.

    Disabled (the default): exactly ``fn(*args, **static)``. Enabled: the
    segment is recorded once per (fn, static, shapes) — first sight is one
    compile of 0.0 s, ``cost()`` its count of ONE iteration — and each
    call runs the same ``fn(*args, **static)`` between a pair of events
    (CUDA) or under ``perf_counter``: the same launches in the same
    order, bitwise the same outputs."""
    led = _LEDGER
    if led is None:
        return fn(*args, **static)
    key = _record_once(KIND_SEGMENT, fn, name, static, args, cost)
    return timed_invocation(led, key, 0, _device_of(args), lambda: fn(*args, **static))


def measured_request_bytes(fn: Callable, static: dict, rows: int, d: int, dtype: Any,
                           args: tuple) -> Optional[int]:
    """The ledgered ``temp + output`` bytes of the serving program for
    this (kernel, static, bucket, features, dtype, weight shapes) — or
    None before it was captured (or off CUDA), when admission keeps the
    declared-spec estimate."""
    led = _LEDGER
    if led is None:
        return None
    index_key = (id(fn), _static_repr(static), int(rows), int(d), dtype_name(dtype), args_aval_key(args))
    return led.measured_bytes(index_key)


# ---------------------------------------------------------------------------
# HBM watermark sampler
# ---------------------------------------------------------------------------


def _default_hbm_stats() -> Dict[str, Dict[str, int]]:
    """{device index: {"bytes_in_use", "peak_bytes_in_use"}} for the CUDA
    devices this process holds memory on ({} without CUDA). Reads the
    caching allocator's counters only: no device gets a context."""
    import torch

    out: Dict[str, Dict[str, int]] = {}
    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return out
        count = torch.cuda.device_count()
    except Exception:
        return out
    for i in range(count):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            continue
        if not stats.get("reserved_bytes.all.current", 0):
            continue
        out[str(i)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        }
    return out


class HbmSampler:
    """Opt-in daemon thread sampling device memory every ``period_ms``:
    publishes the ``device.memory.in_use`` / ``device.memory.peak_bytes``
    gauges, feeds the ledger watermarks, and keeps a bounded history of
    (perf_counter ts, in use, peak) for span attribution in fit reports.
    ``stats_fn`` is the test seam."""

    MAX_SAMPLES = 4096

    def __init__(self, period_ms: float,
                 stats_fn: Optional[Callable[[], Dict[str, Dict[str, int]]]] = None):
        self.period_s = max(float(period_ms), 1.0) / 1e3
        self.stats_fn = stats_fn or _default_hbm_stats
        self.samples: "deque[tuple]" = deque(maxlen=self.MAX_SAMPLES)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> Optional[tuple]:
        """Take one sample now (also the unit the thread loops on)."""
        try:
            stats = self.stats_fn()
        except Exception:
            return None
        if not stats:
            return None
        in_use = sum(s.get("bytes_in_use", 0) for s in stats.values())
        peak = sum(s.get("peak_bytes_in_use", 0) for s in stats.values())
        led = _LEDGER
        for dev, s in stats.items():
            gauge("device.memory.in_use", "sampled device bytes in use").set(s.get("bytes_in_use", 0), device=dev)
            gauge("device.memory.peak_bytes", "sampled device peak bytes").set(
                s.get("peak_bytes_in_use", 0), device=dev)
            if led is not None:
                led.observe_watermark(dev, s.get("bytes_in_use", 0), s.get("peak_bytes_in_use", 0))
        cell = (time.perf_counter(), in_use, peak)
        self.samples.append(cell)
        return cell

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample_once()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="tpuml-hbm-sampler", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def window(self, t0: float, t1: float) -> List[tuple]:
        """Samples with perf_counter timestamps inside [t0, t1]."""
        return [s for s in list(self.samples) if t0 <= s[0] <= t1]


def sampler() -> Optional[HbmSampler]:
    return _SAMPLER


def attribute_hbm_growth(samples: List[tuple], spans: List[dict]) -> dict:
    """Attribute peak-watermark growth between consecutive samples to the
    deepest span whose [start, end] covers the later sample. Returns
    {"peak_start", "peak_end", "delta", "by_span"} ({} with fewer than
    two samples)."""
    if len(samples) < 2:
        return {}
    by_span: Dict[str, int] = {}
    for (_, _, p_a), (t_b, _, p_b) in zip(samples, samples[1:]):
        delta = p_b - p_a
        if delta <= 0:
            continue
        best = None
        for s in spans:
            if s["start"] <= t_b <= s["end"]:
                if best is None or s["depth"] > best["depth"]:
                    best = s
        name = best["name"] if best is not None else "<unattributed>"
        by_span[name] = by_span.get(name, 0) + delta
    return {
        "peak_start": samples[0][2],
        "peak_end": samples[-1][2],
        "delta": samples[-1][2] - samples[0][2],
        "by_span": by_span,
    }


# ---------------------------------------------------------------------------
# roofline arithmetic + report rows
# ---------------------------------------------------------------------------


def _precision_modes() -> Dict[str, str]:
    from spark_rapids_ml_tpu_torch.ops.precision import active_modes

    return dict(sorted(active_modes().items()))


def device_peaks() -> Dict[str, Optional[float]]:
    """Operator-declared device ceilings (``TPUML_PEAK_FLOPS`` /
    ``TPUML_PEAK_BYTES_PER_SEC``; None = not declared)."""
    return {
        "flops_per_sec": env_float(PEAK_FLOPS_ENV),
        "bytes_per_sec": env_float(PEAK_BYTES_ENV),
    }


def roofline_row(entry_json: dict) -> dict:
    """One entry's achieved-vs-counted view: counted flops/bytes per
    invocation, achieved FLOP/s and bytes/s from the cumulative wall,
    arithmetic intensity, and utilization when the peaks are declared (the
    larger of the two fractions: the binding roof)."""
    from spark_rapids_ml_tpu_torch.ops.precision import active_mode, roofline_peak_scale

    inv = entry_json.get("invocations") or 0
    wall = entry_json.get("wall_seconds") or 0.0
    flops = entry_json.get("flops")
    byts = entry_json.get("bytes_accessed")
    out = {
        "key": entry_json.get("key"),
        "family": entry_json.get("family"),
        "kind": entry_json.get("kind"),
        "invocations": inv,
        "wall_seconds": wall,
        "flops": flops,
        "bytes_accessed": byts,
        "intensity": (flops / byts) if flops and byts else None,
        "achieved_flops_per_sec": None,
        "achieved_bytes_per_sec": None,
        "utilization": None,
    }
    if inv and wall > 0:
        if flops is not None:
            out["achieved_flops_per_sec"] = flops * inv / wall
        if byts is not None:
            out["achieved_bytes_per_sec"] = byts * inv / wall
    peaks = device_peaks()
    # The flops roof of the family's active precision mode: the declared
    # peak is one fp32 pass per product.
    scale = roofline_peak_scale(entry_json.get("family") or "")
    mode = active_mode(entry_json.get("family") or "")
    if mode is not None:
        out["precision_mode"] = mode
    bounds = []
    if peaks["flops_per_sec"] and out["achieved_flops_per_sec"] is not None:
        bounds.append(out["achieved_flops_per_sec"] / (peaks["flops_per_sec"] * scale))
    if peaks["bytes_per_sec"] and out["achieved_bytes_per_sec"] is not None:
        bounds.append(out["achieved_bytes_per_sec"] / peaks["bytes_per_sec"])
    if bounds:
        out["utilization"] = max(bounds)
    return out


def run_delta(base: Dict[str, Tuple[int, float, int]]) -> List[dict]:
    """Per-program ledger traffic SINCE ``base`` (an
    ``invocation_snapshot()`` taken at run start), each row a
    :func:`roofline_row` over the run's delta. Pending event pairs are
    resolved first. Programs untouched by the run are omitted; programs
    recorded during it appear even with no completed invocation."""
    led = _LEDGER
    if led is None:
        return []
    resolve_walls()
    rows: List[dict] = []
    for e in led.entries():
        inv0, wall0, rows0 = base.get(e.key, (0, 0.0, 0))
        d_inv = e.invocations - inv0
        if d_inv <= 0 and e.key in base:
            continue
        ej = e.to_json()
        ej["invocations"] = d_inv
        ej["wall_seconds"] = e.wall_seconds - wall0
        row = roofline_row(ej)
        row["rows_served"] = e.rows_served - rows0
        row["spec"] = ej["spec"]
        row["unavailable"] = ej["unavailable"]
        rows.append(row)
    rows.sort(key=lambda r: -(r.get("wall_seconds") or 0.0))
    return rows


# ---------------------------------------------------------------------------
# serialization, validation, merging
# ---------------------------------------------------------------------------


def ledger_snapshot() -> Optional[dict]:
    """The active ledger as a JSON-ready document (None when disabled),
    after resolving the pending event pairs."""
    led = _LEDGER
    if led is None:
        return None
    resolve_walls()
    return led.snapshot()


def dump_ledger(path: str) -> Optional[str]:
    """Write the active ledger document to ``path`` (None when the ledger
    is disabled — nothing is written)."""
    doc = ledger_snapshot()
    if doc is None:
        return None
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, default=str)
        f.write("\n")
    return path


def validate_ledger(doc: Any) -> List[str]:
    """Problems with one decoded ledger document (empty list = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"ledger is {type(doc).__name__}, not an object"]
    if doc.get("version") != LEDGER_VERSION:
        problems.append(f"version {doc.get('version')!r} != supported {LEDGER_VERSION}")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return problems + ["'entries' missing or not a list"]
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            problems.append(f"entry {i}: not an object")
            continue
        for f in ENTRY_FIELDS:
            if f not in e:
                problems.append(f"entry {i} ({e.get('key')}): missing {f!r}")
        if e.get("flops") is None and "cost_analysis" not in (e.get("unavailable") or []):
            problems.append(f"entry {i} ({e.get('key')}): no flops and no 'cost_analysis' unavailable marker")
        if e.get("temp_bytes") is None and "memory_analysis" not in (e.get("unavailable") or []):
            problems.append(
                f"entry {i} ({e.get('key')}): no memory fields and no 'memory_analysis' unavailable marker")
    if not isinstance(doc.get("watermarks", {}), dict):
        problems.append("'watermarks' is not an object")
    return problems


#: Entry fields summed across shards / processes at merge time.
_SUM_FIELDS = ("compiles", "compile_seconds", "invocations", "wall_seconds", "rows_served")


def merge_ledger_docs(docs: List[dict]) -> dict:
    """One cost view from N per-process ledger documents: entries join on
    their stable key (run counters SUM; counted fields agree and the first
    non-None wins), watermarks take the per-device MAX, retraces sum."""
    entries: Dict[str, dict] = {}
    watermarks: Dict[str, Dict[str, int]] = {}
    retraces = {"total": 0, "families": {}}
    for doc in docs:
        for e in doc.get("entries", []):
            key = e.get("key")
            cell = entries.get(key)
            if cell is None:
                entries[key] = dict(e)
                continue
            for f in _SUM_FIELDS:
                cell[f] = (cell.get(f) or 0) + (e.get(f) or 0)
            for f in ("flops", "transcendentals", "bytes_accessed") + _MEMORY_FIELDS:
                if cell.get(f) is None:
                    cell[f] = e.get(f)
        for dev, cell in (doc.get("watermarks") or {}).items():
            merged = watermarks.setdefault(dev, {"in_use": 0, "peak_bytes": 0})
            for f in ("in_use", "peak_bytes"):
                merged[f] = max(merged[f], int(cell.get(f, 0)))
        r = doc.get("retraces") or {}
        retraces["total"] += int(r.get("total", 0))
        for fam, n in (r.get("families") or {}).items():
            retraces["families"][fam] = retraces["families"].get(fam, 0) + n
    return {
        "version": LEDGER_VERSION,
        "ts": time.time(),
        "merged_from": len(docs),
        "entries": sorted(entries.values(), key=lambda e: -(e.get("wall_seconds") or 0)),
        "watermarks": watermarks,
        "retraces": retraces,
        "peaks": device_peaks(),
    }


def load_ledger_dir(path: str) -> List[dict]:
    """Decode every ``costs-*.json`` shard under a telemetry dir."""
    import glob
    import os

    docs = []
    for p in sorted(glob.glob(os.path.join(path, "costs-*.json"))):
        with open(p) as f:
            docs.append(json.load(f))
    return docs


def family_rollup(doc: dict) -> Dict[str, dict]:
    """Per-family totals over a ledger document: programs, compiles,
    invocations, total counted flops/bytes (× invocations), wall."""
    out: Dict[str, dict] = {}
    for e in doc.get("entries", []):
        cell = out.setdefault(
            e.get("family") or "?",
            {
                "programs": 0, "compiles": 0, "compile_seconds": 0.0,
                "invocations": 0, "wall_seconds": 0.0, "rows_served": 0,
                "total_flops": 0.0, "total_bytes": 0.0, "unavailable": 0,
            },
        )
        cell["programs"] += 1
        cell["compiles"] += e.get("compiles") or 0
        cell["compile_seconds"] += e.get("compile_seconds") or 0.0
        cell["invocations"] += e.get("invocations") or 0
        cell["wall_seconds"] += e.get("wall_seconds") or 0.0
        cell["rows_served"] += e.get("rows_served") or 0
        inv = e.get("invocations") or 0
        if e.get("flops") is not None:
            cell["total_flops"] += e["flops"] * inv
        if e.get("bytes_accessed") is not None:
            cell["total_bytes"] += e["bytes_accessed"] * inv
        if e.get("unavailable"):
            cell["unavailable"] += 1
    return out


def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    path = env_str(COST_DUMP_ENV)
    if path and _LEDGER is not None:
        try:
            dump_ledger(path)
        except OSError:
            pass


atexit.register(_dump_at_exit)
configure()
