"""Serving path of ``transform`` / ``predict``: the bucketed program cache,
pinned double-buffered streaming, and the device-cache hooks. Port of the
reference's ``core/serving.py``.

  - **Row buckets** (:func:`bucket_rows`): a batch of ``n`` rows runs at
    the next power of two (at least :data:`MIN_ROW_BUCKET`), zero-padded,
    and its outputs are sliced back to ``n`` rows. Every serving kernel is
    row-wise, so padding rows never reach a real row's output. Features
    are never bucketed. With ``TPUML_AUTOTUNE=on`` a hot batch size earns
    an exact-fit rung (:func:`ladder_bucket_rows`), at most
    ``MAX_LADDER_RUNGS`` per (model, width), each one more graph.
  - **Program cache** (:func:`serve_rows`): one program per (kernel,
    static config, bucket, width, dtype, device, weights), in an LRU of
    ``TPUML_SERVING_CACHE_SIZE`` entries (32). On a CUDA device a program
    is a ``torch.cuda.CUDAGraph`` captured once: a static ``(bucket, d)``
    input the rows and zero padding are copied into, one replay, and the
    outputs copied out of the graph's static outputs. Off CUDA the program
    is the eager kernel on the padded bucket, so buckets, hits, misses,
    evictions and slicing behave the same. Counters ``serving.cache.hit``,
    ``.miss``, ``.evict``, ``.bypass`` and ``serving.compile`` (here:
    captures) show "captures == buckets, not calls".
  - **Capture bound**: buckets up to :func:`stream_block_rows` rows
    (``TPUML_SERVE_STREAM_BLOCK``, 65,536) are cached. A device batch
    above it runs the same kernel eagerly at its own shape (counter
    ``serving.cache.bypass``): its graph would hold a static copy of the
    whole batch. Host batches above it go through :func:`serve_blocks`.
  - **Pinned double-buffered streaming** (:func:`serve_stream`): on CUDA
    each host block is copied into one of two pinned staging buffers,
    sent on a copy stream, and computed on the caller's stream once the
    copy's event has fired; block k+1's copy is in flight while block k
    computes, and block k's result comes back to pinned memory and is
    handed on only after block k+1 is dispatched.
  - **Cost ledger** (``TPUML_COST_LEDGER=1``, ``observability/costs``):
    each capture is recorded with its counted work, its bytes and the
    retrace watchdog's classification (``new_program``, ``new_bucket``,
    ``eviction_refill``, ``retrace``), each replay timed between CUDA
    events on its stream, and each bypass run recorded as a fallback.
  - **Device-cache hooks** (:func:`note_device_cache`,
    :func:`invalidate_device_caches`): the model families register their
    device copies of their weights, so a retired version or a cache reset
    (:func:`clear_program_cache`) frees them and every graph that reads
    them.

A graph reads its weights at the addresses they had at capture, so the
weights are part of a program's key by identity (``data_ptr``), and the
entry holds a reference to them: the memory cannot be freed and reused
under a live graph. Each graph has its own memory pool (PyTorch's default
for ``torch.cuda.graph``), so graphs of different keys replay at once from
different threads and an evicted graph frees its pool; one lock per entry
spans copy-in, replay and copy-out, because the next replay overwrites the
static outputs. Captures are serialized and run in thread-local capture
mode on one capture stream per device, each after one warm-up call of the
kernel on that stream. A failed capture raises: no eager path stands in
for a graph on a CUDA tensor. The reference's ``TPUML_SERVING_DONATE`` is
read and does nothing here (a graph's input is already a static buffer),
and its persistent compilation cache has no counterpart: a captured graph
does not outlive its process.

Residence contract: a tensor is served where it lives and its result stays
there; a host array is served on ``device`` (the platform's) in float64,
as every family's host route computes, and comes back as numpy. Counters
``serving.h2d.bytes`` and ``serving.d2h.bytes`` count the bytes the host
routes copy in and out.
"""

from __future__ import annotations

import gc
import itertools
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import _block_to_dense, dense_block
from spark_rapids_ml_tpu_torch.core.ingest import numpy_dtype
from spark_rapids_ml_tpu_torch.observability import autotune as _autotune
from spark_rapids_ml_tpu_torch.observability import costs as _costs
from spark_rapids_ml_tpu_torch.observability.events import emit, run_scope
from spark_rapids_ml_tpu_torch.observability.metrics import ROW_BUCKETS, gauge, histogram
from spark_rapids_ml_tpu_torch.serving.signature import tree_leaves, tree_map
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice, env_int
from spark_rapids_ml_tpu_torch.utils.lockcheck import guarded, make_lock, make_rlock
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

#: Smallest row bucket: a single scored row and a 3-row batch share one program.
MIN_ROW_BUCKET = 8

#: Default bound on the program LRU (``TPUML_SERVING_CACHE_SIZE``).
DEFAULT_CACHE_SIZE = 32

#: Rows per block of a large host batch, and the largest cached bucket
#: (``TPUML_SERVE_STREAM_BLOCK``).
DEFAULT_STREAM_BLOCK = 65536

STREAM_BLOCK_ENV = "TPUML_SERVE_STREAM_BLOCK"
CACHE_SIZE_ENV = "TPUML_SERVING_CACHE_SIZE"
DONATE_ENV = "TPUML_SERVING_DONATE"

#: The dtype host rows are served in: every family's host route computes
#: in float64.
HOST_DTYPE = torch.float64


def stream_block_rows() -> int:
    """Rows per block for host-batch streaming and the capture bound."""
    return env_int(STREAM_BLOCK_ENV, DEFAULT_STREAM_BLOCK, minimum=1)


def bucket_rows(n: int, min_bucket: int = MIN_ROW_BUCKET) -> int:
    """The pow-2 row bucket ``n`` pads into (features are never bucketed)."""
    if n <= 0:
        raise ValueError(f"batch must have at least one row, got {n}")
    if n <= min_bucket:
        return min_bucket
    return 1 << (n - 1).bit_length()


def ladder_bucket_rows(n: int, *, name: str, width: int, observe: bool = True) -> int:
    """The bucket one serving request of ``n`` rows runs at: the pow-2
    :func:`bucket_rows` value unless the autotuner's learned
    per-(model, width) ladder has an exact-fit rung (which may sit below
    :data:`MIN_ROW_BUCKET`). ``observe=True`` also feeds the request into
    the ladder's traffic histogram; admission pricing peeks with
    ``observe=False`` so one request is not counted twice. With the tuner
    off this IS ``bucket_rows``."""
    bucket = bucket_rows(n)
    tuner = _autotune.active()
    if tuner is None:
        return bucket
    if observe:
        return tuner.serving_bucket(name, width, n, bucket)
    return tuner.peek_serving_bucket(name, width, n, bucket)


def _capacity() -> int:
    return env_int(CACHE_SIZE_ENV, DEFAULT_CACHE_SIZE, minimum=1)


def _observe_batch(n: int) -> None:
    histogram("serving.batch_rows", "rows per serving call", buckets=ROW_BUCKETS).observe(n)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def _take(leaf: Any, n: int, bucket: int, copy: bool) -> Any:
    """One output leaf with its padding rows cut off (a copy when it is a
    graph's static output, which the next replay overwrites)."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    if leaf.dim() >= 1 and leaf.shape[0] == bucket and n != bucket:
        leaf = leaf[:n]
    return leaf.clone() if copy else leaf


class _Program:
    """One cache entry: the kernel at one bucket, width, dtype, device and
    set of weights. ``run`` serves ``n`` rows; on CUDA it replays the
    captured graph, elsewhere it runs the kernel on the padded bucket."""

    def __init__(self, fn: Callable, weights: tuple, static: dict, bucket: int, d: int,
                 dtype: torch.dtype, device: torch.device, name: str = ""):
        self.fn = fn
        self.name = name
        self.weights = weights  # held: the graph reads them by address
        self.ptrs = frozenset(leaf.data_ptr() for leaf in tree_leaves(weights)
                              if isinstance(leaf, torch.Tensor))
        self.static = static
        self.bucket = bucket
        self.d = d
        self.dtype = dtype
        self.device = device
        self.lock = make_lock("core_serving.program")
        self.closed = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_x: Optional[torch.Tensor] = None
        self.static_out: Any = None
        self.event: Optional[torch.cuda.Event] = None  # end of the last use
        self.dirty = 0  # rows of static_x that may hold a caller's data
        self.ledger_key: Optional[str] = None  # set when the cost ledger recorded it

    @property
    def is_graph(self) -> bool:
        return self.device.type == "cuda"

    def capture(self, measure: bool = False) -> Optional[dict]:
        """Capture the kernel at this bucket (the caller holds
        ``_CAPTURE_LOCK``): one warm-up call on the capture stream (lazy
        cuBLAS handles and module loads happen outside the capture), then
        the capture in thread-local mode, so other threads' CUDA calls
        stay legal meanwhile. The static input is allocated inside the
        capture, from the graph's own pool like its outputs: a long-lived
        buffer carved from the shared pool would pin the whole cached
        segment it sits in. Raises if the kernel cannot be captured.

        ``measure=True`` (the cost ledger) returns the program's bytes:
        the device's allocator peak is reset before the capture, and its
        growth across it, less the static input and outputs, is what the
        graph's pool holds beyond them (``temp_bytes``)."""
        with torch.cuda.device(self.device):
            stream = _capture_stream(self.device)
            current = torch.cuda.current_stream(self.device)
            warm = torch.zeros((self.bucket, self.d), dtype=self.dtype, device=self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.fn(warm, *self.weights, **self.static)
            stream.synchronize()
            del warm
            if measure:
                torch.cuda.reset_peak_memory_stats(self.device)
                base = torch.cuda.memory_allocated(self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                static_x = torch.empty((self.bucket, self.d), dtype=self.dtype, device=self.device)
                out = self.fn(static_x, *self.weights, **self.static)
            memory = None
            if measure:
                grown = torch.cuda.max_memory_allocated(self.device) - base
                in_bytes = static_x.numel() * static_x.element_size()
                out_bytes = _costs.tensor_bytes(out)
                memory = {"argument_bytes": in_bytes + _costs.tensor_bytes(self.weights), "output_bytes": out_bytes,
                          "temp_bytes": max(grown - in_bytes - out_bytes, 0)}
            static_x.zero_()
            self.event = torch.cuda.Event()
            self.event.record(current)
        self.graph, self.static_x, self.static_out = graph, static_x, out
        return memory

    def run(self, x: torch.Tensor, n: int) -> Any:
        """The outputs for the ``n`` rows of ``x`` (a tensor on the CPU or
        on this program's device, already at its dtype), or None when the
        entry was closed meanwhile (the caller fetches a fresh one)."""
        if not self.is_graph:
            weights = self.weights  # read before the check: close() empties it after closing
            if self.closed:
                return None
            if n == self.bucket and x.device == self.device:
                xp = x
            else:
                xp = torch.zeros((self.bucket, self.d), dtype=self.dtype, device=self.device)
                xp[:n].copy_(x)
            led = _costs.active() if self.ledger_key is not None else None
            if led is None:
                out = self.fn(xp, *weights, **self.static)
            else:
                out = _costs.timed_invocation(led, self.ledger_key, n, self.device,
                                              lambda: self.fn(xp, *weights, **self.static))
            return tree_map(lambda leaf: _take(leaf, n, self.bucket, copy=False), out)
        with self.lock:
            if self.closed:
                return None
            stream = torch.cuda.current_stream(self.device)
            if self.event is not None:
                stream.wait_event(self.event)
            self.static_x[:n].copy_(x)
            if self.dirty > n:
                self.static_x[n:self.dirty].zero_()
            self.dirty = n
            led = _costs.active() if self.ledger_key is not None else None
            if led is None:
                self.graph.replay()
            else:
                _costs.timed_invocation(led, self.ledger_key, n, self.device, self.graph.replay, stream=stream)
            out = tree_map(lambda leaf: _take(leaf, n, self.bucket, copy=True), self.static_out)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        return out

    def close(self) -> None:
        """Free the graph, its pool and its static buffers once its last
        use has finished on the card; later ``run`` calls return None."""
        with self.lock:
            if self.closed:
                return
            self.closed = True
            if self.event is not None:
                self.event.synchronize()
            if self.graph is not None:
                self.graph.reset()
            self.graph = self.static_x = self.static_out = self.event = None
            self.weights = ()


_LOCK = make_rlock("core_serving.programs")
_PROGRAMS: "OrderedDict[tuple, _Program]" = OrderedDict()  # guarded-by: _LOCK
_STATS = {"hits": 0, "misses": 0, "evictions": 0, "compiles": 0, "bypass": 0}  # guarded-by: _LOCK
# The cache keys the LRU (or a ladder commit) dropped while the cost ledger
# was on, so the retrace watchdog tells a refill from a retrace.
_EVICTED_KEYS: set = set()  # guarded-by: _LOCK
_MAX_EVICTED_KEYS = 4096
_CAPTURE_LOCK = make_lock("core_serving.capture")  # one capture at a time, per process
_CAPTURE_STREAMS: Dict[str, torch.cuda.Stream] = {}  # guarded by _CAPTURE_LOCK (held by capture())
_COPY_STREAMS: Dict[str, torch.cuda.Stream] = {}  # guarded-by: _LOCK


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    key = str(device)
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[key]


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    with _LOCK:
        key = str(device)
        if key not in _COPY_STREAMS:
            _COPY_STREAMS[key] = torch.cuda.Stream(device)
        return _COPY_STREAMS[key]


def _publish_cache_size() -> None:
    """``serving.cache.size`` gauge, set from a size read under ``_LOCK``.
    Every call site holds ``_LOCK`` — the interprocedural lock-guarded
    pass proves it statically, ``guarded()`` asserts it at runtime when
    the sanitizer is armed."""
    guarded(_LOCK, "core.serving._PROGRAMS")
    gauge("serving.cache.size", "program cache entries").set(len(_PROGRAMS))


def _weights_key(args: tuple) -> tuple:
    """The weights by identity: address, shape, strides, dtype, device of
    every tensor leaf; other leaves by value."""
    return tuple(
        (leaf.data_ptr(), tuple(leaf.shape), leaf.stride(), leaf.dtype, leaf.device)
        if isinstance(leaf, torch.Tensor) else leaf
        for leaf in tree_leaves(args)
    )


def _kernel_name(fn: Callable) -> str:
    return getattr(fn, "__name__", str(fn))


def _note_evicted(key: tuple) -> None:
    """Remember a dropped key for the watchdog (caller holds ``_LOCK``)."""
    if _costs.active() is not None:
        if len(_EVICTED_KEYS) >= _MAX_EVICTED_KEYS:
            _EVICTED_KEYS.clear()
        _EVICTED_KEYS.add(key)


def _get_program(fn: Callable, bucket: int, d: int, dtype: torch.dtype, device: torch.device,
                 args: tuple, static: dict, name: str = "") -> _Program:
    """The cached program for this key, captured (or, off CUDA, built) on
    a miss; over capacity the least recently used entries are closed.
    With the cost ledger on, a new program is recorded (counted work,
    bytes, the watchdog's classification)."""
    key = (fn, tuple(sorted(static.items())), bucket, d, dtype, str(device), _weights_key(args))
    with _LOCK:
        prog = _PROGRAMS.get(key)
        if prog is not None:
            _PROGRAMS.move_to_end(key)
            _STATS["hits"] += 1
            bump_counter("serving.cache.hit")
            emit("serving", action="hit", kernel=_kernel_name(fn))
            return prog
        _STATS["misses"] += 1
        bump_counter("serving.cache.miss")
        emit("serving", action="miss", kernel=_kernel_name(fn))
    env_choice(DONATE_ENV, ("on", "off"), "on")  # validated; a graph's input is static already
    evicted: List[_Program] = []
    with _CAPTURE_LOCK:
        with _LOCK:
            prog = _PROGRAMS.get(key)  # another thread captured it meanwhile
        if prog is not None:
            return prog
        led = _costs.active()
        t0 = time.perf_counter()
        prog = _Program(fn, args, dict(static), bucket, d, dtype, device, name)
        memory = None
        if prog.is_graph:
            with TraceRange(f"serving capture {_kernel_name(fn)}", TraceColor.YELLOW):
                memory = prog.capture(measure=led is not None)
        if led is not None:
            with _LOCK:
                refill = key in _EVICTED_KEYS
                _EVICTED_KEYS.discard(key)
            prog.ledger_key = _costs.record_aot(
                fn, name=name or _kernel_name(fn), static=static, rows=bucket, d=d, dtype=dtype, args=args,
                identity=_weights_key(args), cost=_costs.kernel_cost(fn, bucket, d, dtype, args, static),
                memory=memory, compile_seconds=time.perf_counter() - t0, evicted=refill,
            )
        with _LOCK:
            _STATS["compiles"] += 1
            bump_counter("serving.compile")
            emit("serving", action="compile", kernel=_kernel_name(fn), bucket=bucket)
            _PROGRAMS[key] = prog
            while len(_PROGRAMS) > _capacity():
                old_key, old = _PROGRAMS.popitem(last=False)
                _note_evicted(old_key)
                evicted.append(old)
                _STATS["evictions"] += 1
                bump_counter("serving.cache.evict")
                emit("serving", action="evict")
            _publish_cache_size()
    for old in evicted:
        old.close()
    return prog


def program_cache_stats() -> dict:
    """Snapshot: ``{hits, misses, evictions, compiles, bypass, size, capacity}``
    (``compiles`` counts captures on CUDA, programs built elsewhere)."""
    with _LOCK:
        out = dict(_STATS)
        out["size"] = len(_PROGRAMS)
        out["capacity"] = _capacity()
        return out


def _drop_programs(match: Callable[[_Program], bool], refill: bool = False) -> int:
    """Close and remove every entry ``match`` selects; returns how many.
    ``refill=True`` tells the retrace watchdog that a later capture of a
    dropped key refills it."""
    with _LOCK:
        keys = [k for k, prog in _PROGRAMS.items() if match(prog)]
        dropped = [_PROGRAMS.pop(k) for k in keys]
        if refill:
            for k in keys:
                _note_evicted(k)
        _publish_cache_size()
    for prog in dropped:
        prog.close()
    return len(dropped)


def drop_shadowed_programs(name: str, width: int, ladder: tuple, admitted: int) -> int:
    """After the autotuner admits rung ``admitted`` for (``name``,
    ``width``): close the cached programs of the bucket that size padded
    into before (the next rung above it, else its pow-2 bucket), which its
    traffic has left; a request that still needs one re-captures it as an
    eviction refill. Each close waits for the graph's last replay."""
    above = [r for r in ladder if r > admitted]
    old = min(above) if above else bucket_rows(admitted)
    return _drop_programs(lambda prog: prog.name == name and prog.d == width and prog.bucket == old,
                          refill=True)


def evict_programs(weights: Any) -> int:
    """Close every program that reads any tensor of ``weights`` (a tree);
    returns how many. The registry calls it when a version retires."""
    ptrs = {leaf.data_ptr() for leaf in tree_leaves(weights) if isinstance(leaf, torch.Tensor)}
    if not ptrs:
        return 0
    n = _drop_programs(lambda prog: bool(prog.ptrs & ptrs))
    if n:
        bump_counter("serving.cache.retired", n)
    return n


def clear_program_cache() -> None:
    """Close every program, zero the stats, and drop the device-weight
    copies of every model that registered one: a reset is a
    reconfiguration boundary, and no model may keep serving stale device
    weights past it."""
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0
        _EVICTED_KEYS.clear()
        models = list(_DEVICE_CACHED_MODELS)
    _drop_programs(lambda prog: True)
    ledger = _costs.active()
    if ledger is not None:
        # A reset is a reconfiguration boundary: its refills are no retraces.
        ledger.reset_families()
    for model in models:
        invalidate_device_caches(model)


def reclaim_device_memory(device: Optional[torch.device] = None) -> None:
    """Best-effort release of reclaimable device memory after an OOM: the
    program cache and every model's device-weight copies
    (:func:`clear_program_cache`), a garbage collection, and on a CUDA
    ``device`` the caching allocator's unused blocks. The fit-path
    recovery calls it between attempts, so the retry meets the device's
    true free memory. Counter ``fit.oom.reclaims``."""
    clear_program_cache()
    gc.collect()
    if device is not None and device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.empty_cache()
    bump_counter("fit.oom.reclaims")


# ---------------------------------------------------------------------------
# device-weight caches
# ---------------------------------------------------------------------------

#: A family's device copies of its weights: dicts reset to None, and dicts
#: cleared in place (the attributes every family keeps).
_DEVICE_CACHE_ATTRS = ("_centers_dev", "_wb_dev", "_coef_dev")
_DEVICE_CACHE_DICTS = ("_pc_dev_cache", "_forest_dev")

#: Models that populated a device-weight cache (held weakly).
_DEVICE_CACHED_MODELS: "weakref.WeakSet" = weakref.WeakSet()  # guarded-by: _LOCK


def note_device_cache(model: Any) -> None:
    """Record that ``model`` holds a device-weight cache (the families'
    cache builders call this)."""
    with _LOCK:
        _DEVICE_CACHED_MODELS.add(model)


def invalidate_device_caches(model: Any) -> int:
    """Drop every device-weight cache ``model`` carries (a pipeline's: its
    stages'), and close every program that reads them; returns how many
    caches were live. The registry calls it when a version retires, and
    :func:`clear_program_cache` over every registered model."""
    dropped, tensors = 0, []
    for attr in _DEVICE_CACHE_ATTRS + _DEVICE_CACHE_DICTS:
        cache = getattr(model, attr, None)
        if not cache:
            continue
        tensors.extend(tree_leaves(list(cache.values())))
        if attr in _DEVICE_CACHE_ATTRS:
            setattr(model, attr, None)
        else:
            cache.clear()
        dropped += 1
    evict_programs(tensors)
    if dropped:
        bump_counter("serving.device_cache.invalidate", dropped)
        emit("serving", action="invalidate", model=type(model).__name__, caches=dropped)
    for stage in getattr(model, "stages", None) or ():
        dropped += invalidate_device_caches(stage)
    return dropped


# ---------------------------------------------------------------------------
# serve_rows: one batch
# ---------------------------------------------------------------------------


def serve_rows(
    fn: Callable,
    x: Any,
    args: tuple = (),
    *,
    name: str,
    static: Optional[dict] = None,
    to_host: Optional[bool] = None,
    device: Optional[torch.device] = None,
    dtype: torch.dtype = HOST_DTYPE,
) -> Any:
    """``fn(x, *args, **static)`` through the bucketed program cache.

    A tensor runs where it lives, at its dtype, and its result stays there
    (``to_host=True`` brings it back as numpy). A host array is cast to
    ``dtype`` (float64 by default) and runs on ``device`` (default: the
    platform's); on the card its rows go in one copy straight into the
    program's static input, and the result comes back as numpy. ``args``
    are the weights, on that device. Outputs whose leading axis is the
    bucket are cut back to the true row count. Each call runs in a
    ``serve`` run scope (a fresh ``run_id`` unless one is open)."""
    with run_scope("serve", name):
        return _serve_rows_impl(fn, x, args, name=name, static=static or {}, to_host=to_host, device=device,
                                dtype=dtype)


def _serve_rows_impl(fn, x, args, *, name, static, to_host, device, dtype):
    if isinstance(x, torch.Tensor):
        xt = x[None, :] if x.dim() == 1 else x
        device = xt.device
        to_host = bool(to_host)
    else:
        xh = np.asarray(x)
        if xh.ndim == 1:
            xh = xh[None, :]
        if xh.ndim != 2:
            raise ValueError(f"serving input must be 2-D, got {xh.ndim}-D")
        xt = torch.from_numpy(np.ascontiguousarray(xh, dtype=numpy_dtype(dtype)))
        device = device if device is not None else _device.resolve_device()
        bump_counter("serving.h2d.bytes", xt.numel() * xt.element_size())
        to_host = True if to_host is None else to_host
    n, d = int(xt.shape[0]), int(xt.shape[1])
    with TraceRange(f"serve {name}", TraceColor.GREEN):
        if n == 0:  # nothing to bucket: the kernel on the empty batch
            out = fn(xt.to(device), *args, **static)
        else:
            _observe_batch(n)
            bucket = ladder_bucket_rows(n, name=name, width=d)
            if bucket > stream_block_rows():
                with _LOCK:
                    _STATS["bypass"] += 1
                bump_counter("serving.cache.bypass")
                led = _costs.active()
                if led is None:
                    out = fn(xt.to(device), *args, **static)
                else:
                    out = _serve_bypass_ledgered(led, fn, xt.to(device), args, name, static)
            else:
                out = None
                while out is None:  # None: the entry was evicted between fetch and run
                    prog = _get_program(fn, bucket, d, xt.dtype, device, args, static, name)
                    out = prog.run(xt, n)
    return tree_map(to_numpy, out) if to_host else out


def _serve_bypass_ledgered(led, fn, xd, args, name, static):
    """One eager run above the capture bound, recorded as a fallback of
    its own shape and timed."""
    n, d = int(xd.shape[0]), int(xd.shape[1])
    lkey = _costs.record_fallback(fn, name=name, static=static, args=(xd, *args),
                                  cost=lambda: _costs.kernel_cost(fn, n, d, xd.dtype, args, static))
    return _costs.timed_invocation(led, lkey, n, xd.device, lambda: fn(xd, *args, **static))


def to_numpy(out: Any) -> Any:
    """A serving result leaf as host numpy (counter ``serving.d2h.bytes``)."""
    if not isinstance(out, torch.Tensor):
        return out
    host = out.cpu().numpy()
    bump_counter("serving.d2h.bytes", host.nbytes)
    return host


def upload_block(blk: Any, device: torch.device, dtype: Optional[torch.dtype] = None):
    """``(host, tensor)`` for one raw block: the dense host array and its
    copy on ``device`` in the same dtype. With ``dtype`` the block is cast
    on the host first; without it a float32 block stays float32 (it moves
    half the bytes and widens on the device to the same values) and
    anything else is float64. An empty block gives ``(0, ·)`` arrays."""
    host = dense_block(blk) if dtype is None else _block_to_dense(blk, dtype=numpy_dtype(dtype))
    bump_counter("serving.h2d.bytes", host.nbytes)
    return host, torch.as_tensor(host).to(device)


# ---------------------------------------------------------------------------
# serve_stream / serve_blocks: host blocks
# ---------------------------------------------------------------------------


def serve_stream(
    fn: Callable,
    blocks: Iterable[Any],
    args: tuple = (),
    *,
    name: str,
    device: torch.device,
    dtype: torch.dtype,
    static: Optional[dict] = None,
) -> Iterator[Any]:
    """Yield one host result per non-empty host block: the block goes to
    ``device`` as it is (a float32 block as float32: half the bytes of its
    float64 copy, the same values) and is cast to ``dtype`` there, then
    runs through :func:`serve_rows`. On CUDA the copies are pinned and
    double-buffered (module docstring). Counter ``serving.stream.blocks``."""
    static = static or {}
    if device.type == "cuda":
        yield from _stream_pinned(fn, blocks, args, name=name, device=device, dtype=dtype, static=static)
        return
    for blk in blocks:
        with TraceRange(f"serve {name} H2D", TraceColor.CYAN):
            x_host, x_dev = upload_block(blk, device)
        if x_host.size == 0:
            continue
        out = serve_rows(fn, x_dev.to(dtype=dtype), args, name=name, static=static)
        bump_counter("serving.stream.blocks")
        yield tree_map(to_numpy, out)


class _Staging:
    """Two pinned host buffers for the copies in, one event per buffer
    (set when its copy to the card has finished), and two sets of pinned
    buffers the results come back to."""

    def __init__(self):
        self.inputs: List[Optional[torch.Tensor]] = [None, None]
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.outputs: List[Dict[int, torch.Tensor]] = [{}, {}]

    @staticmethod
    def _flat(buf: Optional[torch.Tensor], numel: int, dtype: torch.dtype) -> torch.Tensor:
        if buf is None or buf.dtype != dtype or buf.numel() < numel:
            return torch.empty(numel, dtype=dtype, pin_memory=True)
        return buf

    def stage_in(self, slot: int, host: np.ndarray) -> torch.Tensor:
        """``host`` in buffer ``slot``, once that buffer's previous copy to
        the card has finished."""
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        src = torch.from_numpy(host)
        buf = self.inputs[slot] = self._flat(self.inputs[slot], src.numel(), src.dtype)
        pinned = buf[:src.numel()].view(src.shape)
        pinned.copy_(src)
        return pinned

    def stage_out(self, slot: int, out: Any) -> Any:
        """Issue the copies of ``out``'s leaves into buffer set ``slot``."""
        bufs = self.outputs[slot]
        index = itertools.count()

        def one(leaf):
            i = next(index)
            if not isinstance(leaf, torch.Tensor):
                return leaf
            bufs[i] = self._flat(bufs.get(i), leaf.numel(), leaf.dtype)
            dst = bufs[i][:leaf.numel()].view(leaf.shape)
            dst.copy_(leaf, non_blocking=True)
            return dst

        return tree_map(one, out)


def _stream_pinned(fn, blocks, args, *, name, device, dtype, static) -> Iterator[Any]:
    copy = _copy_stream(device)
    compute = torch.cuda.current_stream(device)
    staging = _Staging()
    pending = None  # (event, pinned result tree) of the block before
    slot = 0
    for blk in blocks:
        host = dense_block(blk)
        if host.size == 0:
            continue
        with TraceRange(f"serve {name} H2D", TraceColor.CYAN):
            pinned = staging.stage_in(slot, host)
            bump_counter("serving.h2d.bytes", host.nbytes)
            with torch.cuda.stream(copy):
                x_dev = torch.empty(pinned.shape, dtype=pinned.dtype, device=device)
                x_dev.copy_(pinned, non_blocking=True)
                staging.copied[slot] = torch.cuda.Event()
                staging.copied[slot].record(copy)
            compute.wait_event(staging.copied[slot])
            x_dev.record_stream(compute)
        out = serve_rows(fn, x_dev.to(dtype=dtype), args, name=name, static=static)
        result = staging.stage_out(slot, out)
        done = torch.cuda.Event()
        done.record(compute)
        bump_counter("serving.stream.blocks")
        if pending is not None:
            yield _finish(*pending)
        pending = (done, result)
        slot ^= 1
    if pending is not None:
        yield _finish(*pending)


def _finish(done: "torch.cuda.Event", result: Any) -> Any:
    """A block's result as numpy, copied out of its pinned buffers before
    they are reused."""
    done.synchronize()

    def one(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        host = leaf.numpy().copy()
        bump_counter("serving.d2h.bytes", host.nbytes)
        return host

    return tree_map(one, result)


def serve_blocks(
    fn: Callable,
    x_host: np.ndarray,
    args: tuple = (),
    *,
    name: str,
    device: torch.device,
    dtype: torch.dtype = HOST_DTYPE,
    static: Optional[dict] = None,
    block: Optional[int] = None,
    host_dtype: Optional[np.dtype] = None,
) -> Any:
    """One host batch in blocks of ``block`` rows (default
    :func:`stream_block_rows`), the results concatenated leaf-wise; None
    for a batch with no rows. ``host_dtype`` casts each block on the host
    before its copy. A batch of one block has nothing to overlap, so it
    goes straight through :func:`serve_rows` (one copy into the program's
    input, as the reference routes it); a larger one through
    :func:`serve_stream`. Row for row both give what :func:`serve_rows`
    returns on blocks of the same buckets."""
    block = block or stream_block_rows()
    x_host = np.asarray(x_host)
    if x_host.shape[0] == 0:
        return None
    if x_host.shape[0] <= block:
        xh = x_host if host_dtype is None else np.asarray(x_host, dtype=host_dtype)
        return serve_rows(fn, xh, args, name=name, static=static, device=device, dtype=dtype)
    blocks = (x_host[i:i + block] if host_dtype is None else np.asarray(x_host[i:i + block], dtype=host_dtype)
              for i in range(0, x_host.shape[0], block))
    outs = list(serve_stream(fn, blocks, args, name=name, device=device, dtype=dtype, static=static))
    if not outs:
        return None
    if len(outs) == 1:
        return outs[0]
    parts = [tree_leaves(o) for o in outs]
    cat = iter([np.concatenate([p[i] for p in parts], axis=0) for i in range(len(parts[0]))])
    return tree_map(lambda _: next(cat), outs[0])


def prefetch_blocks(blocks: Iterable[Any], prepare: Callable[[Any], Any]) -> Iterator[Any]:
    """One-ahead hand-off for the streaming fit loops: block k is yielded
    only after ``prepare(block k+1)`` has run. The values are exactly
    ``prepare(block)`` in order, as the plain loop gives them. Each block
    handed on after its successor was prepared bumps
    ``fit.stream.prefetched``: the counter counts hand-offs, not overlap.
    A pageable ``.to(device)`` blocks the host, so the fit routes' copies
    overlap nothing; :func:`serve_stream`'s pinned staging is what
    ROADMAP A.3 L5 can reuse for them."""
    pending = _none = object()
    for blk in blocks:
        current = prepare(blk)
        if pending is not _none:
            bump_counter("fit.stream.prefetched")
            yield pending
        pending = current
    if pending is not _none:
        yield pending
