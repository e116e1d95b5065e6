"""Checkpoint and restore for iterative fits: solvers that resume mid-solve.

Port of the reference's ``robustness/checkpoint.py``. The segmented solvers
in ``ops/`` (Lloyd, the linear FISTA, logistic L-BFGS, the UMAP layout)
expose their whole state as a flat tuple of tensors and host arrays
between segments of ``TPUML_CHECKPOINT_EVERY`` inner iterations; this
module snapshots it, validates it and hands it back:

  - **Snapshots** — :meth:`FitCheckpointer.save_async` copies the state to
    the host at the segment boundary without blocking the solver: a CUDA
    tensor is copied into pinned memory on its device's current stream
    (so the copy runs after the segment that produced it and before any
    later segment can overwrite it) and an event is recorded; a host
    array is copied at once. A writer thread waits for the events,
    serializes the leaves as one ``.npz`` (``allow_pickle=False``) and
    lands it through ``core/persistence.atomic_file_write`` under
    ``TPUML_CHECKPOINT_DIR``, keyed by estimator uid and parameter hash.
    At most one write is in flight. A failed write warns
    :class:`CheckpointWriteWarning` and the fit goes on.
  - **Validated restore** — :meth:`FitCheckpointer.restore_latest` walks
    the snapshots newest first and skips wrong schema versions, foreign
    parameter hashes, other data (fingerprint), other solvers, leaves
    whose count, shape or dtype differ from the template, and files that
    cannot be read (a torn or truncated write); each skip falls back to
    the previous snapshot.
  - **Counters** — ``checkpoint.write``, ``checkpoint.restore``,
    ``checkpoint.restore.steps``, ``checkpoint.skipped_stale``,
    ``checkpoint.corrupt``, ``checkpoint.write_failed``,
    ``checkpoint.completed``, and the solvers' ``checkpoint.segments`` and
    ``checkpoint.solver_iters`` (``utils/tracing``).

Identity: a snapshot belongs to (estimator uid, parameter hash, data
fingerprint); resuming in another process needs a stable uid
(``KMeans(uid="job-42")``). :func:`params_hash` and
:func:`data_fingerprint` give the reference's digests on the same
parameters and inputs; a dtype enters the fingerprint under its numpy
name.

Fault sites: ``checkpoint.write`` (honours ``:torn``), ``checkpoint.restore``
and ``checkpoint.segment`` (:func:`segment_boundary`).
"""

from __future__ import annotations

import contextvars
import glob
import hashlib
import io
import json
import os
import shutil
import threading
import warnings
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.observability.events import current_trace_context, emit, trace_scope
from spark_rapids_ml_tpu_torch.robustness.faults import InjectedFault, active_plan, fault_point
from spark_rapids_ml_tpu_torch.utils.envknobs import env_int, env_str
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

SCHEMA_VERSION = 1

EVERY_ENV = "TPUML_CHECKPOINT_EVERY"
DIR_ENV = "TPUML_CHECKPOINT_DIR"
KEEP_ENV = "TPUML_CHECKPOINT_KEEP"
UMAP_ENV = "TPUML_CHECKPOINT_UMAP"


def checkpoint_every() -> int:
    """Inner iterations per segment; 0 (the default) disables
    checkpointing and keeps the monolithic solvers."""
    return env_int(EVERY_ENV, 0, minimum=0)


def checkpoint_dir() -> Optional[str]:
    return env_str(DIR_ENV)


def umap_opt_in() -> bool:
    """UMAP's layout checkpoints only with ``TPUML_CHECKPOINT_UMAP=1`` on
    top of the global knobs: its graph and init are recomputed on resume."""
    return bool(env_int(UMAP_ENV, 0, minimum=0))


class CheckpointWriteWarning(UserWarning):
    """A snapshot write failed. Checkpointing is best effort: the fit
    continues, losing at most the failed snapshot's progress window."""


def params_hash(instance) -> str:
    """Stable hash of an estimator's class and resolved parameter map
    (defaults and explicit sets): a changed parameter never resumes a
    foreign solve."""
    merged = {p.name: v for p, v in instance._defaultParamMap.items()}
    merged.update({p.name: v for p, v in instance._paramMap.items()})
    payload = json.dumps(
        {"class": type(instance).__name__, "params": merged},
        sort_keys=True,
        default=repr,
    )
    return hashlib.sha256(payload.encode()).hexdigest()


#: Fixed-point scale of the fingerprint's quantization (2**13: dyadic test
#: data stays exact, realistic magnitudes stay inside int32).
_FP_SCALE = 8192.0


def _dtype_name(a) -> str:
    """A dtype under its numpy name (``float32``, not ``torch.float32``)."""
    dt = getattr(a, "dtype", "?")
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(dt)


def _column_moments(part: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The three int32 column moments of one block of quantized rows; the
    sums wrap as int32, in any order, on the CPU and the card alike."""
    q = torch.round(torch.nan_to_num(torch.clamp(
        part.to(torch.float32) * _FP_SCALE, -(2.0 ** 30), 2.0 ** 30))).to(torch.int32)
    return tuple(torch.sum(m, dim=0, dtype=torch.int32) for m in (q, q * q, q * q * q))


def data_fingerprint(*arrays) -> str:
    """Cheap deterministic fingerprint of the fit inputs, the reference's
    digest on the same arrays. Per array: the trailing dims and the dtype
    (the row count is left out), then three integer column moments of the
    fixed-point rows, which any resharding or reduction order leaves
    alone and zero pad rows do not move. An array may be a tensor, a
    host array, a scalar, ``None``, or a list of row blocks of one array
    (a mesh fit's shards, taken as their concatenation)."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        parts = list(a) if isinstance(a, (list, tuple)) else [a]
        first = parts[0]
        shape = tuple(int(s) for s in getattr(first, "shape", ()))
        h.update(repr(("*",) + shape[1:] + (_dtype_name(first),)).encode())
        if not shape:
            h.update(np.asarray(first.item() if isinstance(first, torch.Tensor) else first,
                                dtype=np.float64).tobytes())
            continue
        sums = None
        for part in parts:
            t = part if isinstance(part, torch.Tensor) else torch.from_numpy(np.asarray(part))
            moments = _column_moments(t)
            sums = moments if sums is None else tuple(s + m.to(s.device) for s, m in zip(sums, moments))
        for col in sums:
            h.update(col.cpu().numpy().astype(np.int64).tobytes())
    return h.hexdigest()


def _world_size() -> int:
    """The gang's member count as this process sees it (1 outside one)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return int(torch.distributed.get_world_size())
    return 1


def _leaf_spec(leaf) -> Tuple[tuple, np.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), np.dtype(_dtype_name(leaf))
    return tuple(np.shape(leaf)), np.asarray(leaf).dtype


def _leaf_compatible(leaf: np.ndarray, template) -> bool:
    """Shape must match exactly; float and bool dtypes too; integer leaves
    may differ in width only."""
    shape, td = _leaf_spec(template)
    if leaf.shape != shape:
        return False
    if leaf.dtype == td:
        return True
    return leaf.dtype.kind in "iu" and td.kind in "iu"


def _restore_leaf(leaf: np.ndarray, template):
    """A restored leaf in its template's form: a tensor on the template's
    device and dtype, else a host array (a 0-d one as a numpy scalar)."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(leaf)).to(device=template.device, dtype=template.dtype)
    td = np.asarray(template).dtype
    out = np.asarray(leaf).astype(td, copy=False)
    return out[()] if out.ndim == 0 else out


def _host_snapshot(state) -> Tuple[list, list]:
    """The state's leaves copied to the host without blocking: CUDA
    tensors into pinned buffers on their device's current stream (one
    event recorded per device), host arrays and CPU tensors at once.
    Returns ``(buffers, events)``; a buffer is numpy or a pinned tensor."""
    buffers, events, devices = [], [], set()
    for leaf in state:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                devices.add(t.device)
                buffers.append(host)
            else:
                buffers.append(t.clone().numpy())
        else:
            buffers.append(np.array(leaf, copy=True))
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return buffers, events


class FitCheckpointer:
    """One fit's checkpoint stream: asynchronous atomic writes, validated
    newest-first restore, bounded retention.

    The surface the segmented solvers use: ``every`` (segment length),
    ``restore_latest(template)``, ``save_async(step, state)``, ``wait()``,
    ``finalize_success()``. A state is a flat tuple of leaves (tensors,
    host arrays, numpy scalars)."""

    def __init__(
        self,
        run_dir: str,
        uid: str,
        param_hash: str,
        data_fp: str,
        every: int,
        keep: int = 2,
        solver: str = "",
    ):
        self.run_dir = run_dir
        self.uid = uid
        self.param_hash = param_hash
        self.data_fp = data_fp
        self.every = every
        self.keep = keep
        self.solver = solver
        self._lock = make_lock("checkpoint.pending")
        self._pending: Optional[threading.Thread] = None  # guarded-by: _lock

    @classmethod
    def for_fit(cls, instance, solver: str, data: Sequence = ()) -> Optional["FitCheckpointer"]:
        """The estimator entry: None unless ``TPUML_CHECKPOINT_DIR`` is set
        and ``TPUML_CHECKPOINT_EVERY`` is positive (the disabled path
        computes no fingerprint)."""
        every = checkpoint_every()
        base = checkpoint_dir()
        if every <= 0 or not base:
            return None
        ph = params_hash(instance)
        run_dir = os.path.join(base, f"{instance.uid}-{ph[:12]}")
        return cls(
            run_dir,
            uid=instance.uid,
            param_hash=ph,
            data_fp=data_fingerprint(*data),
            every=every,
            keep=env_int(KEEP_ENV, 2, minimum=1),
            solver=solver,
        )

    # --- restore ---

    def restore_latest(self, template) -> Optional[Tuple[int, tuple]]:
        """The newest valid snapshot as ``(step, state)`` in ``template``'s
        form (see :func:`_restore_leaf`), or None to start from scratch."""
        t_leaves = list(template)
        for path in sorted(glob.glob(os.path.join(self.run_dir, "ckpt-*.npz")), reverse=True):
            try:
                fault_point("checkpoint.restore")
                with np.load(path, allow_pickle=False) as z:
                    meta = json.loads(str(z["__meta__"][()]))
                    leaves = [z[f"leaf{i}"] for i in range(int(meta["n_leaves"]))]
            except InjectedFault as exc:
                if exc.fatal:
                    raise
                bump_counter("checkpoint.corrupt")
                continue
            except Exception:
                # A truncated zip, missing keys, unreadable JSON: what a
                # kill mid-write leaves behind.
                bump_counter("checkpoint.corrupt")
                continue
            if (
                meta.get("schema") != SCHEMA_VERSION
                or meta.get("uid") != self.uid
                or meta.get("param_hash") != self.param_hash
                or meta.get("solver") != self.solver
                or meta.get("data_fingerprint") != self.data_fp
            ):
                bump_counter("checkpoint.skipped_stale")
                continue
            if len(leaves) != len(t_leaves) or not all(
                _leaf_compatible(l, t) for l, t in zip(leaves, t_leaves)
            ):
                bump_counter("checkpoint.skipped_stale")
                continue
            step = int(meta["step"])
            bump_counter("checkpoint.restore")
            bump_counter("checkpoint.restore.steps", step)
            emit("checkpoint", action="restore", step=step, path=path,
                 uid=self.uid, solver=self.solver)
            world_then = meta.get("world")
            world_now = _world_size()
            if world_then is not None and int(world_then) != world_now:
                bump_counter("checkpoint.gang_resize")
                emit("gang_resize", action="resume", from_members=int(world_then),
                     to_members=world_now, uid=self.uid, solver=self.solver, step=step)
            return step, tuple(_restore_leaf(l, t) for l, t in zip(leaves, t_leaves))
        return None

    # --- save ---

    def save_async(self, step: int, state) -> None:
        """Snapshot ``state`` at ``step``: the leaves are copied to the host
        without blocking (:func:`_host_snapshot`), then the previous write
        is joined and a writer thread serializes and commits this one. The
        writer runs in a copy of the caller's context and trace."""
        buffers, events = _host_snapshot(state)
        self.wait()
        tc = current_trace_context()
        ctx = contextvars.copy_context()

        def _run():
            with trace_scope(tc):
                self._write(step, buffers, events)

        t = threading.Thread(target=ctx.run, args=(_run,), daemon=True)
        t.start()
        with self._lock:
            self._pending = t

    def _write(self, step: int, buffers: list, events: list) -> None:
        with TraceRange("checkpoint write", TraceColor.ORANGE):
            self._write_inner(step, buffers, events)

    def _write_inner(self, step: int, buffers: list, events: list) -> None:
        from spark_rapids_ml_tpu_torch.core.persistence import atomic_file_write

        final = os.path.join(self.run_dir, f"ckpt-{step:08d}.npz")
        try:
            for ev in events:
                ev.synchronize()  # the pinned copies have landed
            host = [b.numpy() if isinstance(b, torch.Tensor) else b for b in buffers]
            meta = {
                "schema": SCHEMA_VERSION,
                "uid": self.uid,
                "param_hash": self.param_hash,
                "data_fingerprint": self.data_fp,
                "solver": self.solver,
                "step": step,
                "n_leaves": len(host),
                "world": _world_size(),
            }
            buf = io.BytesIO()
            np.savez(buf, __meta__=np.asarray(json.dumps(meta)),
                     **{f"leaf{i}": a for i, a in enumerate(host)})
            data = buf.getvalue()
            os.makedirs(self.run_dir, exist_ok=True)
            try:
                fault_point("checkpoint.write")
            except InjectedFault as exc:
                if exc.torn:
                    # A kill mid-file: a truncated artifact at the FINAL
                    # path, which restore_latest must reject.
                    with open(final, "wb") as f:
                        f.write(data[: max(1, len(data) // 3)])
                raise
            atomic_file_write(final, data)
            bump_counter("checkpoint.write")
            emit("checkpoint", action="write", step=step, path=final,
                 uid=self.uid, solver=self.solver, bytes=len(data))
            self._prune()
        except BaseException as exc:
            bump_counter("checkpoint.write_failed")
            emit("checkpoint", action="write_failed", step=step, uid=self.uid,
                 error=type(exc).__name__)
            warnings.warn(
                CheckpointWriteWarning(
                    f"checkpoint write for step {step} of {self.uid} failed "
                    f"({type(exc).__name__}: {exc}); the fit continues and "
                    "at most this snapshot's progress window is lost"
                ),
                stacklevel=2,
            )

    def _prune(self) -> None:
        files = sorted(glob.glob(os.path.join(self.run_dir, "ckpt-*.npz")))
        for stale in files[: max(len(files) - self.keep, 0)]:
            try:
                os.remove(stale)
            except OSError:  # pragma: no cover - best-effort retention
                pass

    def wait(self) -> None:
        """Block until the in-flight write (if any) has committed."""
        with self._lock:
            t, self._pending = self._pending, None
        if t is not None:
            t.join()

    def finalize_success(self) -> None:
        """The fit completed: flush the last write and drop the run
        directory, so a later fit with the same identity starts fresh."""
        self.wait()
        shutil.rmtree(self.run_dir, ignore_errors=True)
        bump_counter("checkpoint.completed")
        emit("checkpoint", action="finalize", step=-1, uid=self.uid, solver=self.solver)


def segment_boundary(checkpointer=None) -> None:
    """The preemption point between solver segments, one named fault site
    (``checkpoint.segment``) for every segmented solver. With a fault plan
    armed the in-flight snapshot is flushed first, so an injected kill
    lands after a known snapshot committed; with none this is one check."""
    if active_plan() is None:
        return
    if checkpointer is not None:
        checkpointer.wait()
    fault_point("checkpoint.segment")


class EphemeralSegmenter:
    """Stand-in for :class:`FitCheckpointer` that segments a solve without
    touching disk (``partial_fit``'s route through the segmented solvers):
    ``restore_latest`` always misses and ``save_async`` does nothing."""

    def __init__(self, every: int):
        self.every = max(1, int(every))

    def restore_latest(self, template=None):
        return None

    def save_async(self, step, state) -> None:
        pass

    def wait(self) -> None:
        pass

    def finalize_success(self) -> None:
        pass


def replicate_state_onto_mesh(state, mesh):
    """A restored solver state placed for a mesh fit: every tensor leaf on
    the mesh's first device, where the port's mesh routes keep their
    solver state (each shard's step copies what it reads from there);
    host leaves stay on the host. Every process of a gang restores the
    same snapshot, so every process places the same state."""
    first = mesh.first_device
    return tuple(leaf.to(first) if isinstance(leaf, torch.Tensor) else leaf for leaf in state)
