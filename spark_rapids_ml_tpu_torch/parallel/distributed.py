"""Multi-process execution over ``torch.distributed`` — port of the
reference's ``parallel/distributed.py`` (its ``jax.distributed`` bring-up).

Deployment shape, as in the reference (one executor per device): a
launcher starts N processes and hands each a coordinator address and its
rank (``TPUML_COORDINATOR`` / ``TPUML_NUM_PROCESSES`` /
``TPUML_PROCESS_ID``, or arguments); each process calls
:func:`initialize`, loads its LOCAL rows, and fits through the ordinary
estimator API with ``global_mesh()`` (or ``setDeployMode("gang")``).
Every process returns the identical model: the reductions are
``all_reduce``d, and an ``all_reduce`` hands every rank the same bits.

The backend is NCCL on ``"cuda"`` (after ``torch.cuda.set_device``) and
gloo on ``"cpu"``; ``backend=`` overrides it (two ranks on one card must
use gloo: NCCL refuses two ranks on one GPU). Every handshake is an
``all_reduce`` (``parallel/collectives.allreduce_slots``), the one
collective both backends take on CUDA and CPU tensors alike.

The bring-up and the psum moment merge run under the shared retry policy
with their fault sites (``distributed.initialize``, ``collective.psum``),
as in the reference; a fault spec is the same on every process, so the
gang retries in lockstep, and each site fires before any collective. A
restored solver state is placed for a mesh fit by
``robustness/checkpoint.replicate_state_onto_mesh``.

Left out until its item: ``bringup_executor`` needs the Spark resource
discovery (``spark/resources.py``) and raises naming ROADMAP A.9's Spark
item.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments
from spark_rapids_ml_tpu_torch.observability.events import emit, inject_env, set_process_index
from spark_rapids_ml_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    allreduce_slots,
    process_count,
    process_index,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    ShardedRows,
    make_mesh,
    model_axis_size,
    place_host_rows,
)
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.robustness.retry import default_policy
from spark_rapids_ml_tpu_torch.utils.envknobs import EnvKnobError, env_int, env_str
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

BRINGUP_ITEM = (
    "bringup_executor needs the Spark resource discovery (spark/resources.py), "
    "which is not ported yet: ROADMAP A.9, the Spark item; call initialize() "
    "after pinning the process to its device"
)

_initialized = False
# The coordinates the active group was brought up with, compared against
# any later initialize() so a conflicting request is named.
_init_record: Optional[dict] = None


class GangReinitWarning(UserWarning):
    """A second :func:`initialize` asked for a different gang than the one
    this process already joined. The request is ignored (a new gang needs
    a fresh process, or ``destroy_process_group`` first); the warning
    carries the field and both values."""

    def __init__(self, field: str, active, requested):
        self.field = field
        self.active = active
        self.requested = requested
        super().__init__(
            f"torch.distributed is already initialized with {field}="
            f"{active!r}; ignoring a later initialize() requesting "
            f"{field}={requested!r} — a genuinely new gang needs a fresh "
            "process (or torch.distributed.destroy_process_group() first)"
        )


def _check_reinit_request(coordinator_address, num_processes, process_id) -> None:
    """The already-initialized path: resolve what this call asked for
    (arguments > environment; a malformed environment reads as unknown)
    and warn, field by field, where it differs from the active group."""
    if _init_record is None:
        return
    requested = {"coordinator_address": coordinator_address or env_str("TPUML_COORDINATOR")}
    try:
        requested["num_processes"] = (
            num_processes if num_processes is not None else env_int("TPUML_NUM_PROCESSES", minimum=1)
        )
        requested["process_id"] = (
            process_id if process_id is not None else env_int("TPUML_PROCESS_ID", minimum=0)
        )
    except EnvKnobError:
        requested.setdefault("num_processes", None)
        requested.setdefault("process_id", None)
    for field, asked in requested.items():
        active = _init_record.get(field)
        if asked is not None and active is not None and asked != active:
            warnings.warn(GangReinitWarning(field, active, asked), stacklevel=3)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    heartbeat_timeout_seconds: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the ``torch.distributed`` gang (idempotent).

    Arguments fall back to ``TPUML_COORDINATOR`` (``host:port``),
    ``TPUML_NUM_PROCESSES``, ``TPUML_PROCESS_ID`` and
    ``TPUML_HEARTBEAT_TIMEOUT`` (seconds before a collective with a dead
    peer fails instead of hanging). On ``"cuda"`` the process takes the
    device ``local_device_ids[0]`` (default its rank modulo the visible
    devices) and the backend is NCCL; on ``"cpu"`` it is gloo."""
    global _initialized, _init_record
    if _initialized:
        _check_reinit_request(coordinator_address, num_processes, process_id)
        return
    coordinator_address = coordinator_address or env_str("TPUML_COORDINATOR")
    if num_processes is None:
        num_processes = env_int("TPUML_NUM_PROCESSES", minimum=1)
    if process_id is None:
        process_id = env_int("TPUML_PROCESS_ID", minimum=0)
    if heartbeat_timeout_seconds is None:
        heartbeat_timeout_seconds = env_int("TPUML_HEARTBEAT_TIMEOUT", minimum=1)
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize() needs the coordinator address, the number of processes "
            "and this process's id (arguments or TPUML_COORDINATOR / "
            "TPUML_NUM_PROCESSES / TPUML_PROCESS_ID)"
        )
    on_cuda = _device.resolve_device().type == "cuda"
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if on_cuda:
        ordinal = (local_device_ids[0] if local_device_ids
                   else int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(ordinal)
    kwargs = {}
    if heartbeat_timeout_seconds is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=int(heartbeat_timeout_seconds))

    def _bring_up():
        # The coordinator connect is the flaky step of a gang bring-up
        # (members race the coordinator's bind): one retry unit.
        fault_point("distributed.initialize")
        dist.init_process_group(
            backend=backend,
            init_method="tcp://" + coordinator_address,
            world_size=int(num_processes),
            rank=int(process_id),
            **kwargs,
        )

    with TraceRange("distributed bring-up", TraceColor.BLUE):
        default_policy().run(_bring_up, name="distributed.initialize")
    _initialized = True
    _init_record = {
        "coordinator_address": coordinator_address,
        "num_processes": int(num_processes),
        "process_id": int(process_id),
    }
    # Stamp the event envelope with this process's gang rank, so every
    # later record (and telemetry shard) is attributable in a merge.
    set_process_index(int(process_id))
    emit("distributed", action="initialize", coordinator=coordinator_address,
         num_processes=int(num_processes), process_id=int(process_id), backend=backend)


def bringup_executor(*args, **kwargs) -> None:
    """The reference's one-call executor entry; not ported (see
    :data:`BRINGUP_ITEM`)."""
    raise NotImplementedError(BRINGUP_ITEM)


def _local_devices() -> List[torch.device]:
    """This process's devices in a gang: the device :func:`initialize`
    selected on ``"cuda"``, the CPU on ``"cpu"``."""
    first = _device.resolve_device()
    if first.type == "cuda":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [first]


def global_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A (data × model) mesh over the gang's devices: every process builds
    the same mesh, holding its own positions. Outside a gang, a mesh over
    this process's devices (:func:`~spark_rapids_ml_tpu_torch.parallel.
    mesh.make_mesh`)."""
    n_proc = process_count()
    if n_proc <= 1:
        return make_mesh(shape)
    local = _local_devices()
    total = n_proc * len(local)
    if shape is None:
        shape = (total, 1)
    if shape[0] * shape[1] != total:
        raise ValueError(f"mesh shape {shape} != {total} devices across {n_proc} processes")
    if len(local) % shape[1] != 0:
        raise ValueError(
            f"model axis {shape[1]} must divide the per-process device count "
            f"{len(local)}: each process's positions must span whole mesh rows"
        )
    arr = np.empty(len(local), dtype=object)
    arr[:] = local
    return Mesh(arr.reshape(len(local) // shape[1], shape[1]), processes=n_proc)


def member_env(process_id: int, num_processes: int, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of one spawned gang member: ``base`` (default this
    process's environment) plus the member's gang coordinates and the
    trace carrier (``events.inject_env``: ``TPUML_TRACE_ID`` /
    ``TPUML_TRACE_PARENT``), so the member's telemetry shard joins the
    launcher's trace with its own process index. Spawn every member
    inside one run or trace scope to give them one trace: with none, each
    call begins a trace of its own, as in the reference. An inherited
    coordinator address is dropped, and the repo root rides
    ``PYTHONPATH``."""
    env = dict(base if base is not None else os.environ)
    env["TPUML_PROCESS_ID"] = str(int(process_id))
    env["TPUML_NUM_PROCESSES"] = str(int(num_processes))
    env.pop("TPUML_COORDINATOR", None)
    inject_env(env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH")
    if existing:
        if root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = root + os.pathsep + existing
    else:
        env["PYTHONPATH"] = root
    return env


def _allgather_counts_and_width(n_local: int, d_local: int):
    """The shape handshake of every process-local entry. It comes first,
    before anything that can raise on one process, so an empty executor
    takes part instead of stranding its peers, and a width mismatch
    raises on every process alike. Returns ``(counts (n_proc,), d)``."""
    info = allreduce_slots(torch.tensor([n_local, d_local], dtype=torch.int64)).numpy()
    widths = sorted({int(w) for w in info[:, 1] if w >= 0})
    if not widths:
        raise ValueError("no process contributed any blocks")
    if len(widths) > 1:
        raise ValueError(f"feature dim mismatch across processes: {widths}")
    return info[:, 0], widths[0]


def allgather_host_max(value) -> int:
    """The gang-wide maximum of a per-process host integer (the class
    count every member must agree on)."""
    return int(allreduce_slots(torch.tensor([int(value)], dtype=torch.int64)).max())


def shard_rows_process_local(partitions: Sequence[Any], mesh: Mesh, dtype=None) -> ShardedRows:
    """Place this process's LOCAL blocks as its part of the gang's
    row-sharded input. After the counts handshake every process pads its
    rows to the agreed per-process maximum (rounded to its data shards)
    and features to the model axis; the mask zeroes the padding. The
    result's ``n`` and ``d`` are the true global row count and width, and
    its offsets place this process's rows after those of lower ranks."""
    parts = [np.asarray(p) for p in partitions]
    if dtype is not None:
        parts = [p.astype(dtype, copy=False) for p in parts]
    n_local = sum(p.shape[0] for p in parts)
    # Zero-row placeholders carry no width.
    d_local = next((p.shape[1] for p in parts if p.shape[0] > 0), -1)
    counts, d = _allgather_counts_and_width(n_local, d_local)
    np_dtype = parts[0].dtype if parts else np.dtype(dtype or np.float64)
    parts = [p for p in parts if p.shape[0] > 0]
    n_proc = process_count()
    if int(mesh.shape[DATA_AXIS]) * model_axis_size(mesh) != n_proc * mesh.grid.size:
        raise ValueError(
            f"mesh {dict(mesh.shape)} != process_count*local_devices {n_proc}*{mesh.grid.size}"
        )
    shards = mesh.grid.shape[0]
    per_proc = int(counts.max())
    per_proc += (-per_proc) % shards
    offset = int(counts[: process_index()].sum())
    return place_host_rows(parts, mesh, d, np_dtype, per_proc // shards, int(counts.sum()), offset)


def shard_vector_process_local(v_local: Any, mesh: Mesh, n_pad_global: int, dtype=None) -> List[torch.Tensor]:
    """A per-process LOCAL vector (labels, sample weights) in the layout of
    :func:`shard_rows_process_local`: zero-padded to this process's row
    block and split over its data shards (one tensor per data shard)."""
    v = np.asarray(v_local)
    if dtype is not None:
        v = v.astype(dtype, copy=False)
    n_proc = process_count()
    if n_pad_global % n_proc != 0:
        raise ValueError(
            f"padded global length {n_pad_global} must divide evenly across {n_proc} processes"
        )
    per_proc = n_pad_global // n_proc
    if v.shape[0] > per_proc:
        raise ValueError(
            f"local vector has {v.shape[0]} values but this process's row block holds "
            f"{per_proc}; pass the rows and the vector from the same local partitions"
        )
    grid = mesh.grid
    per = per_proc // grid.shape[0]
    pad = np.zeros((per_proc,) + v.shape[1:], dtype=v.dtype)
    pad[: v.shape[0]] = v
    return [torch.from_numpy(pad[i * per:(i + 1) * per].copy()).to(grid[i, 0]) for i in range(grid.shape[0])]


def replicate_for_host(mesh: Optional[Mesh], *arrays):
    """The reference reshards a gang fit's outputs fully replicated before
    host reads. Every mesh route of the port already ends with the
    identical reduced tensor on every process, so this returns the arrays
    as they are (a single array unwrapped)."""
    return arrays if len(arrays) > 1 else arrays[0]


def streaming_covariance_process_local(
    blocks, center: bool = True, dtype: Optional[torch.dtype] = None, precision: str = "highest",
    mesh: Optional[Mesh] = None, merge: str = "auto",
):
    """Each process streams its own blocks through the one-pass shifted
    accumulation on its device (``ops/covariance.shifted_block_scan``),
    then the O(d²) per-process moments merge across the gang:

      - ``"psum"`` (the default with a mesh): the processes agree on a
        common shift (the count-weighted mean of their shifts), each
        rebases its moments onto it in host float64, and the (d, d)
        payload is one ``all_reduce`` in float64 on the device;
      - ``"allgather"`` (the default without a mesh, and for ``"dd"``): the
        packed per-process moments ``[shift | sum | gram]`` are gathered
        and merged in rank order through
        :class:`~spark_rapids_ml_tpu_torch.core.moments.ShiftedMoments`.

    A process with no rows takes part and strands nobody. Returns host
    float64 ``(mean, cov, n_global)`` on every process."""
    from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram, shifted_block_scan

    if merge not in ("auto", "psum", "allgather"):
        raise ValueError(f"merge must be auto|psum|allgather, got {merge!r}")
    if merge == "auto":
        merge = "psum" if (mesh is not None and precision != "dd") else "allgather"
    if merge == "psum" and precision == "dd":
        raise ValueError(
            "merge='psum' would squash the dd moments to the device dtype; "
            "dd uses merge='allgather'"
        )
    dtype = dtype or torch.float64
    gram_precision = "highest" if precision == "dd" else precision
    device = mesh.first_device if mesh is not None else _device.resolve_device()

    def gram_fn(bs: torch.Tensor) -> torch.Tensor:
        bs = bs.to(torch.float64 if precision == "dd" else dtype)
        zero = torch.zeros(bs.shape[1], dtype=bs.dtype, device=bs.device)
        return centered_gram(bs, zero, precision=gram_precision)

    shift, gram, s, n_local = shifted_block_scan(blocks, center, gram_fn, device, min_rows=0)
    d_local = shift.shape[0] if shift is not None else -1
    counts, d = _allgather_counts_and_width(n_local, d_local)
    if shift is None:
        shift = np.zeros(d)
        gram = torch.zeros((d, d), dtype=torch.float64, device=device)
        s = torch.zeros(d, dtype=torch.float64, device=device)
    gram = gram.to(torch.float64)
    s = s.to(torch.float64)
    if merge == "psum":
        # One retry unit around the whole merge: the rebase is host math
        # and the sum deterministic, so a re-run is exact.
        return default_policy().run(
            lambda: _psum_merge_moments(shift, gram, s, n_local, counts, d, center),
            name="collective.psum",
        )
    packed = torch.cat([torch.from_numpy(np.asarray(shift, dtype=np.float64)).to(device),
                        s, gram.reshape(-1)])
    gathered = allreduce_slots(packed).cpu().numpy()
    acc = None
    for i in range(gathered.shape[0]):
        n_i = int(counts[i])
        if n_i == 0:
            continue
        m = ShiftedMoments(d)
        m.n_rows = n_i
        m.shift = gathered[i, :d].copy()
        m.sum = gathered[i, d:2 * d].copy()
        m.gram = gathered[i, 2 * d:].reshape(d, d).copy()
        acc = m if acc is None else acc.merge(m)
    if acc is None or acc.n_rows < 2:
        n_tot = 0 if acc is None else acc.n_rows
        raise ValueError(f"need at least 2 rows to compute a covariance, got {n_tot}")
    cov, mean = acc.finalize(center=center)
    return mean, cov, acc.n_rows


def _psum_merge_moments(shift, gram: torch.Tensor, s: torch.Tensor, n_local: int, counts, d: int,
                        center: bool):
    """Rebase this process's moments onto the common shift (exact closed
    form, host float64), then one ``all_reduce`` of ``[gram | sum]``. The
    exact integer row count comes from the counts handshake, never from
    the float payload. The fault site comes before the first collective."""
    fault_point("collective.psum")
    shifts = allreduce_slots(torch.from_numpy(np.asarray(shift, dtype=np.float64))).numpy()
    weights = counts.astype(np.float64)
    common = (shifts * weights[:, None]).sum(axis=0) / max(weights.sum(), 1.0)
    delta = np.asarray(shift, dtype=np.float64) - common
    s64 = s.cpu().numpy()
    s_c = s64 + n_local * delta
    corr = np.outer(delta, s64) + np.outer(s64, delta) + n_local * np.outer(delta, delta)
    gram_c = gram + torch.from_numpy(corr).to(gram.device)
    payload = torch.cat([gram_c.reshape(-1), torch.from_numpy(s_c).to(gram.device)])
    out = all_reduce_sum(payload).cpu().numpy()
    n_tot = int(counts.sum())
    if n_tot < 2:
        raise ValueError(f"need at least 2 rows to compute a covariance, got {n_tot}")
    acc = ShiftedMoments(d)
    acc.n_rows = n_tot
    acc.shift = common
    acc.sum = out[d * d:].copy()
    acc.gram = out[: d * d].reshape(d, d).copy()
    cov, mean = acc.finalize(center=center)
    return mean, cov, acc.n_rows


__all__ = [
    "GangReinitWarning",
    "allgather_host_max",
    "bringup_executor",
    "global_mesh",
    "initialize",
    "member_env",
    "process_count",
    "process_index",
    "replicate_for_host",
    "shard_rows_process_local",
    "shard_vector_process_local",
    "streaming_covariance_process_local",
]
