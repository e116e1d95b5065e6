"""Device meshes and row sharding — port of the reference's
``parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` and places one global array
over it; XLA inserts the collectives. The port's :class:`Mesh` is a small
class with the reference's surface (``devices``, ``axis_names``, and a
``shape`` dict, so ``mesh.shape["data"]`` reads the same in both
packages), and a sharded input is a :class:`ShardedRows`: one
``(rows_per, cols_per)`` tensor per mesh position on that position's
device, one row mask per data shard, and the true and padded sizes. The
mesh routes compute a partial per shard and meet in
:mod:`~spark_rapids_ml_tpu_torch.parallel.collectives`.

Padding and masks are the reference's: rows are zero-padded to a
multiple of the data axis and features to a multiple of the model axis;
the mask is 1 on real rows and 0 on pad rows, and ``weightCol`` weights
fold into it. A :class:`ShardedRows` also records how many rows of each
shard are real (the pad rows of a shard are its last ones), so a route
reads the real rows as a slice instead of multiplying by the mask.

A device may appear more than once in ``devices`` (``make_mesh((8, 1),
devices=[cpu] * 8)``): torch has no counterpart of the reference's eight
virtual CPU devices, so the tests build their meshes that way, and on one
card ``devices=[cuda0] * 4`` runs the four-shard route on the one card.

In a ``torch.distributed`` gang every process holds a mesh over its own
devices; ``processes`` says how many processes share the mesh, and the
data axis of ``shape`` counts all of theirs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.parallel.collectives import all_gather_model, process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


class Mesh:
    """A (data × model) grid of torch devices.

    ``devices`` is an object array of ``torch.device`` shaped like the
    axes (this process's positions); ``shape`` maps each axis name to its
    size across the gang."""

    def __init__(self, devices: Any, axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
                 processes: int = 1):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of rank {arr.ndim} for axes {tuple(axis_names)}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr) if arr.size else arr
        self.axis_names = tuple(axis_names)
        self.processes = int(processes)

    @property
    def shape(self) -> dict:
        dims = dict(zip(self.axis_names, self.devices.shape))
        if DATA_AXIS in dims:
            dims[DATA_AXIS] *= self.processes
        return dims

    @property
    def grid(self) -> np.ndarray:
        """This process's positions as a (data, model) array."""
        return self.devices.reshape(-1, model_axis_size(self))

    @property
    def first_device(self) -> torch.device:
        return self.grid[0, 0]


def _default_devices() -> List[torch.device]:
    """Every visible CUDA device on ``"cuda"`` (raising without a card),
    one CPU device on ``"cpu"``."""
    first = _device.resolve_device()
    if first.type == "cpu":
        return [first]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


GANG_ITEM = (
    "{what} in a gang of {world} processes is not ported yet: the reference's "
    "route takes the whole matrix on every process, not process-local rows: "
    "ROADMAP A.9, item 18 (gang)"
)


def require_one_process(mesh: Mesh, what: str) -> None:
    """The sharded neighbour, ANN, UMAP, DBSCAN and forest routes shard the
    whole matrix over this process's positions; in a gang of more than one
    process they raise ``NotImplementedError``."""
    world = max(int(mesh.processes), process_count())
    if world > 1:
        raise NotImplementedError(GANG_ITEM.format(what=what, world=world))


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """A 2-D (data × model) mesh over ``devices`` (default
    :func:`_default_devices`). Default shape: every device on the data
    axis, model axis 1. A device may be repeated."""
    devices = list(devices if devices is not None else _default_devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axis_names)


def single_device_mesh(device: Optional[Any] = None) -> Mesh:
    device = torch.device(device) if device is not None else _device.resolve_device()
    return make_mesh((1, 1), devices=[device])


def model_axis_size(mesh: Mesh) -> int:
    """Size of the model axis, 1 for a mesh without one (pure data
    parallelism)."""
    return int(mesh.shape.get(MODEL_AXIS, 1))


@dataclass
class ShardedRows:
    """Rows placed over a mesh: ``blocks[i][j]`` is the (rows_per, cols_per)
    block of data shard ``i`` and model position ``j`` on that position's
    device, ``masks[i]`` the (rows_per,) row mask of data shard ``i`` on its
    first device (weights folded in). ``n`` and ``d`` are the true global
    row count and feature count; ``valid[i]`` is the number of real rows of
    local shard ``i`` (its first ones) and ``offsets[i]`` the global index
    of its first row, so the real rows of the gang in shard order are the
    global rows in order."""

    mesh: Mesh
    blocks: List[List[torch.Tensor]]
    masks: List[torch.Tensor]
    n: int
    d: int
    valid: List[int]
    offsets: List[int]
    weighted: bool = False
    _gathered: Optional[List[torch.Tensor]] = field(default=None, repr=False)

    @property
    def rows_per(self) -> int:
        return int(self.blocks[0][0].shape[0])

    @property
    def cols_per(self) -> int:
        return int(self.blocks[0][0].shape[1])

    @property
    def n_pad(self) -> int:
        """Padded global row count (the reference's ``x.shape[0]``)."""
        return self.rows_per * int(self.mesh.shape[DATA_AXIS])

    @property
    def d_pad(self) -> int:
        return self.cols_per * model_axis_size(self.mesh)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_pad, self.d_pad)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0][0].device

    def shard(self, i: int) -> torch.Tensor:
        """Data shard ``i`` at full (padded) width, its model blocks
        gathered on its first device (computed once)."""
        if self._gathered is None:
            self._gathered = [None] * len(self.blocks)
        if self._gathered[i] is None:
            self._gathered[i] = all_gather_model(self.blocks[i])
        return self._gathered[i]

    def local_rows(self, i: int) -> torch.Tensor:
        """The real rows of data shard ``i`` at the true width ``d``."""
        return self.shard(i)[: self.valid[i], : self.d]

    def local_weights(self, i: int) -> Optional[torch.Tensor]:
        """The weights of the real rows of shard ``i``, or None when every
        real row weighs 1."""
        return self.masks[i][: self.valid[i]] if self.weighted else None

    def split_vector(self, v: Any, dtype: torch.dtype) -> List[torch.Tensor]:
        """A per-row vector of this process's rows (labels, weights; a host
        array or a tensor, ``n_local`` entries) laid out like the rows: one
        zero-padded (rows_per,) tensor per data shard on its first device."""
        grid = self.mesh.grid
        total = self.rows_per * grid.shape[0]
        if isinstance(v, torch.Tensor):
            flat = v.reshape(-1).to(dtype)
            if flat.shape[0] > total:
                raise ValueError(f"vector of {flat.shape[0]} values for {total} row slots")
            flat = torch.nn.functional.pad(flat, (0, total - flat.shape[0]))
            return [flat[i * self.rows_per:(i + 1) * self.rows_per].to(grid[i, 0])
                    for i in range(grid.shape[0])]
        host = np.asarray(v).ravel()
        if host.shape[0] > total:
            raise ValueError(f"vector of {host.shape[0]} values for {total} row slots")
        pad = np.zeros(total, dtype=torch.empty((), dtype=dtype).numpy().dtype)
        pad[: host.shape[0]] = host
        return [torch.from_numpy(pad[i * self.rows_per:(i + 1) * self.rows_per].copy()).to(grid[i, 0])
                for i in range(grid.shape[0])]

    def fold_weights(self, weights: List[torch.Tensor]) -> "ShardedRows":
        """The same rows with per-shard weights multiplied into the masks."""
        masks = [m * w.to(device=m.device, dtype=m.dtype) for m, w in zip(self.masks, weights)]
        return ShardedRows(self.mesh, self.blocks, masks, self.n, self.d, self.valid,
                           self.offsets, weighted=True, _gathered=self._gathered)

    def with_masks(self, dtype: torch.dtype) -> "ShardedRows":
        """The same rows with the masks cast to ``dtype``."""
        masks = [m.to(dtype) for m in self.masks]
        return ShardedRows(self.mesh, self.blocks, masks, self.n, self.d, self.valid,
                           self.offsets, weighted=self.weighted, _gathered=self._gathered)

    def numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """This process's padded rows and mask as host arrays, in the
        layout of the reference's global array."""
        x = np.concatenate([self.shard(i).detach().cpu().numpy() for i in range(len(self.blocks))])
        m = np.concatenate([mk.detach().cpu().numpy() for mk in self.masks])
        return x, m


def _valid_counts(n_local: int, rows_per: int, shards: int) -> List[int]:
    return [min(max(n_local - i * rows_per, 0), rows_per) for i in range(shards)]


def _to_device(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host block as a tensor on ``dev`` that owns its memory."""
    t = torch.from_numpy(np.require(host, requirements=("C", "W")))
    return t.to(dev, copy=True)


def place_host_rows(parts: List[np.ndarray], mesh: Mesh, d: int, np_dtype, rows_per: int,
                    n_global: int, offset: int = 0) -> ShardedRows:
    """Place this process's host blocks (``sum(rows) <= rows_per × local
    data shards``) over its mesh positions without concatenating them:
    each shard's rows are assembled from the blocks they span, one shard
    at a time (the host peak is one shard). The placement loop is one
    retry unit with one ``ingest.device_put`` site."""
    grid = mesh.grid
    dp, mp = grid.shape
    d_pad = d + ((-d) % mp)
    cols_per = d_pad // mp
    n_local = sum(p.shape[0] for p in parts)

    def rows_slice(start: int, stop: int) -> np.ndarray:
        pieces, off = [], 0
        for p in parts:
            lo, hi = max(start, off), min(stop, off + p.shape[0])
            if lo < hi:
                pieces.append(p[lo - off:hi - off])
            off += p.shape[0]
        got = sum(pc.shape[0] for pc in pieces)
        if got < stop - start:
            pieces.append(np.zeros((stop - start - got, d), dtype=np_dtype))
        block = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)
        if d_pad > d:
            block = np.pad(block, ((0, 0), (0, d_pad - d)))
        return block

    valid = _valid_counts(n_local, rows_per, dp)

    def place_shards():
        blocks, masks = [], []
        for i in range(dp):
            block = rows_slice(i * rows_per, (i + 1) * rows_per)
            blocks.append([_to_device(block[:, j * cols_per:(j + 1) * cols_per], grid[i, j])
                           for j in range(mp)])
            mask = np.zeros(rows_per, dtype=np_dtype)
            mask[: valid[i]] = 1.0
            masks.append(_to_device(mask, grid[i, 0]))
        return blocks, masks

    # Pure host->device placement: the whole loop is one retry unit with
    # one fault site, as the reference's.
    from spark_rapids_ml_tpu_torch.core.ingest import guarded_placement

    blocks, masks = guarded_placement(place_shards, mesh.first_device)
    offsets = [offset + i * rows_per for i in range(dp)]
    return ShardedRows(mesh, blocks, masks, int(n_global), int(d), valid, offsets)


def shard_rows(x: Any, mesh: Mesh) -> ShardedRows:
    """Place a host (n, d) array over the mesh, rows padded to the data
    axis and features to the model axis with zeros (the reference's
    ``(x_sharded, mask, n_true)`` as one :class:`ShardedRows`)."""
    return shard_rows_from_partitions([np.asarray(x)], mesh)


def shard_rows_from_partitions(partitions: Sequence[Any], mesh: Mesh, dtype=None) -> ShardedRows:
    """Place a list of host (rows_i, d) blocks over the mesh row-sharded
    without materializing their concatenation: the same shards, padding
    and mask as ``shard_rows(np.concatenate(partitions), mesh)``."""
    parts = [np.asarray(p) for p in partitions]
    if dtype is not None:
        parts = [p.astype(dtype, copy=False) for p in parts]
    n = sum(p.shape[0] for p in parts)
    d = parts[0].shape[1]
    dp = int(mesh.shape[DATA_AXIS])
    rows_per = (n + ((-n) % dp)) // dp
    return place_host_rows(parts, mesh, d, parts[0].dtype, rows_per, n)


def shard_tensor_rows(x: torch.Tensor, mesh: Mesh) -> ShardedRows:
    """Split a (n, d) tensor over the mesh where it lives: rows and
    features are zero-padded on its device when they do not divide the
    axes, and each block moves to its position's device (a view when that
    is the tensor's own device)."""
    grid = mesh.grid
    dp, mp = grid.shape
    n, d = int(x.shape[0]), int(x.shape[1])
    pad_n, pad_d = (-n) % dp, (-d) % mp
    if pad_n or pad_d:
        x = torch.nn.functional.pad(x, (0, pad_d, 0, pad_n))
    rows_per, cols_per = (n + pad_n) // dp, (d + pad_d) // mp
    valid = _valid_counts(n, rows_per, dp)
    blocks, masks = [], []
    for i in range(dp):
        rows = x[i * rows_per:(i + 1) * rows_per]
        blocks.append([rows[:, j * cols_per:(j + 1) * cols_per].to(grid[i, j]) for j in range(mp)])
        mask = torch.zeros(rows_per, dtype=x.dtype, device=grid[i, 0])
        mask[: valid[i]] = 1.0
        masks.append(mask)
    return ShardedRows(mesh, blocks, masks, n, d, valid, [i * rows_per for i in range(dp)])


def device_array_rows_on_mesh(x: torch.Tensor, mesh: Mesh, shard_features: bool = False) -> ShardedRows:
    """Split a tensor row-wise over the mesh's data axis. A live tensor is
    not copied into padded form here, so its rows must divide the data
    axis (and, with ``shard_features``, its features the model axis), as
    in the reference."""
    dp = int(mesh.shape[DATA_AXIS])
    if x.shape[0] % dp != 0:
        raise ValueError(
            f"device-array input with a mesh needs rows divisible by "
            f"the data axis ({dp}), got {x.shape[0]}; pad/trim the "
            f"array or pass host partitions (which pad with masking)"
        )
    if shard_features and MODEL_AXIS in mesh.shape:
        mp = model_axis_size(mesh)
        if x.shape[1] % mp != 0:
            raise ValueError(
                f"device-array input with shard_features needs features "
                f"divisible by the model axis ({mp}), got {x.shape[1]}"
            )
    return shard_tensor_rows(x, mesh)


def weights_as_mask(w_host: Any, n_rows: int, dtype, mesh: Optional[Mesh] = None):
    """Per-row ``weightCol`` weights as the row mask, zero-padded to
    ``n_rows`` (padding weighs nothing): one tensor on the platform's
    device, or under a mesh one (n_rows / data shards,) tensor per data
    shard on its first device."""
    dtype = _TORCH_DTYPE.get(np.dtype(dtype), dtype) if not isinstance(dtype, torch.dtype) else dtype
    w_pad = np.zeros(n_rows, dtype=torch.empty((), dtype=dtype).numpy().dtype)
    w_host = np.asarray(w_host)
    w_pad[: len(w_host)] = w_host
    if mesh is None:
        return torch.from_numpy(w_pad).to(_device.resolve_device())
    grid = mesh.grid
    per = n_rows // grid.shape[0]
    return [torch.from_numpy(w_pad[i * per:(i + 1) * per].copy()).to(grid[i, 0])
            for i in range(grid.shape[0])]
