"""DBSCAN — port of the reference's ``ops/dbscan.py``: blocked epsilon-graph
sweeps and min-label propagation.

The epsilon graph is never stored. Every sweep recomputes the pairwise
squared distances block by block, a (Bq, d) x (d, Bi) product per pair of
query and item blocks (:func:`ops.knn._block_sq_distances`, through the
precision mode's ``dot``), and folds each (Bq, Bi) boolean adjacency into
a per-query result: a neighbour count (:func:`core_point_mask`) or the
minimum label over core neighbours (:func:`_min_core_neighbor_label`).
The reference's ``lax.map`` over query blocks and ``lax.scan`` over item
blocks become a Python loop over both; a ragged last block is sliced,
not padded. Counts are integers and labels are minima, so the result
does not depend on the block sizes.

Clusters are the connected components of the core-core epsilon graph:
each round is one sweep (every core point takes the minimum label over
its core neighbours) followed by pointer jumping to a fixpoint
(:func:`_compress_labels`), so the number of sweeps grows as O(log n) in
a chain, not as its diameter. Each ``while`` of the reference's two
``lax.while_loop``s is a Python loop here, and each test of its
condition reads one flag back from the device. Border points then take
the minimum label of their core neighbours; the rest is noise (-1).

Labels are int32 row indices of each cluster's representative (its
lowest core row), with ``_INT_MAX`` as "no core neighbour yet";
:func:`relabel_consecutive` maps them to 0..C-1 on the host.

The eps test is a cancellation: ‖q‖² − 2q·x + ‖x‖² against eps², so far
from the origin float32 rounds pairs across the cut. The estimator
computes host input in float64 (``models/dbscan.py``).

Over a mesh (:func:`dbscan_labels_sharded`) the query rows split over the
data axis and the point set stays whole on every position: each shard
counts its rows' eps-neighbours and runs its part of every sweep with the
same :func:`_eps_sweep` against the whole set (``x_items``), the core mask
and each round's labels are gathered in shard order, and the pointer
jumping runs on the gathered vector. Integer counts and minima, so the
labels are the single-device fit's.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.ops.knn import _block_sq_distances
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, require_one_process

_INT_MAX = torch.iinfo(torch.int32).max


def _pad_rows(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """``x`` zero-padded along its rows to a multiple of ``block``, and the
    number of blocks."""
    n = int(x.shape[0])
    n_blocks = -(-n // block)
    pad = n_blocks * block - n
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])
    return x, n_blocks


def _eps_sweep(
    x: torch.Tensor,
    valid: Optional[torch.Tensor],
    eps_sq: torch.Tensor,
    per_block: Callable,
    combine: Callable,
    block_q: int,
    block_i: int,
    dot: Callable,
    x_items: Optional[torch.Tensor] = None,
    valid_items: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One blocked sweep over the epsilon graph of the query rows ``x``
    against the item rows ``x_items`` (default ``x`` itself, with
    ``valid``; a distinct item set is the mesh's case: a shard's rows
    against the whole set).

    For every query block, every item block's (Bq, Bi) boolean adjacency
    (``d2 <= eps_sq``, masked to valid rows, self-pairs included) goes
    through ``per_block(adj, j0)`` and folds into the block's result with
    ``combine``. A mask of None means every row is real. Returns the
    per-query results, (n,)."""
    if x_items is None:
        x_items, valid_items = x, valid
    n, n_items = int(x.shape[0]), int(x_items.shape[0])
    outs = []
    for q0 in range(0, n, block_q):
        qb = x[q0:q0 + block_q]
        q_sq = torch.sum(qb * qb, dim=1)
        acc = None
        for j0 in range(0, n_items, block_i):
            d2 = _block_sq_distances(qb, x_items[j0:j0 + block_i], q_sq, dot)
            adj = d2 <= eps_sq
            del d2
            if valid_items is not None:
                adj &= valid_items[None, j0:j0 + block_i]
            if valid is not None:
                adj &= valid[q0:q0 + block_q, None]
            part = per_block(adj, j0)
            acc = part if acc is None else combine(acc, part)
        outs.append(acc)
    return torch.cat(outs)


def _eps_sq(x: torch.Tensor, eps: float) -> torch.Tensor:
    """eps² in the rows' dtype, squared there, as the reference does."""
    return torch.tensor(eps, dtype=x.dtype, device=x.device) ** 2


def _valid_mask(x: torch.Tensor, row_mask) -> Optional[torch.Tensor]:
    return None if row_mask is None else torch.as_tensor(row_mask, device=x.device).to(torch.bool)


def _eps_neighbor_counts(x, valid, eps_sq, block_q: int, block_i: int, dot,
                         x_items=None, valid_items=None) -> torch.Tensor:
    """(n,) int32 eps-neighbour counts, self included: the one home of the
    counting sweep (single-device and sharded)."""
    return _eps_sweep(
        x, valid, eps_sq,
        per_block=lambda adj, j0: torch.sum(adj, dim=1, dtype=torch.int32),
        combine=torch.add,
        block_q=block_q, block_i=block_i, dot=dot,
        x_items=x_items, valid_items=valid_items,
    )


def core_point_mask(
    x: torch.Tensor,
    eps: float,
    min_pts: int,
    row_mask: Optional[torch.Tensor] = None,
    block_q: int = 2048,
    block_i: int = 8192,
    precision: str = "highest",
) -> torch.Tensor:
    """Boolean (n,) mask of core points: at least ``min_pts`` neighbours
    within eps, the point itself included (the sklearn/cuML convention).
    ``row_mask`` flags real rows (1) against padding (0)."""
    _device.device_of(x)
    valid = _valid_mask(x, row_mask)
    counts = _eps_neighbor_counts(x, valid, _eps_sq(x, eps), block_q, block_i, make_dot(precision))
    core = counts >= min_pts
    return core if valid is None else core & valid


def _min_core_neighbor_label(x, valid, core, labels, eps_sq, block_q: int, block_i: int, dot,
                             x_items=None, valid_items=None) -> torch.Tensor:
    """For every point, the minimum label over its CORE eps-neighbours
    (itself included when core); ``_INT_MAX`` where it has none. ``core``
    and ``labels`` describe the item set (the query set on one device)."""
    masked_labels = torch.where(core, labels, torch.full_like(labels, _INT_MAX))

    def per_block(adj, j0):
        lab = masked_labels[j0:j0 + adj.shape[1]]
        return torch.where(adj, lab[None, :], _INT_MAX).amin(dim=1)

    return _eps_sweep(x, valid, eps_sq, per_block, torch.minimum, block_q, block_i, dot,
                      x_items=x_items, valid_items=valid_items)


def _compress_labels(labels: torch.Tensor, core: torch.Tensor, n: int) -> torch.Tensor:
    """Pointer jumping ``labels[labels]`` on core points to a fixpoint.

    Labels are row indices, so each jump hops to the representative's
    current representative, and the compressed depth doubles per jump: a
    chain of length L collapses in O(log L) (n,) gathers, each followed
    by one flag read back. ``_INT_MAX`` entries clamp to a harmless
    gather of row n - 1."""
    while True:
        safe = torch.clamp(labels, 0, n - 1).long()
        jumped = torch.where(core, torch.minimum(labels, labels[safe]), labels)
        if not bool(torch.any(jumped != labels)):
            return jumped
        labels = jumped


def dbscan_labels(
    x: torch.Tensor,
    eps: float,
    min_pts: int,
    row_mask: Optional[torch.Tensor] = None,
    block_q: int = 2048,
    block_i: int = 8192,
    precision: str = "highest",
    return_sweeps: bool = False,
):
    """Full DBSCAN: ``(labels (n,) int32, core_mask (n,) bool)``, and the
    number of epsilon sweeps of the propagation (its rounds, the last of
    which changed nothing) with ``return_sweeps``.

    Labels are each cluster's representative row (its lowest core row), -1
    for noise. A border point takes the minimum label of its core
    neighbours (sklearn takes the first in scan order, so border ties may
    differ from sklearn; core clusters are the same)."""
    n = int(x.shape[0])
    valid = _valid_mask(x, row_mask)
    eps_sq = _eps_sq(x, eps)
    dot = make_dot(precision)
    core = core_point_mask(x, eps, min_pts, row_mask=valid, block_q=block_q, block_i=block_i,
                           precision=precision)
    labels = torch.where(core, torch.arange(n, dtype=torch.int32, device=x.device), _INT_MAX)
    sweeps = 0
    changed = True
    while changed:
        neigh = _min_core_neighbor_label(x, valid, core, labels, eps_sq, block_q, block_i, dot)
        new = torch.where(core, torch.minimum(labels, neigh), labels)
        jumped = _compress_labels(new, core, n)
        changed = bool(torch.any(jumped != labels))
        labels = jumped
        sweeps += 1

    neigh = _min_core_neighbor_label(x, valid, core, labels, eps_sq, block_q, block_i, dot)
    border = ~core & (neigh < _INT_MAX)
    if valid is not None:
        border &= valid
    labels = torch.where(border, neigh, labels)
    labels = torch.where(labels == _INT_MAX, -1, labels)
    if valid is not None:
        labels = torch.where(valid, labels, -1)
    if return_sweeps:
        return labels, core, sweeps
    return labels, core


def relabel_consecutive(labels: np.ndarray) -> np.ndarray:
    """Host: representative-row labels to consecutive 0..C-1, ordered by
    first appearance (the sklearn convention); noise stays -1."""
    labels = np.asarray(labels)
    out = np.full_like(labels, -1)
    pos = np.flatnonzero(labels >= 0)
    if pos.size == 0:
        return out
    reps, inverse = np.unique(labels[pos], return_inverse=True)
    first_row = np.full(reps.size, labels.size, dtype=np.int64)
    np.minimum.at(first_row, inverse, pos)
    rank = np.empty(reps.size, dtype=np.int64)
    rank[np.argsort(first_row, kind="stable")] = np.arange(reps.size)
    out[pos] = rank[inverse]
    return out


class _QueryShard(NamedTuple):
    """One data shard of the mesh DBSCAN: its query rows and their mask,
    the whole point set and its mask on the shard's device, and the
    shard's first global row."""

    xq: torch.Tensor
    vq: torch.Tensor
    x_all: torch.Tensor
    v_all: torch.Tensor
    offset: int


def _gather(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The shards' pieces of a per-row vector joined in shard order."""
    return torch.cat([p.to(device) for p in parts])


def dbscan_labels_sharded(
    mesh,
    x: Any,
    eps: float,
    min_pts: int,
    block_q: int = 2048,
    block_i: int = 8192,
    precision: str = "highest",
    return_sweeps: bool = False,
):
    """DBSCAN over a mesh: the query rows split over the data axis, the
    point set whole on every position. ``x`` is a tensor (where it lives)
    or a host matrix (to the mesh's first device, in its own dtype).
    Returns ``(labels (n,) int32, core_mask (n,) bool)`` on the first
    device, as :func:`dbscan_labels` returns them (and the sweep count
    with ``return_sweeps``)."""
    require_one_process(mesh, "the mesh DBSCAN")
    first = mesh.first_device
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x)).to(first)
    _device.device_of(x)
    n = int(x.shape[0])
    dp = int(mesh.shape[DATA_AXIS])
    xp, _ = _pad_rows(x, dp)
    n_tot = int(xp.shape[0])
    n_loc = n_tot // dp
    validp = torch.arange(n_tot, device=x.device) < n
    eps_sq = _eps_sq(x, eps)
    dot = make_dot(precision)
    grid = mesh.grid
    whole = {}
    shards = []
    for i in range(dp):
        dev = grid[i, 0]
        if dev not in whole:
            whole[dev] = (xp.to(dev), validp.to(dev))
        x_all, v_all = whole[dev]
        off = i * n_loc
        shards.append(_QueryShard(x_all[off:off + n_loc], v_all[off:off + n_loc], x_all, v_all, off))
    sweep = dict(block_q=block_q, block_i=block_i, dot=dot)

    core_loc = []
    for sh in shards:
        counts = _eps_neighbor_counts(sh.xq, sh.vq, eps_sq.to(sh.xq.device), x_items=sh.x_all,
                                      valid_items=sh.v_all, **sweep)
        core_loc.append((counts >= min_pts) & sh.vq)
    core = _gather(core_loc, first)

    def neighbour_labels(labels):
        return [_min_core_neighbor_label(sh.xq, sh.vq, core.to(sh.xq.device), labels.to(sh.xq.device),
                                         eps_sq.to(sh.xq.device), x_items=sh.x_all, valid_items=sh.v_all,
                                         **sweep)
                for sh in shards]

    labels = torch.where(core, torch.arange(n_tot, dtype=torch.int32, device=first), _INT_MAX)
    sweeps = 0
    changed = True
    while changed:
        new = []
        for sh, c_loc, neigh in zip(shards, core_loc, neighbour_labels(labels)):
            lab_loc = labels[sh.offset:sh.offset + n_loc].to(neigh.device)
            new.append(torch.where(c_loc, torch.minimum(lab_loc, neigh), lab_loc))
        jumped = _compress_labels(_gather(new, first), core, n_tot)
        changed = bool(torch.any(jumped != labels))
        labels = jumped
        sweeps += 1

    out = []
    for sh, c_loc, neigh in zip(shards, core_loc, neighbour_labels(labels)):
        lab_loc = labels[sh.offset:sh.offset + n_loc].to(neigh.device)
        border = ~c_loc & (neigh < _INT_MAX) & sh.vq
        lab_loc = torch.where(border, neigh, lab_loc)
        lab_loc = torch.where(lab_loc == _INT_MAX, -1, lab_loc)
        out.append(torch.where(sh.vq, lab_loc, -1))
    labels, core = _gather(out, first)[:n], core[:n]
    if return_sweeps:
        return labels, core, sweeps
    return labels, core


__all__ = ["core_point_mask", "dbscan_labels", "dbscan_labels_sharded", "relabel_consecutive"]
