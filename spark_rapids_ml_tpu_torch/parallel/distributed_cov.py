"""Covariance over a device mesh — port of the reference's
``parallel/distributed_cov.py``.

Both functions are per-shard masked sums followed by
:func:`~spark_rapids_ml_tpu_torch.parallel.collectives.psum_data`, the
reference's explicit-collective form (its ``shard_map`` + ``psum``), since
the port has no GSPMD array:

  - :func:`distributed_mean_and_covariance` gathers each data shard's
    columns and sums its full-width centred Gram over the data axis;
  - :func:`distributed_covariance_shard_map` keeps the reference's block
    form: each model position computes its (d, d/mp) column block of the
    Gram against its data shard's gathered centred rows.

Padded rows are skipped as a slice (a shard's pad rows are its last);
``weightCol`` weights multiply the centred rows, as the reference's mask
does. Both return ``(mean (d_pad,), cov (d_pad, d_pad))`` on the mesh's
first device, normalized by (count − 1); feature padding is zero and the
callers slice it off.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.collectives import all_gather_model, psum_data
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, ShardedRows


def _weights(x: ShardedRows, mask: Optional[List[torch.Tensor]], i: int) -> Optional[torch.Tensor]:
    if mask is not None:
        return mask[i][: x.valid[i]].to(x.dtype)
    w = x.local_weights(i)
    return None if w is None else w.to(x.dtype)


def _count(x: ShardedRows, mask: Optional[List[torch.Tensor]]) -> torch.Tensor:
    parts = []
    for i, n_i in enumerate(x.valid):
        w = _weights(x, mask, i)
        dev = x.masks[i].device
        parts.append(torch.sum(w) if w is not None else torch.tensor(float(n_i), dtype=x.dtype, device=dev))
    return psum_data(parts, x.mesh.first_device)


def _col_sum(rows: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.sum(rows if w is None else rows * w[:, None], dim=0)


def _weighted(b: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    return b if w is None else b * w[:, None]


def distributed_mean_and_covariance(
    x: ShardedRows, mask: Optional[List[torch.Tensor]] = None, mesh: Optional[Mesh] = None,
    precision: str = "highest", center: bool = True,
):
    """Mean and sample covariance of row-sharded ``x``. ``mask`` (one
    (rows_per,) tensor per data shard) overrides the masks ``x`` carries.
    ``center=False`` gives the second-moment matrix about zero; the mean
    returned is the true column mean either way."""
    dot = make_dot(precision)
    first = (mesh or x.mesh).first_device
    count = _count(x, mask)
    shards = [x.shard(i)[: x.valid[i]] for i in range(len(x.blocks))]
    weights = [_weights(x, mask, i) for i in range(len(shards))]
    mean = psum_data([_col_sum(s, w) for s, w in zip(shards, weights)], first) / count
    offset = mean if center else torch.zeros_like(mean)
    grams = []
    for s, w in zip(shards, weights):
        b = _weighted(s - offset.to(s.device), w)
        grams.append(dot(b.T, b))
    return mean, psum_data(grams, first) / (count - 1)


def distributed_covariance_shard_map(
    x: ShardedRows, mask: Optional[List[torch.Tensor]] = None, mesh: Optional[Mesh] = None,
    precision: str = "highest",
):
    """The block form: per-shard local Gram blocks summed over the data
    axis — the analogue of the reference's per-partition GEMM followed by
    ``RDD.reduce``. Model position ``j`` computes the (d_pad, cols_per)
    block ``b_fullᵀ · b_j`` of its data shard; the blocks are joined on
    the first device."""
    dot = make_dot(precision)
    grid = (mesh or x.mesh).grid
    dp, mp = grid.shape
    count = _count(x, mask)
    weights = [_weights(x, mask, i) for i in range(dp)]
    means = []
    for j in range(mp):
        sums = [_col_sum(x.blocks[i][j][: x.valid[i]], None if weights[i] is None else weights[i].to(grid[i, j]))
                for i in range(dp)]
        means.append(psum_data(sums, grid[0, j]) / count.to(grid[0, j]))
    centred = [
        [_weighted(x.blocks[i][j][: x.valid[i]] - means[j].to(grid[i, j]),
                   None if weights[i] is None else weights[i].to(grid[i, j])) for j in range(mp)]
        for i in range(dp)
    ]
    blocks = []
    for j in range(mp):
        parts = []
        for i in range(dp):
            b_full = all_gather_model(centred[i]).to(grid[i, j])
            parts.append(dot(b_full.T, centred[i][j]))
        blocks.append(psum_data(parts, grid[0, j]))
    first = grid[0, 0]
    mean = torch.cat([m.to(first) for m in means])
    cov = torch.cat([b.to(first) for b in blocks], dim=1) / (count - 1)
    return mean, cov
