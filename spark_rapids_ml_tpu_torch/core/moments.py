"""Shifted second-moment accumulator — numpy fields, picklable. Port of
the reference's ``core/moments.py`` (the port keeps its own copy).

The wire-format twin of the native C++ ``SprAccumulator``
(native/src/tpuml_host.cpp): same shifted-data algorithm (accumulate
Σ(x−K)(x−K)ᵀ about a per-accumulator shift K, re-base on merge), but as a
plain-numpy object that serializes across process boundaries — the
"treeAggregate zero value" of the Spark adapter, where partition-local
stats are computed on executors and merged by the combOp
(RapidsRowMatrix.scala:226-233). fp64 vectorized numpy; for the
in-process hot path prefer the native accumulator (Kahan-compensated C++).

A tensor block folds where it lives (the port's addition; the reference
casts every block to host float64): it is cast to float64 on its device,
its ``Σ(x−K)ᵀ(x−K)`` about the shift K is kernel K1's float64 route
(``ops/kernels/covariance.centered_gram_cuda`` with ``mean = K``; a CPU
tensor takes K1's plain version), ``Σ(x−K)`` is a float64 sum on the
device, and only the (d, d) and (d,) results come back to the numpy
fields. A CUDA block raises where K1 does not build.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class ShiftedMoments:
    """Streaming (count, Σs, ΣssT) about a shift K = first row seen."""

    __slots__ = ("n_cols", "n_rows", "shift", "sum", "gram")

    def __init__(self, n_cols: int):
        self.n_cols = int(n_cols)
        self.n_rows = 0
        self.shift: Optional[np.ndarray] = None
        self.sum = np.zeros(n_cols, dtype=np.float64)
        self.gram = np.zeros((n_cols, n_cols), dtype=np.float64)

    def add_block(self, block) -> "ShiftedMoments":
        if isinstance(block, torch.Tensor):
            return self._add_tensor(block)
        block = np.asarray(block, dtype=np.float64)
        if block.ndim != 2 or block.shape[1] != self.n_cols:
            raise ValueError(f"block must be (rows, {self.n_cols}), got {block.shape}")
        if block.shape[0] == 0:
            return self
        if self.shift is None:
            self.shift = block[0].copy()
        s = block - self.shift
        self.sum += s.sum(axis=0)
        self.gram += s.T @ s
        self.n_rows += block.shape[0]
        return self

    def _add_tensor(self, block: torch.Tensor) -> "ShiftedMoments":
        from spark_rapids_ml_tpu_torch.ops.kernels.covariance import centered_gram_cuda

        if block.dim() != 2 or block.shape[1] != self.n_cols:
            raise ValueError(f"block must be (rows, {self.n_cols}), got {tuple(block.shape)}")
        n = int(block.shape[0])
        if n == 0:
            return self
        x = block.detach().to(torch.float64).contiguous()
        shift = x[0].cpu().numpy().copy() if self.shift is None else self.shift
        k = torch.from_numpy(shift).to(x.device)
        gram = centered_gram_cuda(x, k).cpu().numpy()
        s = (x - k).sum(dim=0).cpu().numpy()
        # Committed only once the block has folded: a block that raises
        # leaves the moments as they were.
        self.shift = shift
        self.gram += gram
        self.sum += s
        self.n_rows += n
        return self

    def merge(self, other: "ShiftedMoments") -> "ShiftedMoments":
        if other.n_cols != self.n_cols:
            raise ValueError("column count mismatch")
        if other.n_rows == 0:
            return self
        if self.shift is None:
            self.shift = other.shift.copy() if other.shift is not None else None
        d = other.shift - self.shift
        nb = float(other.n_rows)
        self.gram += (
            other.gram
            + np.outer(d, other.sum)
            + np.outer(other.sum, d)
            + nb * np.outer(d, d)
        )
        self.sum += other.sum + nb * d
        self.n_rows += other.n_rows
        return self

    def finalize(self, center: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (covariance, mean); covariance normalized by (n−1). The
        fields may also be float64 tensors on one device (the gang merge,
        ``parallel/distributed.merge_moments``): the same arithmetic then
        runs there, as numpy's ``outer`` does it, and returns tensors."""
        m = self.n_rows
        if m < 2:
            raise ValueError(f"need at least 2 rows, got {m}")
        ms = self.sum / m
        mean = self.shift + ms
        if center:
            cov = (self.gram - m * _outer(ms, ms)) / (m - 1)
        else:
            raw = (
                self.gram
                + _outer(self.shift, self.sum)
                + _outer(self.sum, self.shift)
                + m * _outer(self.shift, self.shift)
            )
            cov = raw / (m - 1)
        return cov, mean


def _outer(a, b):
    """``np.outer(a, b)`` for numpy or torch vectors: numpy's own
    definition, ``a[:, None] * b[None, :]``."""
    return a[:, None] * b[None, :]
