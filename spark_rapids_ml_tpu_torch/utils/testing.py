"""Helpers for holding the port against the reference on the same inputs.

``seeded_matrix`` makes the inputs with numpy from a seed, so both
packages see identical bytes; ``assert_close`` names what it compares and
the tolerance it was held to, so a failure reads as a parity report.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def seeded_matrix(
    n: int,
    d: int,
    seed: int = 0,
    *,
    scales: Optional[Sequence[float]] = None,
    offset: float = 0.0,
    dtype=np.float64,
) -> np.ndarray:
    """An (n, d) standard-normal matrix from ``numpy.random.default_rng(seed)``,
    columns multiplied by ``scales`` (default ones) and shifted by ``offset``."""
    x = np.random.default_rng(seed).standard_normal((n, d))
    if scales is not None:
        x = x * np.asarray(scales, dtype=np.float64)[None, :]
    return (x + offset).astype(dtype)


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch.Tensor, wherever it lives
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(name: str, got, want, rtol: float, atol: float = 0.0) -> None:
    """Elementwise ``|got - want| <= atol + rtol * |want|`` with a report
    naming ``name``, the worst element and the tolerance."""
    got_np = _host(got).astype(np.float64)
    want_np = _host(want).astype(np.float64)
    if got_np.shape != want_np.shape:
        raise AssertionError(f"{name}: shapes differ, {got_np.shape} vs {want_np.shape}")
    if got_np.size == 0:
        return
    err = np.abs(got_np - want_np)
    bound = atol + rtol * np.abs(want_np)
    if not np.all(err <= bound):
        i = np.unravel_index(np.argmax(err - bound), err.shape)
        raise AssertionError(
            f"{name}: max |err| {err.max():.3e}; at {tuple(int(v) for v in i)} "
            f"got {got_np[i]!r} want {want_np[i]!r} (rtol {rtol:.0e}, atol {atol:.0e})"
        )


__all__ = ["assert_close", "seeded_matrix"]
