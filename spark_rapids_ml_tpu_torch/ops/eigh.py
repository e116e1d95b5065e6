"""Symmetric eigendecomposition + SVD-from-covariance — port of the
reference's ``ops/eigh.py``.

``torch.linalg.eigh`` (cuSOLVER on the card, LAPACK on the CPU) stands in
for ``jnp.linalg.eigh``; the sign convention, the descending order, the
subspace solvers and their acceptance rule are the reference's, so
components compare elementwise.

A failed factorisation gives NaN, as in the reference, instead of an
exception: ``_cholqr`` uses ``cholesky_ex`` (no host check) and turns a
failed factor into NaN as ``jnp.linalg.cholesky`` does, so ``eigh_auto``'s
stagnation and acceptance tests see NaN and promote; and every dense
``eigh`` returns NaN for a non-finite input where ``torch.linalg.eigh``
would raise.

Two differences by design:
  - the start basis of the subspace solvers cannot be the reference's
    ``jax.random`` draw; it is drawn from a CPU ``torch.Generator`` seeded
    0 and moved to the device, so CPU and card agree. Every solver also
    takes a pinned ``q0`` (the tests pass the reference's own draw).
  - ``eigh_auto``'s ``lax.while_loop`` + ``lax.cond`` is a Python loop:
    each stagnation check and the final accept/promote decision read one
    scalar back to the host.

Each host sync sits in a counted ``HostSync`` (``utils/tracing.py``):
``sync.eigh.start_basis`` (the start basis's copy to the device),
``sync.eigh.auto.s_prev``, ``sync.eigh.auto.stagnation`` (one per
subspace iteration), ``sync.eigh.ritz`` and ``sync.eigh.full`` (a dense
``torch.linalg.eigh`` checks its ``info`` on the host: one per call) and
``sync.eigh.auto.accept``. ``eigh_auto`` also counts its decisions:
``eigh.auto.calls``, ``eigh.auto.iterations`` (subspace iterations run)
and ``eigh.auto.promoted`` (fell back to :func:`eigh_descending`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.utils.tracing import HostSync, bump_counter


def sign_flip(u: torch.Tensor) -> torch.Tensor:
    """Deterministic per-column sign convention: if the element with the
    largest |value| is negative, negate the column. ``torch.argmax``
    returns the first maximal index, as the reference's ``argmax`` does."""
    idx = torch.argmax(torch.abs(u), dim=0)
    pivot = u[idx, torch.arange(u.shape[1], device=u.device)]
    signs = torch.where(pivot < 0, -1.0, 1.0).to(u.dtype)
    return u * signs[None, :]


def _eigh(a: torch.Tensor):
    """``torch.linalg.eigh`` (ascending) that returns all-NaN pairs for an
    input holding a NaN or an infinity, as ``jnp.linalg.eigh`` does, where
    torch would raise. The test and the mask stay on the device."""
    bad = ~torch.isfinite(a).all()
    w, v = torch.linalg.eigh(torch.where(bad, 0.0, a))
    return torch.where(bad, float("nan"), w), torch.where(bad, float("nan"), v)


def eigh_descending(a: torch.Tensor):
    """Eigendecomposition of symmetric ``a``, eigenvalues descending,
    columns sign-flipped: ``(eigenvalues, eigenvectors)``."""
    with HostSync("eigh.full"):
        w, v = _eigh(a)  # ascending
    return torch.flip(w, (0,)), sign_flip(torch.flip(v, (1,)))


def _sign_flip_host(v: np.ndarray) -> np.ndarray:
    idx = np.argmax(np.abs(v), axis=0)
    pivot = v[idx, np.arange(v.shape[1])]
    return v * np.where(pivot < 0, -1.0, 1.0)[None, :]


def eigh_descending_host(a):
    """Host (numpy/LAPACK) twin of :func:`eigh_descending`, in float64."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    w, v = np.linalg.eigh(np.asarray(a, dtype=np.float64))
    return w[::-1], _sign_flip_host(v[:, ::-1])


#: "auto" treats eigenIters as a cap on its early-exiting loop, with this
#: quality floor (the reference's constant).
AUTO_MIN_ITERS = 12


def auto_max_iters(eigen_iters: int) -> int:
    return max(int(eigen_iters), AUTO_MIN_ITERS)


def _subspace_l(d: int, k: int) -> int:
    """Oversampled subspace width shared by the iterative solvers."""
    return min(d, max(2 * k, k + 8))


def _start_basis(d: int, l: int, dtype, device, q0=None) -> torch.Tensor:
    """Deterministic orthonormal start basis. ``q0`` pins the raw (d, l)
    draw; by default it comes from a CPU generator seeded 0, so the fitted
    model never depends on placement or call order."""
    if q0 is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        q0 = torch.randn((d, l), generator=gen, dtype=dtype)
    elif not isinstance(q0, torch.Tensor):
        q0 = torch.tensor(np.asarray(q0), dtype=dtype)  # a copy: numpy views may be read-only
    with HostSync("eigh.start_basis"):
        q0 = q0.to(device=device, dtype=dtype)
    if tuple(q0.shape) != (d, l):
        raise ValueError(f"q0 must have shape {(d, l)}, got {tuple(q0.shape)}")
    q, _ = torch.linalg.qr(q0)
    return q


def _cholqr(z: torch.Tensor):
    """CholeskyQR re-orthonormalization of a tall-skinny block:
    ``Q = Z · L⁻ᵀ`` with ``LLᵀ = ZᵀZ`` plus a relative jitter. Returns
    ``(q, tr(ZᵀZ))``. A Gram that is not positive definite (a zero or
    NaN block) gives an all-NaN factor, as ``jnp.linalg.cholesky`` does."""
    l = z.shape[1]
    g = z.T @ z
    s = torch.trace(g)
    eps = 1e-6 if z.dtype == torch.float32 else 1e-14
    eye = torch.eye(l, dtype=z.dtype, device=z.device)
    lo, info = torch.linalg.cholesky_ex(g + (eps * s / l) * eye)
    lo = torch.where(info == 0, lo, float("nan"))
    linv = torch.linalg.solve_triangular(lo, eye, upper=False)
    return z @ linv.T, s


def _rayleigh_ritz(a: torch.Tensor, q: torch.Tensor, k: int):
    """True QR, Rayleigh–Ritz, descending top-k with the sign flip."""
    q, _ = torch.linalg.qr(q)
    b = q.T @ (a @ q)
    with HostSync("eigh.ritz"):
        w, u = _eigh(b)  # ascending
    w = torch.flip(w, (0,))[:k]
    v = q @ torch.flip(u, (1,))[:, :k]
    return w, sign_flip(v)


def eigh_topk(a: torch.Tensor, k: int, iters: int = 8, q0=None):
    """Top-k eigenpairs of a symmetric PSD matrix by subspace iteration +
    Rayleigh–Ritz: ``(eigenvalues (k,), eigenvectors (d, k))``."""
    d = a.shape[0]
    q = _start_basis(d, _subspace_l(d, k), a.dtype, a.device, q0)
    for _ in range(iters):
        q, _ = _cholqr(a @ q)
    return _rayleigh_ritz(a, q, k)


def eigh_auto(
    a: torch.Tensor,
    k: int,
    max_iters: int = 16,
    cluster_tol: float = 0.05,
    q0: Optional[object] = None,
):
    """Self-selecting top-k eigensolver: subspace iteration that stops when
    its captured objective ``tr(QᵀA²Q)`` stagnates, then accepts the
    Rayleigh–Ritz pairs iff each is converged (residual ≤ vec_tol·w) or
    degenerate (local Ritz spacing ≤ residual ≤ cluster_tol·w), and
    otherwise promotes itself to :func:`eigh_descending` — the reference's
    rule, read for read.

    Returns ``(w (k,), v (d, k), promoted: bool)``."""
    bump_counter("eigh.auto.calls")
    d = a.shape[0]
    if k >= d:  # no subspace to iterate: the full solve is the answer
        bump_counter("eigh.auto.promoted")
        w, v = eigh_descending(a)
        return w[:k], v[:, :k], True
    l = _subspace_l(d, k)
    q = _start_basis(d, l, a.dtype, a.device, q0)
    f32 = a.dtype == torch.float32
    stag_tol = 1e-5 if f32 else 1e-11
    vec_tol = 1e-3 if f32 else 1e-8
    eps_abs = 1e-5 if f32 else 1e-12

    with HostSync("eigh.auto.s_prev"):
        s_prev = torch.tensor(float("-inf"), dtype=a.dtype, device=a.device)
    for _ in range(max_iters):
        q, s = _cholqr(a @ q)
        bump_counter("eigh.auto.iterations")
        with HostSync("eigh.auto.stagnation"):
            stagnated = bool(torch.abs(s - s_prev) <= stag_tol * s)
        s_prev = s
        if stagnated:
            break
    # Rayleigh–Ritz keeping all l Ritz values: the acceptance test needs
    # the kept components' neighbours to measure local spacing.
    q, _ = torch.linalg.qr(q)
    b = q.T @ (a @ q)
    with HostSync("eigh.ritz"):
        w_all, u = _eigh(b)
    w_all = torch.flip(w_all, (0,))
    w_k = w_all[:k]
    v_k = sign_flip(q @ torch.flip(u, (1,))[:, :k])
    resid = torch.linalg.norm(a @ v_k - v_k * w_k[None, :], dim=0)
    scale = eps_abs * w_all[0]
    inf = torch.full((1,), float("inf"), dtype=a.dtype, device=a.device)
    gap_right = w_k - w_all[1 : k + 1]
    gap_left = torch.cat([inf, w_all[: k - 1] - w_k[1:]]) if k > 1 else inf
    spacing = torch.minimum(gap_left, gap_right)
    converged = resid <= vec_tol * w_k + scale
    degenerate = (spacing <= resid) & (resid <= cluster_tol * w_k + scale)
    with HostSync("eigh.auto.accept"):
        accept = bool(torch.all(converged | degenerate))
    if accept:
        return w_k, v_k, False
    bump_counter("eigh.auto.promoted")
    w, v = eigh_descending(a)
    return w[:k], v[:, :k], True


def cal_svd(a: torch.Tensor):
    """SVD of a symmetric PSD matrix via eigendecomposition: ``(u, s)``
    with ``s = sqrt(max(eigenvalues, 0))`` descending."""
    w, v = eigh_descending(a)
    return v, torch.sqrt(torch.clamp(w, min=0))
