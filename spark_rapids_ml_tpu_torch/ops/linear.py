"""Linear model ops — port of the reference's ``ops/linear.py``.

The sufficient statistics (XᵀX, Xᵀy, column sums, Σy, Σy², n) are plain
products through the precision chokepoint (cuBLAS on the card), as the
reference leaves them to XLA outside any Pallas kernel; every solver
consumes only these O(d²) moments.

Solve semantics follow Spark ML's "normal" solver (WeightedLeastSquares):
    minimize 1/(2n) ||y − X b − b0||² + regParam · penalty(b)
with the L2 penalty on the coefficients of STANDARDIZED features when
``standardization`` is on, i.e. in original space
    (Xcᵀ Xc + n · regParam · diag(σ²)) b = Xcᵀ yc
and intercept b0 = mean(y) − mean(x)ᵀ b.

Where the reference's jitted programs keep control flow on the device,
the port reads a scalar back: :func:`solve_normal` reads once whether the
Cholesky solve is finite (the reference computes both branches and
selects), and :func:`solve_elastic_net`'s FISTA loop reads its stopping
test once an iteration. :func:`solve_elastic_net_resumable` is the
checkpointed FISTA: it and :func:`solve_elastic_net` run the same
:func:`_enet_segment`, so they agree bitwise. Each streamed block of
:func:`normal_eq_stats_streaming` is a ``solver.segment`` fault site.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.serving import prefetch_blocks, upload_block
from spark_rapids_ml_tpu_torch.ops.eigh import _eigh
from spark_rapids_ml_tpu_torch.observability.costs import ledgered_call
from spark_rapids_ml_tpu_torch.ops.linalg import soft_threshold
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.collectives import psum_data
from spark_rapids_ml_tpu_torch.parallel.mesh import ShardedRows
from spark_rapids_ml_tpu_torch.robustness.checkpoint import replicate_state_onto_mesh, segment_boundary
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def normal_eq_stats(
    x: Any, y: Any, mask: Optional[torch.Tensor] = None, precision: str = "highest"
) -> Stats:
    """Masked sufficient statistics in one pass: ``(xtx, xty, x_sum, y_sum,
    yty, count)``, raw (uncentered) moments; centering happens in the
    solver, where it is O(d²).

    ``mask=None`` means every row is real with weight 1 and skips the
    masking multiplies: at small d the statistics are bytes-bound and an
    x·mask pass would double the traffic.

    Over a mesh ``x`` is a ``ShardedRows`` and ``y`` its per-shard labels:
    each data shard's statistics of its real rows (at the true width, its
    weights as the mask), summed over the data axis by ``psum_data``; the
    solvers need no collective after that."""
    if isinstance(x, ShardedRows):
        per_shard = [
            normal_eq_stats(x.local_rows(i), y[i][: x.valid[i]],
                            None if x.local_weights(i) is None else x.local_weights(i).to(x.dtype),
                            precision=precision)
            for i in range(len(x.blocks))
        ]
        return tuple(psum_data(list(parts), x.mesh.first_device) for parts in zip(*per_shard))
    dot = make_dot(precision)
    if mask is None:
        n = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
        return (dot(x.T, x), dot(x.T, y), torch.sum(x, dim=0), torch.sum(y), torch.sum(y * y), n)
    xm = x * mask[:, None]
    ym = y * mask
    return (dot(xm.T, x), dot(xm.T, y), torch.sum(xm, dim=0), torch.sum(ym), torch.sum(ym * y), torch.sum(mask))


def _centered_moments(xtx, xty, x_sum, y_sum, count, fit_intercept: bool, standardization: bool):
    """The shared pre-solve reduction: ``(a, b, x_mean, y_mean, var)`` —
    centered Gram and cross moments, the means, and the per-feature
    variance that weights the standardized penalty (σ² is the true
    feature variance in both intercept modes, as in Spark)."""
    n = count
    x_mean = x_sum / n
    y_mean = y_sum / n
    if fit_intercept:
        a = xtx - n * torch.outer(x_mean, x_mean)
        b = xty - n * x_mean * y_mean
    else:
        a, b = xtx, xty
    if standardization:
        var = torch.clamp((torch.diagonal(xtx) - n * x_mean * x_mean) / torch.clamp(n - 1, min=1), min=0.0)
    else:
        var = torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
    return a, b, x_mean, y_mean, var


def _intercept(fit_intercept: bool, y_mean, x_mean, coef) -> torch.Tensor:
    if fit_intercept:
        return y_mean - torch.dot(x_mean, coef)
    return torch.zeros((), dtype=coef.dtype, device=coef.device)


def solve_normal(
    xtx, xty, x_sum, y_sum, count,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    standardization: bool = True,
):
    """Solve the (regularized) normal equations from raw moments:
    ``(coefficients (d,), intercept)``. Cholesky, kept only when every
    coefficient is finite; otherwise the eigh minimum-norm pseudo-solve
    with ``tol = max|w| · d · eps`` — the reference's criterion. A failed
    factor is NaN (``cholesky_ex``, as ``jnp.linalg.cholesky`` gives), so
    the same test picks the same branch."""
    n = count
    a, b, x_mean, y_mean, penalty = _centered_moments(
        xtx, xty, x_sum, y_sum, count, fit_intercept, standardization
    )
    d = a.shape[0]
    a_reg = a + (n * reg_param) * torch.diag(penalty)
    lo, info = torch.linalg.cholesky_ex(a_reg)
    lo = torch.where(info == 0, lo, float("nan"))
    coef = torch.cholesky_solve(b[:, None], lo)[:, 0]
    if not bool(torch.isfinite(coef).all()):
        w, v = _eigh(a_reg)
        tol = torch.max(torch.abs(w)) * d * torch.finfo(a.dtype).eps
        w_inv = torch.where(w > tol, 1.0 / w, 0.0)
        coef = v @ (w_inv * (v.T @ b))
    return coef, _intercept(fit_intercept, y_mean, x_mean, coef)


def predict_linear(x: torch.Tensor, coef: torch.Tensor, intercept, precision: str = "highest") -> torch.Tensor:
    return make_dot(precision)(x, coef) + intercept


def regression_metrics(y: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor):
    """``(mse, rmse, mae, r2)`` over the unmasked rows."""
    n = torch.sum(mask)
    resid = (y - pred) * mask
    sse = torch.sum(resid * resid)
    mse = sse / n
    mae = torch.sum(torch.abs(resid)) / n
    y_mean = torch.sum(y * mask) / n
    sst = torch.sum(((y - y_mean) * mask) ** 2)
    r2 = 1.0 - sse / torch.where(sst > 0, sst, torch.ones_like(sst))
    return mse, torch.sqrt(mse), mae, r2


def _enet_prep(xtx, xty, x_sum, y_sum, count, reg_param: float, elastic_net_param: float,
               fit_intercept: bool, standardization: bool):
    """:func:`solve_elastic_net`'s reduction before the loop, shared by
    every segment of a resumable solve: ``(a_quad, b_lin, lip, thresh,
    x_mean, y_mean)``, the quadratic form, its Lipschitz constant (the
    largest eigenvalue) and the soft-threshold levels.

    The form and everything the loop carries are float64 whatever the
    rows' dtype: the stopping rule ``max|c_new − c| ≤ tol`` (1e-7 by
    default) is below a float32 step of a coefficient of magnitude ≥ 1
    (1.19e-7), so float32 iterates would meet it only by standing still.
    On float64 moments the casts are no-ops and the solve is the
    reference's; ``x_mean`` and ``y_mean`` keep the fit's dtype."""
    n = count
    a, b, x_mean, y_mean, w2 = _centered_moments(
        xtx, xty, x_sum, y_sum, count, fit_intercept, standardization
    )
    d = a.shape[0]
    w1 = torch.sqrt(w2) if standardization else torch.ones(d, dtype=a.dtype, device=a.device)
    alpha = elastic_net_param
    a_quad = (a / n + reg_param * (1.0 - alpha) * torch.diag(w2)).to(torch.float64)
    b_lin = (b / n).to(torch.float64)
    l1 = (reg_param * alpha * w1).to(torch.float64)
    lip = torch.clamp(torch.max(torch.linalg.eigvalsh(a_quad)), min=1e-12)
    return a_quad, b_lin, lip, l1 / lip, x_mean, y_mean


def _enet_init(a_quad: torch.Tensor, init_coef) -> tuple:
    """The carry before the first iteration, ``(coef, z, t, it, delta)``:
    zeros, or a warm start from an original-space solution with the
    momentum restarted there."""
    d = a_quad.shape[0]
    if init_coef is None:
        c = torch.zeros(d, dtype=a_quad.dtype, device=a_quad.device)
    else:
        c = torch.tensor(np.asarray(init_coef, dtype=np.float64)).to(dtype=a_quad.dtype, device=a_quad.device)
    return c, c, 1.0, 0, float("inf")


def _enet_iteration_cost(d: int, item: int) -> dict:
    """The counted work of one FISTA iteration: the (d, d) · (d,) product
    of the gradient (2·d² operations) and the O(d) update; A read once,
    b, z and c read and the new c and z written."""
    return {"flops": float(2 * d * d + 8 * d), "transcendentals": 0.0,
            "bytes_accessed": float((d * d + 5 * d) * item)}


def _enet_segment(a_quad, b_lin, lip, thresh, tol: float, c, z, t: float, it: int, delta: float,
                  max_iter: int, every: int):
    """Up to ``every`` FISTA iterations from an explicit carry ``(coef, z,
    t, it, delta)``: :func:`solve_elastic_net`'s body and stopping rule
    with a segment budget. ``t`` and ``delta`` live on the host (one
    readback an iteration)."""
    seg = 0
    while seg < every and it < max_iter and delta > tol:
        grad = a_quad @ z - b_lin
        c_new = soft_threshold(z - grad / lip, thresh)
        t_new = (1.0 + float(np.sqrt(1.0 + 4.0 * t * t))) / 2.0
        z = c_new + ((t - 1.0) / t_new) * (c_new - c)
        delta = float(torch.max(torch.abs(c_new - c)))
        c, t, it, seg = c_new, t_new, it + 1, seg + 1
        bump_counter("linear.fista.iterations")
    return c, z, t, it, delta


def solve_elastic_net(
    xtx, xty, x_sum, y_sum, count,
    reg_param: float,
    elastic_net_param: float,
    fit_intercept: bool = True,
    standardization: bool = True,
    max_iter: int = 2000,
    tol: float = 1e-7,
    init_coef=None,
):
    """Elastic-net least squares from the same sufficient statistics:

        minimize 1/(2n)||y − Xb − b0||²
                 + regParam · (α Σ w1_j |b_j| + (1 − α)/2 Σ w2_j b_j²)

    with w1 = σ, w2 = σ² under standardization, 1 otherwise; FISTA on the
    quadratic moment form (gradient (A b − B)/n), whose iterations are
    O(d²) and never touch the rows. ``init_coef`` warm-starts from an
    original-space solution with the momentum restarted there. Returns
    ``(coefficients, intercept, n_iter)``; the FISTA step count ``t``
    lives on the host in float64."""
    a_quad, b_lin, lip, thresh, x_mean, y_mean = _enet_prep(
        xtx, xty, x_sum, y_sum, count, reg_param, elastic_net_param, fit_intercept, standardization
    )
    c, z, t, it, delta = _enet_init(a_quad, init_coef)
    c, _, _, it, _ = _enet_segment(a_quad, b_lin, lip, thresh, tol, c, z, t, it, delta, max_iter, max_iter)
    c = c.to(xtx.dtype)
    return c, _intercept(fit_intercept, y_mean, x_mean, c), it


def solve_elastic_net_resumable(
    xtx, xty, x_sum, y_sum, count,
    reg_param: float,
    elastic_net_param: float,
    checkpointer,
    fit_intercept: bool = True,
    standardization: bool = True,
    max_iter: int = 2000,
    tol: float = 1e-7,
    init_coef=None,
    mesh=None,
):
    """Preemption-tolerant :func:`solve_elastic_net`: a host loop of FISTA
    segments of ``checkpointer.every`` iterations, the carry ``(coef, z, t,
    it, delta)`` snapshotted after each, the solve resumed mid-way from
    the newest valid snapshot. The same returns, bitwise; ``mesh`` places
    a restored carry."""
    a_quad, b_lin, lip, thresh, x_mean, y_mean = _enet_prep(
        xtx, xty, x_sum, y_sum, count, reg_param, elastic_net_param, fit_intercept, standardization
    )
    c, z, t, it, delta = _enet_init(a_quad, init_coef)
    restored = checkpointer.restore_latest(
        template=(c, z, np.float64(t), np.int64(it), np.float64(delta)))
    if restored is not None:
        _, state = restored
        if mesh is not None:
            state = replicate_state_onto_mesh(state, mesh)
        c, z, t, it, delta = state[0], state[1], float(state[2]), int(state[3]), float(state[4])
    d = int(a_quad.shape[0])
    while it < max_iter and delta > tol:
        with TraceRange("segment linear.enet", TraceColor.PURPLE):
            fault_point("solver.segment")
            start = it
            c, z, t, it, delta = ledgered_call(
                _enet_segment, (a_quad, b_lin, lip, thresh, tol, c, z, t, it, delta),
                static=dict(max_iter=max_iter, every=checkpointer.every),
                name="linear.enet.segment", cost=lambda: _enet_iteration_cost(d, a_quad.element_size()),
            )
            bump_counter("checkpoint.segments")
            bump_counter("checkpoint.solver_iters", it - start)
        checkpointer.save_async(it, (c, z, np.float64(t), np.int64(it), np.float64(delta)))
        segment_boundary(checkpointer)
    checkpointer.finalize_success()
    c = c.to(xtx.dtype)
    return c, _intercept(fit_intercept, y_mean, x_mean, c), it


def solve_normal_host(
    xtx, xty, x_sum, y_sum, count,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    standardization: bool = True,
):
    """Host float64 twin of :func:`solve_normal`, in numpy/LAPACK: the
    ``dd`` route's solve (the reference's driver-side breeze/LAPACK
    position). Takes host arrays or tensors."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v

    xtx = np.asarray(host(xtx), dtype=np.float64)
    xty = np.asarray(host(xty), dtype=np.float64)
    x_sum = np.asarray(host(x_sum), dtype=np.float64)
    n = float(host(count))
    x_mean = x_sum / n
    y_mean = float(host(y_sum)) / n
    if fit_intercept:
        a = xtx - n * np.outer(x_mean, x_mean)
        b = xty - n * x_mean * y_mean
    else:
        a, b = xtx, xty
    if standardization:
        var = np.maximum((np.diag(xtx) - n * x_mean * x_mean) / max(n - 1.0, 1.0), 0.0)
    else:
        var = np.ones(a.shape[0], dtype=np.float64)
    a_reg = a + (n * reg_param) * np.diag(var)
    try:
        coef = np.linalg.solve(a_reg, b)
        if not np.all(np.isfinite(coef)):
            raise np.linalg.LinAlgError
    except np.linalg.LinAlgError:
        w, v = np.linalg.eigh(a_reg)
        tol = np.max(np.abs(w)) * a.shape[0] * np.finfo(np.float64).eps
        w_inv = np.where(w > tol, 1.0 / np.where(w > tol, w, 1.0), 0.0)
        coef = v @ (w_inv * (v.T @ b))
    intercept = (y_mean - float(np.dot(x_mean, coef))) if fit_intercept else 0.0
    return coef, intercept


def normal_eq_stats_streaming(
    block_pairs: Iterable,
    dtype: torch.dtype = torch.float64,
    precision: str = "highest",
) -> Stats:
    """The statistics of :func:`normal_eq_stats` accumulated over an
    iterable of ``(X, y)`` host blocks, one block on the platform's device
    at a time, in ``dtype`` (float64: the reference's
    x64 behaviour). A float32 block crosses as float32 and widens on the
    device, to the same values. Empty blocks are skipped; blocks of
    another width, or whose ``y`` has another length, raise."""
    dev = _device.resolve_device()

    def _upload(pair):
        xb, yb = pair
        if getattr(xb, "shape", (1,))[0] == 0:
            return None  # an empty partition densifies to (0, 0): no width
        _, xj = upload_block(xb, dev)
        yj = torch.from_numpy(np.ascontiguousarray(np.asarray(yb, dtype=np.float64).ravel())).to(dev)
        return xj.to(dtype), yj.to(dtype)

    acc = None
    d = None
    for pair in prefetch_blocks(block_pairs, _upload):
        if pair is None:
            continue
        xj, yj = pair
        fault_point("solver.segment")
        if d is None:
            d = xj.shape[1]
        elif xj.shape[1] != d:
            raise ValueError(f"inconsistent feature dims across blocks: {xj.shape[1]} vs {d}")
        if xj.shape[0] != yj.shape[0]:
            raise ValueError(f"block rows mismatch: X has {xj.shape[0]}, y has {yj.shape[0]}")
        stats = normal_eq_stats(xj, yj, None, precision=precision)
        acc = stats if acc is None else tuple(a + s for a, s in zip(acc, stats))
    if acc is None:
        raise ValueError("no blocks to accumulate")
    return acc
