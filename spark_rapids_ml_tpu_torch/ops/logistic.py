"""Logistic regression ops — port of the reference's ``ops/logistic.py``.

Objective (Spark semantics):
    (1/n) Σ_i logloss_i + regParam · (α ||w||₁ + (1 − α)/2 ||w||²)
with the penalty on the coefficients of STANDARDIZED features when
``standardization`` is on (optimize in scaled space, map back), the
intercept never penalized. α = 0 runs L-BFGS (:func:`fit_logistic`, the
port's ``ops/lbfgs.py`` in place of ``optax.lbfgs``); α > 0 runs FISTA
(:func:`fit_logistic_elastic_net`). Multinomial is the over-parameterized
softmax; at regParam = 0 the class axis is mean-centered for
identifiability, as Spark does.

The fused objective (``fused=True``, the default) is a
``torch.autograd.Function``: its forward computes the value AND the
analytic gradient, Xsᵀ(p − y) and the logloss sum, in one sweep over row
blocks of :data:`FUSED_BLOCK_ROWS`; its backward scales the saved gradient
by the incoming one. The sweep folds the standardization into the
weights instead of materializing Xs = (X − μ)/σ: logits are X·(w/σ) plus
the shifted intercept b − μ·(w/σ), and the gradient is
(Xᵀdz − μ ⊗ Σdz)/σ — two reads of X an evaluation and no (n, d)
temporary, where the reference's blocked form writes and reads the
standardized block (only the order of summation changes). ``fused=False``
is autograd over the plain loss. softplus is ``logaddexp(z, 0)``, exact
as ``jax.nn.softplus`` is (torch's ``softplus`` switches to the identity
above 20).

x64: the reference routes on ``jax_enable_x64``, and tier-1 runs it with
x64 on; the port always has float64, so it follows the x64-on behaviour —
:func:`fit_logistic_streaming` computes in float64 by default, and host
inputs fit in float64 (``models/logistic_regression.py``).

Random start: the elastic net's power iteration starts from ``v0``, drawn
in the reference by ``jax.random.normal(key(0), (d,))``. Threefry cannot
be drawn in torch, so ``v0`` is an argument; its default is a float64
draw from a CPU ``torch.Generator`` seeded 0, rounded to the compute dtype
(:func:`default_start_vector`). The tests pass JAX's draw.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.serving import prefetch_blocks, upload_block
from spark_rapids_ml_tpu_torch.observability.costs import ledgered_call
from spark_rapids_ml_tpu_torch.ops import lbfgs
from spark_rapids_ml_tpu_torch.ops.linalg import soft_threshold
from spark_rapids_ml_tpu_torch.ops.precision import make_dot
from spark_rapids_ml_tpu_torch.parallel.collectives import psum_data
from spark_rapids_ml_tpu_torch.parallel.mesh import ShardedRows
from spark_rapids_ml_tpu_torch.robustness.checkpoint import segment_boundary
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter


class LogisticFit(NamedTuple):
    """Result of the fits: tensors where the data lives (numpy from the
    streaming fit)."""

    weights: torch.Tensor  # (d, c) coefficients in ORIGINAL feature space
    intercepts: torch.Tensor  # (c,)
    n_iter: int
    loss: torch.Tensor  # final objective value (standardized space)


#: Rows per block of the fused objective's sweep; a block's temporaries
#: are (block, c) vectors. ``chip_smoke.py`` times the sweep at several
#: blocks beside the reference's standardized 65,536-row blocks
#: (``PERF.md`` §6).
FUSED_BLOCK_ROWS = 1 << 22


def softplus(z: torch.Tensor) -> torch.Tensor:
    """log(1 + eᶻ), exact at every z (``jax.nn.softplus``)."""
    return torch.logaddexp(z, z.new_zeros(()))


def _targets(y: torch.Tensor, c: int, dtype: torch.dtype) -> torch.Tensor:
    """(n,) 0/1 for the sigmoid column, (n, c) one-hot for softmax. Labels
    were validated to lie in [0, numClasses) before they reach here."""
    if c == 1:
        return (y == 1).to(dtype)
    return F.one_hot(y.to(torch.int64), c).to(dtype)


def _loss_and_dz(logits, yb, mb, c: int):
    """Weighted log-loss sum of a block and its dL/dlogits."""
    if c == 1:
        z = logits[:, 0]
        per_row = softplus(z) - yb * z
        dz = ((torch.sigmoid(z) - yb) * mb)[:, None]
    else:
        logp = torch.log_softmax(logits, dim=1)
        per_row = -torch.sum(yb * logp, dim=1)
        dz = (torch.exp(logp) - yb) * mb[:, None]
    return torch.sum(per_row * mb), dz


def _block_terms(xb, yb, mb, w, b, offset, scale, c: int, fit_intercept: bool, dot):
    """One row block's (weighted loss sum, unnormalized dL/dw, dL/db) in
    the reference's form: the block standardized first."""
    xs = (xb - offset) / scale
    logits = dot(xs, w)
    if fit_intercept:
        logits = logits + b
    loss, dz = _loss_and_dz(logits, yb, mb, c)
    return loss, dot(xs.T, dz), torch.sum(dz, dim=0)


class _FusedLoss(torch.autograd.Function):
    """Forward: the value, with the gradient computed in the same sweep
    and saved; backward: the saved gradient scaled by the incoming one."""

    @staticmethod
    def forward(ctx, w, b, value_and_grad):
        value, (gw, gb) = value_and_grad(w, b)
        ctx.save_for_backward(gw, gb)
        return value

    @staticmethod
    def backward(ctx, ct):
        gw, gb = ctx.saved_tensors
        return gw * ct, gb * ct, None


class LogisticLoss:
    """The one home of the standardized-space objective, shared by the
    L-BFGS fit, the FISTA smooth part and the final value.

    ``loss(w, b)`` is a scalar tensor that autograd differentiates (through
    :class:`_FusedLoss` when fused). ``value_and_grad(w, b)`` gives value and
    gradient directly: in one blocked sweep when fused, by autograd
    otherwise.

    Over a mesh ``x``, ``y_target`` and ``mask`` are lists, one entry per
    data shard (its real rows): each shard's loss sum and gradient partials
    are taken where it lives and summed over the data axis, one
    ``psum_data`` per evaluation; unfused, each shard's partials come from
    autograd over its own sum."""

    def __init__(self, x, y_target, mask, offset, scale, n, reg_param, c, fit_intercept, dot,
                 fused: bool = True, block_rows: int = FUSED_BLOCK_ROWS):
        self.sharded = isinstance(x, list)
        self.parts = list(zip(x, y_target, mask)) if self.sharded else [(x, y_target, mask)]
        self.offset, self.scale, self.n = offset, scale, n
        self.reg_param, self.c, self.fit_intercept, self.dot = reg_param, c, fit_intercept, dot
        self.fused = fused
        self.block_rows = max(1, int(block_rows))

    def _part_loss_sum(self, part, w, b):
        """One shard's weighted log-loss sum with the block standardized."""
        x, y, m = part
        dev = x.device
        xs = (x - self.offset.to(dev)) / self.scale.to(dev)
        logits = self.dot(xs, w.to(dev))
        if self.fit_intercept:
            logits = logits + b.to(dev)
        if self.c == 1:
            z = logits[:, 0]
            per_row = softplus(z) - y * z
        else:
            per_row = -torch.sum(y * torch.log_softmax(logits, dim=1), dim=1)
        return torch.sum(per_row * m)

    def _plain(self, w, b):
        return self._part_loss_sum(self.parts[0], w, b) / self.n + 0.5 * self.reg_param * torch.sum(w * w)

    def _finish(self, loss_s, gw_s, gb_s, w, b):
        value = loss_s / self.n + 0.5 * self.reg_param * torch.sum(w * w)
        gw = gw_s / self.n + self.reg_param * w
        gb = gb_s / self.n if self.fit_intercept else torch.zeros_like(b)
        return value, (gw, gb.to(b.dtype))

    def _part_sweep(self, part, w_s, shift):
        """One shard's (loss sum, Xᵀdz, Σdz) in row blocks, in order; the
        last block is short (the reference slides it back and masks the
        overlap: the same rows, counted once)."""
        x, y, m = part
        dot = self.dot
        dev = x.device
        w_s, shift = w_s.to(dev), shift.to(dev)
        loss_s = gx_s = gb_s = None
        for start in range(0, x.shape[0], self.block_rows):
            xb = x[start:start + self.block_rows]
            loss, dz = _loss_and_dz(dot(xb, w_s) + shift, y[start:start + self.block_rows],
                                    m[start:start + self.block_rows], self.c)
            terms = (loss, dot(xb.T, dz), torch.sum(dz, dim=0))
            if loss_s is None:
                loss_s, gx_s, gb_s = terms
            else:
                loss_s, gx_s, gb_s = loss_s + terms[0], gx_s + terms[1], gb_s + terms[2]
        if loss_s is None:  # a shard without real rows
            loss_s = torch.zeros((), dtype=x.dtype, device=dev)
            gx_s = torch.zeros_like(w_s)
            gb_s = torch.zeros(w_s.shape[1], dtype=x.dtype, device=dev)
        return loss_s, gx_s, gb_s

    def _fused_value_and_grad(self, w, b):
        # The standardization folded into the weights (module docstring).
        w_s = w / self.scale[:, None]
        shift = -self.dot(self.offset, w_s)
        if self.fit_intercept:
            shift = shift + b
        sweeps = [self._part_sweep(part, w_s, shift) for part in self.parts]
        loss_s, gx_s, gb_s = (psum_data(list(t), w.device) for t in zip(*sweeps))
        gw_s = (gx_s - torch.outer(self.offset, gb_s)) / self.scale[:, None]
        return self._finish(loss_s, gw_s, gb_s, w, b)

    def _sharded_autograd_value_and_grad(self, w, b):
        """Unfused over a mesh: autograd of each shard's own sum, then one
        sum over the data axis of value and gradient."""
        partials = []
        for part in self.parts:
            v, (gw, gb) = _autograd_value_and_grad(lambda w_, b_: self._part_loss_sum(part, w_, b_), w, b)
            partials.append((v, gw, gb))
        loss_s, gw_s, gb_s = (psum_data(list(t), w.device) for t in zip(*partials))
        return self._finish(loss_s, gw_s, gb_s, w, b)

    def __call__(self, w, b):
        if self.fused:
            return _FusedLoss.apply(w, b, self._fused_value_and_grad)
        if self.sharded:
            return _FusedLoss.apply(w, b, self._sharded_autograd_value_and_grad)
        return self._plain(w, b)

    def value_and_grad(self, w, b):
        if self.fused:
            with torch.no_grad():
                return self._fused_value_and_grad(w, b)
        if self.sharded:
            return self._sharded_autograd_value_and_grad(w, b)
        return _autograd_value_and_grad(self._plain, w, b)


def _autograd_value_and_grad(fn, w, b):
    """``(value, (dw, db))`` of ``fn(w, b)`` by autograd; an input the
    objective does not use (the intercept without ``fitIntercept``) gets a
    zero gradient, as JAX gives."""
    w = w.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    with torch.enable_grad():
        value = fn(w, b)
        gw, gb = torch.autograd.grad(value, (w, b), allow_unused=True)
    if gb is None:
        gb = torch.zeros_like(b)
    return value.detach(), (gw, gb)


def _masked_feature_moments(x, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-feature mean and population stddev (Spark's scaler);
    the weights enter the variance linearly. ``x`` and ``mask`` may be
    lists of data shards: each sum is then taken per shard and summed over
    the data axis."""
    xs = x if isinstance(x, list) else [x]
    ms = [m.to(xi.dtype) for m, xi in zip(mask if isinstance(mask, list) else [mask], xs)]
    dev = xs[0].device
    n = psum_data([torch.sum(m) for m in ms], dev)
    mean = psum_data([torch.sum(xi * m[:, None], dim=0) for xi, m in zip(xs, ms)], dev) / n
    var = psum_data([torch.sum(((xi - mean.to(xi.device)) ** 2) * m[:, None], dim=0)
                     for xi, m in zip(xs, ms)], dev) / n
    return mean, torch.sqrt(var)


def _standardizer(x, mask, fit_intercept: bool, standardization: bool):
    """(offset, scale): centering only when an intercept absorbs it
    (Spark), scale 1 for a constant feature."""
    mean, sigma = _masked_feature_moments(x, mask)
    safe_sigma = torch.where(sigma > 0, sigma, torch.ones_like(sigma))
    if not standardization:
        return torch.zeros_like(mean), torch.ones_like(safe_sigma)
    return (mean if fit_intercept else torch.zeros_like(mean)), safe_sigma


def _shards(x, y, mask, dtype: Optional[torch.dtype] = None):
    """``(xs, ys, ms, d, dtype, device)``: a tensor fit as itself, or a
    ``ShardedRows`` fit as lists of its data shards' real rows (true
    width), labels and weights, computing on the mesh's first device."""
    if isinstance(x, ShardedRows):
        xs = [x.local_rows(i) for i in range(len(x.blocks))]
        ys = [yi[: x.valid[i]] for i, yi in enumerate(y)]
        ms = [torch.ones(xi.shape[0], dtype=xi.dtype, device=xi.device) if x.local_weights(i) is None
              else x.local_weights(i).to(xi.dtype) for i, xi in enumerate(xs)]
        return xs, ys, ms, x.d, xs[0].dtype, x.mesh.first_device
    return x, y, mask.to(x.dtype), x.shape[1], x.dtype, x.device


def _n_columns(n_classes: int, multinomial: bool) -> int:
    if n_classes < 2:
        raise ValueError(f"need at least 2 classes, got {n_classes}")
    return n_classes if (multinomial or n_classes > 2) else 1


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor or array-like as a tensor at ``dtype`` on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(np.asarray(a, dtype=np.float64))
    return a.to(dtype=dtype, device=device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float64).cpu().numpy()


def _logistic_prep(x, mask, fit_intercept: bool, standardization: bool):
    """The standardizer inputs of :func:`fit_logistic`, ``(offset, scale,
    n)``, computed once and shared by every segment of a resumable fit.
    ``x`` and ``mask`` may be lists of data shards."""
    dev = x[0].device if isinstance(x, list) else x.device
    n = psum_data([torch.sum(m) for m in mask], dev) if isinstance(mask, list) else torch.sum(mask)
    offset, scale = _standardizer(x, mask, fit_intercept, standardization)
    return offset, scale, n


class _LbfgsProblem(NamedTuple):
    """What the L-BFGS segments and the finalization share: the objective,
    the host start ``theta0``, the host callback (one readback an
    evaluation) and ``unpack``, which turns ``theta`` into ``(w, b)`` on
    the device. No field refers back to the tuple, so a finished fit's
    objective (and the rows it holds) is freed at once, not at a
    collection."""

    loss: "LogisticLoss"
    theta0: np.ndarray
    value_and_grad: Callable
    unpack: Callable
    offset: torch.Tensor
    scale: torch.Tensor
    c: int
    dot: Callable


def _lbfgs_problem(x, y, mask, n_classes, reg_param, fit_intercept, standardization, precision,
                   multinomial, init_w, init_b, fused) -> _LbfgsProblem:
    """:func:`fit_logistic`'s set-up: standardizer, targets, objective and
    the start (zeros, or an original-space warm start mapped into the
    standardized space)."""
    c = _n_columns(n_classes, multinomial)
    x, y, mask, d, dtype, dev = _shards(x, y, mask)
    dot = make_dot(precision)
    offset, scale, n = _logistic_prep(x, mask, fit_intercept, standardization)
    y_target = [_targets(yi, c, dtype) for yi in y] if isinstance(y, list) else _targets(y, c, dtype)
    loss = LogisticLoss(x, y_target, mask, offset, scale, n, reg_param, c, fit_intercept, dot,
                        fused=fused)

    if init_w is None:
        w0 = torch.zeros((d, c), dtype=dtype, device=dev)
        b0 = torch.zeros((c,), dtype=dtype, device=dev)
    else:
        # Inverse of the final back-map: w_std = w_orig · scale; the
        # intercept re-absorbs the centering offset.
        w_orig0 = _tensor(init_w, dtype, dev)
        w0 = w_orig0 * scale[:, None]
        if fit_intercept:
            b_orig0 = (_tensor(init_b, dtype, dev) if init_b is not None
                       else torch.zeros((c,), dtype=dtype, device=dev))
            b0 = b_orig0 + dot(offset, w_orig0)
        else:
            b0 = torch.zeros((c,), dtype=dtype, device=dev)

    def unpack(theta: np.ndarray):
        t = torch.from_numpy(theta).to(device=dev, dtype=dtype)
        return t[: d * c].reshape(d, c), t[d * c:]

    def value_and_grad(theta: np.ndarray):
        bump_counter("logistic.lbfgs.evaluations")
        w, b = unpack(theta)
        value, (gw, gb) = _autograd_value_and_grad(loss, w, b)
        out = _to_host(torch.cat([value.reshape(1), gw.reshape(-1), gb.reshape(-1)]))
        return float(out[0]), out[1:]

    theta0 = np.concatenate([_to_host(w0).ravel(), _to_host(b0)])
    return _LbfgsProblem(loss, theta0, value_and_grad, unpack, offset, scale, c, dot)


def _logistic_finalize(problem: _LbfgsProblem, theta: np.ndarray, reg_param: float, fit_intercept: bool,
                       fused: bool):
    """The tail after the solve: the identifiability pivot of an
    unregularized softmax, the back-map to the original feature space and
    the final objective. Returns ``(w_orig, b_orig, final_loss)``."""
    w, b = problem.unpack(theta)
    if problem.c > 1 and reg_param == 0.0:
        # Identifiability pivot for unregularized softmax (Spark's centering).
        w = w - torch.mean(w, dim=1, keepdim=True)
        b = b - torch.mean(b)
    w_orig = w / problem.scale[:, None]
    b_orig = b - problem.dot(problem.offset, w_orig) if fit_intercept else b
    with torch.no_grad():
        final_loss = problem.loss.value_and_grad(w, b)[0] if fused else problem.loss(w, b)
    return w_orig, b_orig, final_loss


def fit_logistic(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    n_classes: int,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    standardization: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    precision: str = "highest",
    multinomial: bool = False,
    init_w=None,
    init_b=None,
    fused: bool = True,
) -> LogisticFit:
    """Binomial (one sigmoid column) or multinomial (``n_classes``
    softmax columns, also at 2 classes when ``multinomial``) logistic
    regression by L-BFGS, where ``x`` lives.

    ``y``: (n,) integer labels in [0, n_classes); ``mask``: (n,) row
    weights. ``init_w`` (d, c) / ``init_b`` (c,) warm-start from an
    original-space solution (default zeros). Over a mesh ``x`` is a
    ``ShardedRows``, ``y`` its per-shard labels and ``mask`` unused (the
    weights ride in ``x``): each evaluation is one sum over the data axis
    of value and gradient, and the L-BFGS state stays on the host in
    float64, identical on every process of a gang."""
    problem = _lbfgs_problem(x, y, mask, n_classes, reg_param, fit_intercept, standardization, precision,
                             multinomial, init_w, init_b, fused)
    res = lbfgs.minimize(problem.value_and_grad, problem.theta0, max_iter=max_iter, tol=tol)
    w_orig, b_orig, final_loss = _logistic_finalize(problem, res.params, reg_param, fit_intercept, fused)
    return LogisticFit(w_orig, b_orig, res.n_iter, final_loss)


def _lbfgs_segment(x, value_and_grad, state, max_iter: int, tol: float, every: int):
    """One L-BFGS segment (``ops/lbfgs.run``); ``x`` only names the rows'
    shape in the cost ledger's entry."""
    return lbfgs.run(value_and_grad, state, max_iter, tol, every=every)


def _evaluation_cost(x, c: int) -> dict:
    """The counted work of one objective evaluation over the rows (one
    L-BFGS iteration's): the margins X·W and the gradient Xᵀ·R, 4·n·d·c
    operations, one exponential per margin; x read once (the fused
    sweep), the labels and row weights read once."""
    if isinstance(x, ShardedRows):
        n, d, item = int(x.n), int(x.d), x.blocks[0][0].element_size()
    else:
        parts = x if isinstance(x, list) else [x]
        n, d, item = sum(int(p.shape[0]) for p in parts), int(parts[0].shape[1]), parts[0].element_size()
    return {"flops": 4.0 * n * d * c, "transcendentals": float(n * c),
            "bytes_accessed": float((n * d + 2 * n) * item)}


def fit_logistic_resumable(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    checkpointer,
    n_classes: int,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    standardization: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    precision: str = "highest",
    multinomial: bool = False,
    init_w=None,
    init_b=None,
    fused: bool = True,
) -> LogisticFit:
    """Preemption-tolerant :func:`fit_logistic`: a host loop of L-BFGS
    segments of ``checkpointer.every`` iterations (``ops/lbfgs.run``), the
    optimizer state (:class:`~spark_rapids_ml_tpu_torch.ops.lbfgs.LbfgsState`,
    host float64) snapshotted after each, the fit resumed mid-solve from the
    newest valid snapshot. The same returns, bitwise. Over a mesh ``x`` is a
    ``ShardedRows`` as for :func:`fit_logistic`; the state lives on the
    host, so a restored one needs no placement (the reference's ``mesh=``)."""
    problem = _lbfgs_problem(x, y, mask, n_classes, reg_param, fit_intercept, standardization, precision,
                             multinomial, init_w, init_b, fused)
    state = lbfgs.init_state(problem.theta0)
    restored = checkpointer.restore_latest(template=tuple(state))
    if restored is not None:
        state = lbfgs.LbfgsState(*restored[1])
    while int(state.it) < max_iter and state.gnorm > tol:
        with TraceRange("segment logistic.lbfgs", TraceColor.PURPLE):
            fault_point("solver.segment")
            start = int(state.it)
            state = ledgered_call(
                _lbfgs_segment, (x, problem.value_and_grad, state, max_iter, tol),
                static=dict(every=checkpointer.every),
                name="logistic.lbfgs.segment", cost=lambda: _evaluation_cost(x, problem.c),
            )
            bump_counter("checkpoint.segments")
            bump_counter("checkpoint.solver_iters", int(state.it) - start)
        checkpointer.save_async(int(state.it), tuple(state))
        segment_boundary(checkpointer)
    w_orig, b_orig, final_loss = _logistic_finalize(problem, state.params, reg_param, fit_intercept, fused)
    checkpointer.finalize_success()
    return LogisticFit(w_orig, b_orig, int(state.it), final_loss)


def default_start_vector(d: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The elastic net's power-iteration start when none is given: a
    float64 normal draw from a CPU generator seeded 0, rounded to
    ``dtype``, so CPU and card fits, float32 and float64, share it."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    v = torch.randn(d, generator=gen, dtype=torch.float64)
    return v.to(dtype).to(device)


def fit_logistic_elastic_net(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    n_classes: int,
    reg_param: float,
    elastic_net_param: float,
    fit_intercept: bool = True,
    standardization: bool = True,
    max_iter: int = 500,
    tol: float = 1e-7,
    precision: str = "highest",
    multinomial: bool = False,
    fused: bool = True,
    v0: Optional[torch.Tensor] = None,
) -> LogisticFit:
    """Elastic-net logistic regression by FISTA (Spark reaches this case by
    OWL-QN): a gradient of the smooth part (log-loss + L2 at
    regParam·(1 − α)) an iteration, a soft-threshold prox on the
    coefficients (never the intercept), step 1/L with L from 30 power
    iterations on the standardized Gram started at ``v0`` (see the module
    docstring). One readback an iteration for the stopping test."""
    c = _n_columns(n_classes, multinomial)
    x, y, mask, d, dtype, dev = _shards(x, y, mask)
    dot = make_dot(precision)
    sharded = isinstance(x, list)
    n = psum_data([torch.sum(m) for m in mask], dev) if sharded else torch.sum(mask)
    offset, scale = _standardizer(x, mask, fit_intercept, standardization)
    y_target = [_targets(yi, c, dtype) for yi in y] if sharded else _targets(y, c, dtype)
    reg1 = reg_param * elastic_net_param
    reg2 = reg_param * (1.0 - elastic_net_param)

    # Spectral norm of the masked standardized design by power iteration:
    # L_data = λmax(Xsᵀ M Xs) · curvature / n, with the per-row logistic
    # curvature ≤ 1/4 (sigmoid) or ≤ 1/2 (softmax). Over a mesh each
    # product is a per-shard sum over the data axis.
    parts = list(zip(x, mask)) if sharded else [(x, mask)]
    xs = [((xi - offset.to(xi.device)) / scale.to(xi.device), mi) for xi, mi in parts]

    def gram_apply(v):
        return psum_data([dot(xi.T, dot(xi, v.to(xi.device)) * mi) for xi, mi in xs], dev)

    v = default_start_vector(d, dtype, dev) if v0 is None else _tensor(v0, dtype, dev)
    v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    for _ in range(30):
        u = gram_apply(v)
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
    lam_max = torch.linalg.norm(gram_apply(v))
    del xs
    curvature = 0.25 if c == 1 else 0.5
    # 1.1 safety margin: power iteration converges from below.
    lip = 1.1 * lam_max * curvature / n + reg2 + 1e-12

    # The smooth part IS the L-BFGS objective at regParam = reg2.
    smooth = LogisticLoss(x, y_target, mask, offset, scale, n, reg2, c, fit_intercept, dot, fused=fused)
    w = torch.zeros((d, c), dtype=dtype, device=dev)
    b = torch.zeros((c,), dtype=dtype, device=dev)
    zw, zb, t, it = w, b, 1.0, 0
    while it < max_iter:
        gw, gb = smooth.value_and_grad(zw, zb)[1]
        w_new = soft_threshold(zw - gw / lip, reg1 / lip)
        b_new = zb - gb / lip if fit_intercept else zb
        t_new = (1.0 + float(np.sqrt(1.0 + 4.0 * t * t))) / 2.0
        mom = (t - 1.0) / t_new
        zw = w_new + mom * (w_new - w)
        zb = b_new + mom * (b_new - b)
        delta = torch.maximum(torch.max(torch.abs(w_new - w)), torch.max(torch.abs(b_new - b)))
        w, b, t, it = w_new, b_new, t_new, it + 1
        bump_counter("logistic.fista.iterations")
        if not float(delta) > tol:
            break

    w_orig = w / scale[:, None]
    b_orig = b - dot(offset, w_orig) if fit_intercept else b
    with torch.no_grad():
        final_loss = smooth.value_and_grad(w, b)[0] + reg1 * torch.sum(torch.abs(w))
    return LogisticFit(w_orig, b_orig, it, final_loss)


def _stream_block_value_grad(xb, yb, w, b, offset, scale, c: int, fit_intercept: bool,
                             precision: str, fused: bool = True):
    """One block's UNnormalized loss sum and gradient (the driver divides
    by the global n and adds the L2 term once): one sweep when fused,
    autograd otherwise."""
    dot = make_dot(precision)
    y_t = _targets(yb, c, xb.dtype)
    ones = torch.ones(xb.shape[0], dtype=xb.dtype, device=xb.device)
    if fused:
        val, gw, gb = _block_terms(xb, y_t, ones, w, b, offset, scale, c, fit_intercept, dot)
        return val, gw, (gb if fit_intercept else torch.zeros_like(b))

    def f(w_, b_):
        xs = (xb - offset) / scale
        logits = dot(xs, w_)
        if fit_intercept:
            logits = logits + b_
        if c == 1:
            z = logits[:, 0]
            per_row = softplus(z) - y_t * z
        else:
            per_row = -torch.sum(y_t * torch.log_softmax(logits, dim=1), dim=1)
        return torch.sum(per_row)

    val, (gw, gb) = _autograd_value_and_grad(f, w, b)
    return val, gw, gb


def streaming_label_feature_stats(pairs):
    """One pass over ``(X_block, y_block)`` pairs on the host: the feature
    moments in float64 (n, mean, σ — the standardizer's inputs) and the
    labels' integrality and range. O(d) state."""
    n = 0
    s = ss = None
    y_max = -1
    y_int_ok = True
    for xb, yb in pairs:
        blk = np.asarray(xb, dtype=np.float64)
        yv = np.asarray(yb).ravel()
        if s is None:
            s = np.zeros(blk.shape[1])
            ss = np.zeros(blk.shape[1])
        s += blk.sum(axis=0)
        ss += (blk * blk).sum(axis=0)
        n += blk.shape[0]
        if yv.size:
            yi = yv.astype(np.int64)
            if not np.array_equal(yi, yv) or yi.min() < 0:
                y_int_ok = False
            y_max = max(y_max, int(yi.max()))
    if n == 0:
        raise ValueError("streaming source yielded no rows")
    mean = s / n
    sigma = np.sqrt(np.maximum(ss / n - mean * mean, 0.0))
    return n, mean, sigma, y_max, y_int_ok


def fit_logistic_streaming(
    pairs_factory: Callable,
    n_classes: int,
    n: int,
    mean: np.ndarray,
    sigma: np.ndarray,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    standardization: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    precision: str = "highest",
    multinomial: bool = False,
    dtype: torch.dtype = torch.float64,
    fused: bool = True,
) -> LogisticFit:
    """Multi-pass fit over a re-iterable ``(X_block, y_block)`` source at
    O(block + d·c) memory: scipy's L-BFGS-B drives the parameters on the
    host (as the reference does) and each evaluation streams the blocks
    through :func:`_stream_block_value_grad` on the platform's device,
    accumulating there, one readback a pass. float64 by default (the x64-on
    behaviour). Returns numpy weights and intercepts."""
    from scipy.optimize import minimize

    c = _n_columns(n_classes, multinomial)
    d = mean.shape[0]
    dev = _device.resolve_device()
    safe_sigma = np.where(sigma > 0, sigma, 1.0)
    if standardization:
        offset = mean if fit_intercept else np.zeros_like(mean)
        scale = safe_sigma
    else:
        offset = np.zeros_like(mean)
        scale = np.ones_like(safe_sigma)
    offset_t = torch.from_numpy(np.asarray(offset, dtype=np.float64)).to(device=dev, dtype=dtype)
    scale_t = torch.from_numpy(np.asarray(scale, dtype=np.float64)).to(device=dev, dtype=dtype)
    n_b = c if fit_intercept else 0

    def _upload(pair):
        xb, yb = pair
        _, xj = upload_block(xb, dev)
        yj = torch.from_numpy(np.asarray(yb).ravel().astype(np.int64)).to(dev)
        return xj.to(dtype), yj

    def fun_grad(theta):
        fault_point("solver.segment")
        bump_counter("logistic.stream.passes")
        w = theta[: d * c].reshape(d, c)
        b = theta[d * c:] if fit_intercept else np.zeros(c)
        wj = torch.from_numpy(np.ascontiguousarray(w)).to(device=dev, dtype=dtype)
        bj = torch.from_numpy(np.ascontiguousarray(b)).to(device=dev, dtype=dtype)
        acc = torch.zeros(1 + d * c + c, dtype=dtype, device=dev)
        for xj, yj in prefetch_blocks(pairs_factory(), _upload):
            v, gw, gb = _stream_block_value_grad(xj, yj, wj, bj, offset_t, scale_t, c, fit_intercept,
                                                 precision, fused)
            acc = acc + torch.cat([v.reshape(1), gw.reshape(-1), gb.reshape(-1)])
        host = _to_host(acc)
        val = float(host[0]) / n + 0.5 * reg_param * float(np.sum(w * w))
        out = [host[1:1 + d * c] / n + reg_param * w.ravel()]
        if fit_intercept:
            out.append(host[1 + d * c:] / n)
        return val, np.concatenate(out)

    res = minimize(
        fun_grad,
        np.zeros(d * c + n_b),
        jac=True,
        method="L-BFGS-B",
        options={"maxiter": max_iter, "gtol": tol, "ftol": 1e-14},
    )
    w = res.x[: d * c].reshape(d, c)
    b = res.x[d * c:] if fit_intercept else np.zeros(c)
    if c > 1 and reg_param == 0.0:
        w = w - w.mean(axis=1, keepdims=True)
        b = b - b.mean()
    w_orig = w / scale[:, None]
    b_orig = b - offset @ w_orig if fit_intercept else b
    return LogisticFit(w_orig, b_orig, int(res.nit), np.float64(res.fun))


def predict_logistic(x: torch.Tensor, weights: torch.Tensor, intercepts: torch.Tensor, n_classes: int,
                     precision: str = "highest"):
    """``(labels int32, probabilities (n, max(2, c)), raw margins)``."""
    logits = make_dot(precision)(x, weights) + intercepts
    if weights.shape[1] == 1:
        z = logits[:, 0]
        p1 = torch.sigmoid(z)
        probs = torch.stack([1.0 - p1, p1], dim=1)
        raw = torch.stack([-z, z], dim=1)
        labels = (p1 > 0.5).to(torch.int32)
    else:
        probs = torch.softmax(logits, dim=1)
        raw = logits
        labels = torch.argmax(logits, dim=1).to(torch.int32)
    return labels, probs, raw


def classification_metrics(y: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor):
    """``(accuracy, error_rate)`` over the unmasked rows."""
    n = torch.sum(mask)
    acc = torch.sum((y == pred).to(mask.dtype) * mask) / n
    return acc, 1.0 - acc
