"""L-BFGS with a zoom line search — the port's counterpart of the
``optax.lbfgs()`` call that the reference's ``ops/logistic.py::fit_logistic``
makes.

The algorithm and constants are optax 0.2.6's defaults, so ``maxIter``
means what it means in the reference:

  - ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the
    two-loop recursion over a ring of the last 10 (Δparams, Δgrad) pairs;
    the identity scale is ⟨Δg, Δp⟩/|Δg|² after the first step and
    min(1, 1/|g|) at the first step; a pair with ⟨Δg, Δp⟩ = 0 is stored
    with weight 0 (a no-op in both loops);
  - ``scale(-1)``: the direction is −P·g;
  - ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one")``: slope_rtol 1e-4, curv_rtol 0.9,
    approx_dec_rtol 1e-6, stepsize_precision 1e-5, increase_factor 2,
    tol 0, no maximal step; the search doubles the step until an
    interval brackets a point, then zooms by cubic, quadratic or bisection
    steps; a failed search falls back to the safe step it kept.

The loop contract is the reference's (``ops/logistic.py:305-318``): stop
when ``it >= max_iter`` or when the global norm of the previous gradient is
``<= tol``, and reuse the value and gradient that the line search accepted
(``optax.value_and_grad_from_state``), so the port makes as many objective
evaluations as the reference.

The optimizer state is O(d·c) and lives on the host in float64 numpy, as
scipy's does in the reference's streaming fit; the objective callback
moves the parameters to the device, evaluates there, and returns value and
gradient in one readback. Each line-search trial is one evaluation and
one sync. :class:`LbfgsState` is that state as a flat tuple of host
arrays, and :func:`run` goes on from one for a bounded number of
iterations: the segments of the checkpointed logistic fit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
LINESEARCH_TOL = 0.0

ValueAndGrad = Callable[[np.ndarray], Tuple[float, np.ndarray]]


class LbfgsResult(NamedTuple):
    params: np.ndarray  # float64, the last iterate
    n_iter: int
    n_evals: int  # objective evaluations (the first one included)
    linesearch_steps: int  # trials over all iterations


def _f(v) -> np.float64:
    return np.float64(v)


def _error_or_inf(v: np.float64) -> np.float64:
    v = np.maximum(v, 0.0)
    return np.float64(np.inf) if np.isnan(v) else v


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init) -> np.float64:
    """The sufficient-decrease (Armijo) error, relaxed by the approximate
    Wolfe condition of Hager-Zhang as optax does."""
    decrease = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    approx = np.maximum(approx, delta_values)
    return _error_or_inf(np.minimum(approx, decrease))


def _curvature_error(slope_step, slope_init) -> np.float64:
    return _error_or_inf(np.abs(slope_step) - CURV_RTOL * np.abs(slope_init))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc)."""
    cc = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - cc * db
    r2 = fc - fa - cc * dc
    aa = (dc ** 2 * r1 + (-(db ** 2)) * r2) / denom
    bb = ((-(dc ** 3)) * r1 + db ** 3 * r2) / denom
    radical = bb * bb - 3.0 * aa * cc
    return a + (-bb + np.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa, fpa), (b, fb)."""
    db = b - a
    bb = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * bb)


class _Line:
    """The zoom line search's state (optax's ``ZoomLinesearchState``)."""

    def __init__(self, value, grad, slope):
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = _f(0.0), _f(value), grad, _f(slope)
        self.value_init, self.slope_init = _f(value), _f(slope)
        self.decrease_error = self.curvature_error = _f(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = _f(0.0), _f(value), _f(slope)
        self.high, self.value_high, self.slope_high = _f(0.0), _f(value), _f(slope)
        self.cubic_ref, self.value_cubic_ref = _f(0.0), _f(value)
        self.safe_stepsize, self.safe_value, self.safe_grad = _f(0.0), _f(value), grad


def _trial(value_and_grad: ValueAndGrad, params, stepsize, updates):
    value, grad = value_and_grad(params + stepsize * updates)
    return _f(value), grad, _f(np.dot(grad, updates))


def _search_interval(s: _Line, value_and_grad, params, updates) -> None:
    prev_step, prev_value, prev_slope = s.stepsize, s.value, s.slope
    new_step = _f(1.0) if s.count == 0 else INCREASE_FACTOR * prev_step
    value, grad, slope = _trial(value_and_grad, params, new_step, updates)
    dec = _decrease_error(new_step, value, slope, s.value_init, s.slope_init)
    curv = _curvature_error(slope, s.slope_init)
    error = np.maximum(dec, curv)
    if dec <= LINESEARCH_TOL:
        s.safe_stepsize, s.safe_value, s.safe_grad = new_step, value, grad
    set_high_to_new = bool(dec > 0.0) or (bool(value >= prev_value) and s.count > 0)
    set_low_to_new = bool(slope >= 0.0) and not set_high_to_new
    if set_low_to_new:
        s.low, s.value_low, s.slope_low = new_step, value, slope
        s.high, s.value_high, s.slope_high = prev_step, prev_value, prev_slope
    else:
        s.low, s.value_low, s.slope_low = prev_step, prev_value, prev_slope
        s.high, s.value_high, s.slope_high = new_step, value, slope
    s.interval_found = set_high_to_new or set_low_to_new or bool(error <= LINESEARCH_TOL)
    s.done = bool(error <= LINESEARCH_TOL)  # no maximal step: it is never reached
    s.failed = (s.count + 1 >= MAX_LINESEARCH_STEPS) and not s.done
    s.count += 1
    s.stepsize, s.value, s.grad, s.slope = new_step, value, grad, slope
    s.decrease_error, s.curvature_error = dec, curv
    s.cubic_ref, s.value_cubic_ref = s.low, s.value_low


def _zoom_into_interval(s: _Line, value_and_grad, params, updates) -> None:
    low, value_low, slope_low = s.low, s.value_low, s.slope_low
    high, value_high, slope_high = s.high, s.value_high, s.slope_high
    delta = np.abs(high - low)
    left, right = np.minimum(high, low), np.maximum(high, low)
    too_small_int = bool(delta <= STEPSIZE_PRECISION)
    middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high, s.cubic_ref, s.value_cubic_ref)
    use_cubic = bool(middle_cubic > left + 0.2 * delta) and bool(middle_cubic < right - 0.2 * delta)
    middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = not use_cubic and bool(middle_quad > left + 0.1 * delta) and bool(middle_quad < right - 0.1 * delta)
    if use_cubic:
        middle = middle_cubic
    elif use_quad:
        middle = middle_quad
    else:
        middle = (low + high) / 2.0
    value, grad, slope = _trial(value_and_grad, params, middle, updates)
    dec = _decrease_error(middle, value, slope, s.value_init, s.slope_init)
    curv = _curvature_error(slope, s.slope_init)
    error = np.maximum(dec, curv)
    if dec <= LINESEARCH_TOL and value < s.safe_value:
        s.safe_stepsize, s.safe_value, s.safe_grad = middle, value, grad
    s.done = bool(error <= LINESEARCH_TOL)
    set_high_to_middle = bool(dec > 0.0) or bool(value >= value_low)
    set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
    if set_high_to_middle:
        s.high, s.value_high, s.slope_high = middle, value, slope
    if set_high_to_low:
        s.high, s.value_high, s.slope_high = low, value_low, slope_low
    if not set_high_to_middle:
        s.low, s.value_low, s.slope_low = middle, value, slope
    if set_high_to_middle or set_high_to_low:
        s.cubic_ref, s.value_cubic_ref = high, value_high
    else:
        s.cubic_ref, s.value_cubic_ref = low, value_low
    presumably_failed = (s.count + 1 >= MAX_LINESEARCH_STEPS) or (too_small_int and bool(s.safe_stepsize > 0.0))
    s.failed = presumably_failed and not s.done
    s.count += 1
    s.stepsize, s.value, s.grad, s.slope = middle, value, grad, slope
    s.decrease_error, s.curvature_error = dec, curv


def zoom_linesearch(value_and_grad: ValueAndGrad, params, updates, value, grad):
    """One zoom line search from ``params`` along ``updates``: returns
    ``(stepsize, value, grad, trials)`` at the accepted point."""
    with np.errstate(all="ignore"):
        s = _Line(value, grad, np.dot(updates, grad))
        while not (s.done or s.failed):
            if s.interval_found:
                _zoom_into_interval(s, value_and_grad, params, updates)
            else:
                _search_interval(s, value_and_grad, params, updates)
            if s.failed and (bool(s.safe_stepsize > 0.0) or bool(np.isinf(s.decrease_error))):
                s.stepsize, s.value, s.grad = s.safe_stepsize, s.safe_value, s.safe_grad
    return s.stepsize, s.value, s.grad, s.count


class _Memory:
    """``scale_by_lbfgs``'s ring of (Δparams, Δgrad) pairs and weights."""

    def __init__(self, size: int, dim: int):
        self.count = 0
        self.params = np.zeros(dim)
        self.grad = np.zeros(dim)
        self.dparams = np.zeros((size, dim))
        self.dgrads = np.zeros((size, dim))
        self.rhos = np.zeros(size)

    def direction(self, grad: np.ndarray, params: np.ndarray) -> np.ndarray:
        """Record the newest pair and return −P·grad."""
        size = self.rhos.shape[0]
        idx = self.count % size
        prev = (self.count - 1) % size
        with np.errstate(all="ignore"):
            if self.count > 0:
                dp = params - self.params
                dg = grad - self.grad
                inner = np.dot(dg, dp)
                weight = 0.0 if inner == 0.0 else 1.0 / inner
                denom = np.dot(dg, dg)
                scale = inner / denom if denom > 0.0 else 1.0
            else:
                dp = dg = np.zeros_like(grad)
                weight = 0.0
                scale = np.minimum(1.0, 1.0 / np.sqrt(np.dot(grad, grad)))
            self.dparams[prev], self.dgrads[prev], self.rhos[prev] = dp, dg, weight
            order = [(idx + i) % size for i in range(size)]
            vec = grad.copy()
            alphas = {}
            for i in reversed(order):
                alphas[i] = self.rhos[i] * np.dot(self.dparams[i], vec)
                vec = vec - alphas[i] * self.dgrads[i]
            vec = scale * vec
            for i in order:
                beta = self.rhos[i] * np.dot(self.dgrads[i], vec)
                vec = vec + (alphas[i] - beta) * self.dparams[i]
        self.count += 1
        self.params, self.grad = params, grad
        return -vec


class LbfgsState(NamedTuple):
    """The whole optimizer state between iterations, as flat host float64
    arrays and int64 counts (a checkpoint snapshot's leaves). ``value`` is
    +inf before the first evaluation, which makes the next iteration
    evaluate the objective first, as an unevaluated start does."""

    params: np.ndarray
    value: np.float64
    grad: np.ndarray
    it: np.int64
    gnorm: np.float64
    n_evals: np.int64
    trials: np.int64
    mem_count: np.int64
    mem_params: np.ndarray
    mem_grad: np.ndarray
    mem_dparams: np.ndarray
    mem_dgrads: np.ndarray
    mem_rhos: np.ndarray


def init_state(x0: np.ndarray) -> LbfgsState:
    """The state at ``x0``, before any evaluation."""
    params = np.asarray(x0, dtype=np.float64).copy()
    mem = _Memory(MEMORY_SIZE, params.shape[0])
    i64, f64 = np.int64, np.float64
    return LbfgsState(params, f64(np.inf), np.zeros_like(params), i64(0), f64(np.inf), i64(0), i64(0),
                      i64(mem.count), mem.params, mem.grad, mem.dparams, mem.dgrads, mem.rhos)


def run(value_and_grad: ValueAndGrad, state: LbfgsState, max_iter: int, tol: float,
        every: Optional[int] = None) -> LbfgsState:
    """Up to ``every`` iterations (all of them when None) from ``state``
    with the reference's loop contract (see the module docstring); the
    returned state resumes exactly where this run stopped."""
    mem = _Memory(MEMORY_SIZE, state.params.shape[0])
    mem.count = int(state.mem_count)
    mem.params, mem.grad = state.mem_params, state.mem_grad
    mem.dparams, mem.dgrads, mem.rhos = (np.array(a, dtype=np.float64)
                                         for a in (state.mem_dparams, state.mem_dgrads, state.mem_rhos))
    params, value, grad = state.params, state.value, state.grad
    it, gnorm, n_evals, trials = int(state.it), state.gnorm, int(state.n_evals), int(state.trials)
    seg = 0
    while (every is None or seg < every) and it < max_iter and gnorm > tol:
        if not np.isfinite(value):
            value, grad = value_and_grad(params)
            n_evals += 1
        updates = mem.direction(grad, params)
        stepsize, new_value, new_grad, count = zoom_linesearch(value_and_grad, params, updates, value, grad)
        n_evals += count
        trials += count
        params = params + stepsize * updates
        gnorm = float(np.sqrt(np.dot(grad, grad)))
        value, grad = new_value, new_grad
        it += 1
        seg += 1
    i64, f64 = np.int64, np.float64
    return LbfgsState(params, f64(value), np.asarray(grad, dtype=np.float64), i64(it), f64(gnorm),
                      i64(n_evals), i64(trials), i64(mem.count), mem.params, mem.grad, mem.dparams,
                      mem.dgrads, mem.rhos)


def minimize(value_and_grad: ValueAndGrad, x0: np.ndarray, max_iter: int, tol: float) -> LbfgsResult:
    """Minimize with the reference's loop contract (see the module
    docstring). ``value_and_grad(params)`` takes and returns float64
    numpy; ``x0`` is the start."""
    st = run(value_and_grad, init_state(x0), max_iter, tol)
    return LbfgsResult(st.params, int(st.it), int(st.n_evals), int(st.trials))
