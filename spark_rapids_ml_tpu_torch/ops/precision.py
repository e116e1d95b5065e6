"""Named GEMM precision modes — port of the reference's ``ops/precision.py``.

  ``f32`` / ``highest``  IEEE fp32 products, TF32 off (the reference's
                         ``Precision.HIGHEST``). On the card this mode
                         refuses to run with TF32 on.
  ``bf16x3`` / ``high``  the 3-pass compensated split: a = hi + lo with both
                         parts bf16-representable, A·B ≈ Ahi·Bhi + Ahi·Blo +
                         Alo·Bhi. Documented bound: max rel err ≤ 2e-4.
  ``bf16`` / ``default`` operands rounded to bf16, products accumulated in
                         fp32. Documented bound: max rel err ≤ 3e-2.

bf16 operands are carried in fp32 containers and multiplied in fp32, which
gives the reference's "bf16 multiply, fp32 accumulate" numbers exactly
(the product of two bf16 values is exact in fp32). float64 operands are
multiplied in float64 in every mode, as the reference does under x64.

:func:`resolve_policy` layers an op family's mode as the reference does:
explicit request > ``TPUML_PRECISION_<FAMILY>`` > ``TPUML_PRECISION`` >
a committed autotuner decision (tune-store knob ``precision_mode``) >
default, and records the mode it resolved (:func:`active_mode`) for the
cost ledger's roofline.

The autotuner's gate (:func:`tune_precision`, reached with
``TPUML_AUTOTUNE=on`` when nothing outranks it) times a probe GEMM in
each mode — on the card with CUDA events after a warm-up — and commits a
candidate iff it beats the f32 incumbent AND its error against the f32
product stays within :data:`REL_TOL`; the decision persists in the tune
store, so the probe runs once per (family, store).

Roofline currency (:data:`PASSES`): every mode here multiplies in fp32,
so a mode's flops ceiling is the fp32 peak over its fp32 passes — f32 and
bf16 one, bf16x3 three. (The reference counts bf16 MXU passes instead:
f32 six, bf16x3 three, bf16 one.)
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.utils.envknobs import EnvKnobError, env_str

MODES = ("f32", "bf16x3", "bf16")
LEGACY = ("default", "high", "highest")

FAMILIES = ("covariance", "pca", "kmeans", "logistic", "linear", "serving")

PRECISION_ENV = "TPUML_PRECISION"
PRECISION_KNOB = "precision_mode"  # tune-store knob name

#: Documented parity bounds vs the f32 product (max |err| / max |ref|):
#: the autotuner's commit bars.
REL_TOL = {"bf16x3": 2e-4, "bf16": 3e-2}

#: fp32 GEMM passes each mode spends per product — the roofline currency:
#: a mode's flops ceiling is the fp32 peak over its passes.
PASSES = {"f32": 1, "highest": 1, "high": 3, "bf16x3": 3, "default": 1, "bf16": 1}

#: Registered-for-tests modes: name -> (dot callable, parity rel tol).
_TEST_MODES: Dict[str, Tuple[Callable, float]] = {}

#: family -> last resolved mode, read by the cost ledger's roofline.
_ACTIVE_MODES: Dict[str, str] = {}


def register_test_mode(name: str, dot: Callable, rel_tol: float = 0.0) -> None:
    """Install a synthetic precision mode (tests only): ``dot(a, b)``
    replaces the GEMM, ``rel_tol`` is its parity bar for the tuner."""
    _TEST_MODES[name] = (dot, float(rel_tol))


def clear_test_modes() -> None:
    _TEST_MODES.clear()


def valid_modes() -> tuple:
    return MODES + LEGACY + tuple(_TEST_MODES)


def validate_mode(value: str) -> str:
    if value not in valid_modes():
        raise ValueError(
            f"precision mode must be one of {'/'.join(MODES + LEGACY)}, got {value!r}"
        )
    return value


def split_hi_lo(a: torch.Tensor):
    """bf16 hi/lo split in the input's container: ``a == hi + lo`` exactly,
    ``hi`` the bf16 rounding of ``a``. Not safe on non-finite values."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    return hi, a - hi


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def _dot_highest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and a.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "precision 'highest' needs IEEE fp32 products; "
            "torch.backends.cuda.matmul.allow_tf32 is True"
        )
    return torch.matmul(a, b)


def _dot_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.float64 in (a.dtype, b.dtype):
        return _dot_highest(a, b)
    a_hi, a_lo = split_hi_lo(a)
    b_hi, b_lo = split_hi_lo(b)
    return (
        _dot_highest(_bf16(a_hi), _bf16(b_hi))
        + _dot_highest(_bf16(a_hi), _bf16(b_lo))
        + _dot_highest(_bf16(a_lo), _bf16(b_hi))
    ).to(a.dtype)


def _dot_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.float64 in (a.dtype, b.dtype):
        return _dot_highest(a, b)
    return _dot_highest(_bf16(a), _bf16(b)).to(a.dtype)


def make_dot(precision: str) -> Callable:
    """The one chokepoint mapping a mode name to a matmul-like callable."""
    if precision in _TEST_MODES:
        return _TEST_MODES[precision][0]
    if precision in ("bf16x3", "high"):
        return _dot_bf16x3
    if precision in ("bf16", "default"):
        return _dot_bf16
    if precision in ("f32", "highest", "dd"):
        # "dd" is the reference's fp64 emulation; Hopper multiplies the
        # float64 operands the dd routes feed it natively.
        return _dot_highest
    raise ValueError(f"no GEMM for precision {precision!r}")


def pallas_precision(precision: str) -> str:
    """Map a policy mode onto the KMeans kernels' vocabulary (``highest``
    / ``high`` / ``default``): ``f32`` → ``highest``, ``bf16x3`` → ``high``
    (the 3-pass split), ``bf16`` → ``default`` (one bf16 pass); the legacy
    names pass through."""
    return {"f32": "highest", "bf16x3": "high", "bf16": "default"}.get(precision, precision)


def note_mode(family: str, mode: str) -> None:
    """Record the mode a family resolved to (:func:`roofline_peak_scale`)."""
    _ACTIVE_MODES[family] = mode


def active_modes() -> Dict[str, str]:
    """Copy of the family -> resolved-mode registry."""
    return dict(_ACTIVE_MODES)


#: Ledger program families for forward passes run under the serving policy.
SERVING_SUFFIXES = ("predict", "transform", "serve")


def active_mode(family: str) -> Optional[str]:
    """Last resolved mode for ``family``; a ledger family's serving
    suffix maps to the ``serving`` policy, anything else falls back to
    the bare family prefix (``kmeans.lloyd.segment`` -> ``kmeans``)."""
    mode = _ACTIVE_MODES.get(family)
    if mode is None and "." in family:
        if family.rsplit(".", 1)[1] in SERVING_SUFFIXES:
            mode = _ACTIVE_MODES.get("serving")
        if mode is None:
            mode = _ACTIVE_MODES.get(family.split(".", 1)[0])
    return mode


def roofline_peak_scale(program_family: str) -> float:
    """Factor on the declared ``TPUML_PEAK_FLOPS`` (one fp32 pass per
    product) for a ledger program family: 1 / the active mode's passes,
    1.0 when no mode was recorded."""
    mode = active_mode(program_family)
    passes = PASSES.get(mode) if mode is not None else None
    if not passes:
        return 1.0
    return PASSES["f32"] / passes


def reset_for_tests() -> None:
    _ACTIVE_MODES.clear()
    _TEST_MODES.clear()


def family_env(family: str) -> str:
    return f"TPUML_PRECISION_{family.upper()}"


def _env_mode(name: str) -> Optional[str]:
    value = env_str(name)
    if value is None:
        return None
    if value not in valid_modes():
        raise EnvKnobError(name, value, f"one of {'|'.join(MODES + LEGACY)}")
    return value


def resolve_policy(
    family: str, requested: Optional[str] = None, default: str = "highest"
) -> str:
    """The precision mode for an op family. ``requested`` is the
    explicitly set param (None when ``setPrecision`` was never called;
    ``"dd"`` passes through to its own resolution downstream). Layering:
    explicit > ``TPUML_PRECISION_<FAMILY>`` > ``TPUML_PRECISION`` >
    committed autotuner decision > ``requested`` ``"auto"`` > ``default``."""
    if family not in FAMILIES:
        raise ValueError(f"unknown precision family {family!r}")
    if requested is not None and requested != "auto":
        mode = requested if requested == "dd" else validate_mode(requested)
        note_mode(family, mode)
        return mode
    mode = _env_mode(family_env(family)) or _env_mode(PRECISION_ENV)
    if mode is None and requested is None:
        from spark_rapids_ml_tpu_torch.observability import autotune as _autotune

        tuner = _autotune.active()
        if tuner is not None:
            mode = tune_precision(family, tuner=tuner)
    if mode is None:
        mode = requested if requested is not None else default
    note_mode(family, mode)
    return mode


# ---------------------------------------------------------------------------
# the autotuner's gate
# ---------------------------------------------------------------------------

#: Per-family candidates, fastest last: fits trial only the compensated
#: mode; serving may also trial plain bf16.
_CANDIDATES = {"serving": ("bf16x3", "bf16")}
_DEFAULT_CANDIDATES = ("bf16x3",)

#: Probe GEMM shape (the reference's).
_PROBE_M, _PROBE_K, _PROBE_N = 512, 256, 256


def _probe_device() -> torch.device:
    from spark_rapids_ml_tpu_torch import device as _device

    return _device.resolve_device()


def _probe_operands(device: torch.device):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((_PROBE_M, _PROBE_K)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal((_PROBE_K, _PROBE_N)).astype(np.float32)).to(device)
    return a, b


def _time_probe(a: torch.Tensor, b: torch.Tensor, mode: str, repeats: int = 3) -> tuple:
    """(product as numpy, best wall in seconds of ``repeats`` calls) after
    one warm-up call: CUDA events on the card, ``perf_counter`` elsewhere."""
    dot = make_dot(mode)
    out = dot(a, b)  # warm-up: lazy library handles and loads stay out of the timing
    best = float("inf")
    if a.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            start.record()
            out = dot(a, b)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = dot(a, b)
            best = min(best, time.perf_counter() - t0)
    return out.cpu().numpy(), best


def candidate_rel_tol(mode: str) -> float:
    if mode in _TEST_MODES:
        return _TEST_MODES[mode][1]
    return REL_TOL.get(mode, 0.0)


def tune_precision(family: str, tuner=None, candidates: Optional[tuple] = None) -> Optional[str]:
    """Trial faster precision modes for ``family`` through the autotuner
    and return the committed mode (None when the tuner is off).

    The f32 probe runs first and seeds the incumbent; each candidate then
    commits iff its measured probe wall BEATS the incumbent AND its max
    relative error vs the f32 product stays within :data:`REL_TOL`. A
    slower candidate is recorded rejected (``regression``), an
    out-of-bound one (``parity``). Decisions persist in the tune store."""
    if tuner is None:
        from spark_rapids_ml_tpu_torch.observability import autotune as _autotune

        tuner = _autotune.active()
        if tuner is None:
            return None
    decision = tuner.store.get(PRECISION_KNOB, family)
    if decision is not None:
        value = decision.get("value")
        return str(value) if value else None
    a, b = _probe_operands(_probe_device())
    shape = f"{_PROBE_M}x{_PROBE_K}x{_PROBE_N}"
    ref, wall_ref = _time_probe(a, b, "f32")
    tuner.record_trial(PRECISION_KNOB, family, "f32", wall_ref,
                       evidence=[f"probe={shape}"], metric_name="probe_seconds")
    scale = float(np.max(np.abs(ref))) or 1.0
    for mode in candidates or _CANDIDATES.get(family, _DEFAULT_CANDIDATES):
        res, wall = _time_probe(a, b, mode)
        err = float(np.max(np.abs(res - ref))) / scale
        tol = candidate_rel_tol(mode)
        tuner.record_trial(
            PRECISION_KNOB, family, mode, wall,
            evidence=[f"probe={shape}", f"max_rel_err={err:.3e}", f"tol={tol:.1e}"],
            metric_name="probe_seconds", ok=err <= tol, reason="parity",
        )
    decision = tuner.store.get(PRECISION_KNOB, family)
    if decision is None:
        return None
    value = decision.get("value")
    return str(value) if value else None
