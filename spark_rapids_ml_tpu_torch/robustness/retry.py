"""The one retry/backoff/classification policy for every recoverable
layer, and device out-of-memory classification.

Port of the reference's ``robustness/retry.py``. One :class:`RetryPolicy`
owns what every recoverable call site shares: how many attempts, how long
between them (exponential backoff with DETERMINISTIC jitter, so two runs
of a chaos schedule behave the same), the overall deadline, and which
errors are worth retrying at all.

Classification is structural: programming and usage errors (``ValueError``,
``TypeError``, ...) are FATAL and re-raise at once, untouched; environmental
errors (``OSError``, timeouts, a distributed runtime's ``RuntimeError``,
a device OOM) are RETRYABLE. An injected fault (``robustness/faults.py``)
carries its own classification. An exhausted budget raises
:class:`RetryExhaustedError` with the attempt count and the last error
chained.

Every attempt runs inside a ``utils/tracing.TraceRange``
(``retry:<name>#<attempt>``, an NVTX range on the card), bumps the counter
``retry.<name>.attempts`` (``retry.<name>.exhausted`` when the budget runs
out) and writes a ``retry`` event. A failed attempt's frames are cleared
before the next one, so what it placed on the device is freed and not held
by the chained traceback.
"""

from __future__ import annotations

import hashlib
import time
import traceback
from typing import Callable, Optional, Tuple, Type, TypeVar

import torch

from spark_rapids_ml_tpu_torch.robustness.faults import InjectedFault
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_int

T = TypeVar("T")

MAX_ATTEMPTS_ENV = "TPUML_RETRY_MAX_ATTEMPTS"
BASE_DELAY_ENV = "TPUML_RETRY_BASE_DELAY"
MAX_DELAY_ENV = "TPUML_RETRY_MAX_DELAY"
DEADLINE_ENV = "TPUML_RETRY_DEADLINE"

#: Error types that mean a bug or a caller mistake: retrying cannot help.
FATAL_TYPES: Tuple[Type[BaseException], ...] = (
    ValueError,
    TypeError,
    KeyError,
    IndexError,
    AttributeError,
    AssertionError,
    NotImplementedError,
)


class RetryExhaustedError(RuntimeError):
    """The retry budget (attempts or deadline) ran out. ``__cause__`` is
    the last underlying error; ``attempts`` how many were made."""

    def __init__(self, name: str, attempts: int, last: BaseException, why: str):
        self.name = name
        self.attempts = attempts
        super().__init__(
            f"{name}: {why} after {attempts} attempt(s); "
            f"last error: {type(last).__name__}: {last}"
        )


def classify(exc: BaseException) -> str:
    """``"retryable"`` or ``"fatal"`` for one raised error."""
    if isinstance(exc, InjectedFault):
        return "fatal" if exc.fatal else "retryable"
    if isinstance(exc, FATAL_TYPES):
        return "fatal"
    return "retryable"


#: Message markers of a device out-of-memory failure: the reference's
#: three (``torch.OutOfMemoryError`` says "CUDA out of memory"; an injected
#: ``:oom`` fault carries the first), plus this backend's form of XLA's
#: RESOURCE_EXHAUSTED from the cuBLAS and cuSOLVER workspace allocations,
#: which arrive as plain RuntimeErrors.
OOM_MARKERS = (
    "resource_exhausted",
    "out of memory",
    "ran out of memory",
    "cublas_status_alloc_failed",
    "cusolver_status_alloc_failed",
)


def is_oom_error(exc: Optional[BaseException]) -> bool:
    """True when ``exc``, or anything on its ``__cause__`` chain (a
    :class:`RetryExhaustedError` wraps the last attempt's error), is a
    device out-of-memory failure: a ``torch.OutOfMemoryError``, an
    injected ``:oom`` fault, or a ``RuntimeError`` carrying one of
    :data:`OOM_MARKERS`. Only the RuntimeError subtree is matched, so a
    ValueError that mentions memory is not an OOM."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, torch.OutOfMemoryError) or getattr(exc, "oom", False):
            return True
        if isinstance(exc, RuntimeError):
            text = str(exc).lower()
            if any(marker in text for marker in OOM_MARKERS):
                return True
        exc = exc.__cause__
    return False


def _deterministic_jitter(name: str, attempt: int) -> float:
    """A stable fraction in [0, 1) from (name, attempt): backoff spreads as
    random jitter would, identically on every run and every process."""
    digest = hashlib.sha256(f"{name}#{attempt}".encode()).digest()
    return int.from_bytes(digest[:4], "big") / 2**32


class RetryPolicy:
    """Max attempts, exponential backoff with deterministic jitter, an
    overall deadline and error classification, as one value.

    ``run(fn, name)`` executes ``fn`` under the policy: fatal errors
    re-raise at once, retryable ones back off and re-attempt, and an
    exhausted budget raises :class:`RetryExhaustedError` with the last
    error chained."""

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        deadline: Optional[float] = None,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_delay < 0 or max_delay < 0:
            raise ValueError("delays must be >= 0")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.deadline = deadline

    @classmethod
    def from_env(cls, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, deadline: Optional[float] = None) -> "RetryPolicy":
        """The defaults, overridable per process through ``TPUML_RETRY_*``."""
        return cls(
            max_attempts=env_int(MAX_ATTEMPTS_ENV, max_attempts, minimum=1),
            base_delay=env_float(BASE_DELAY_ENV, base_delay, minimum=0.0),
            max_delay=env_float(MAX_DELAY_ENV, max_delay, minimum=0.0),
            deadline=env_float(DEADLINE_ENV, deadline, minimum=0.0),
        )

    def backoff(self, name: str, attempt: int) -> float:
        """Delay before re-attempt ``attempt`` (>= 1): exponential in the
        attempt, capped, jittered deterministically into [0.5x, 1.0x]."""
        raw = min(self.base_delay * (2 ** (attempt - 1)), self.max_delay)
        return raw * (0.5 + 0.5 * _deterministic_jitter(name, attempt))

    def run(
        self,
        fn: Callable[[], T],
        name: str,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
    ) -> T:
        from spark_rapids_ml_tpu_torch.observability.events import emit
        from spark_rapids_ml_tpu_torch.observability.metrics import TIME_BUCKETS, histogram
        from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

        start = time.monotonic()
        last: Optional[BaseException] = None
        try:
            for attempt in range(self.max_attempts):
                if self.deadline is not None and time.monotonic() - start > self.deadline:
                    bump_counter(f"retry.{name}.exhausted")
                    emit("retry", site=name, attempt=attempt, outcome="exhausted",
                         error=type(last).__name__ if last else None)
                    raise RetryExhaustedError(
                        name, attempt, last, f"deadline of {self.deadline}s exceeded"
                    ) from last
                try:
                    bump_counter(f"retry.{name}.attempts")
                    with TraceRange(f"retry:{name}#{attempt}", TraceColor.YELLOW):
                        result = fn()
                    emit("retry", site=name, attempt=attempt, outcome="ok")
                    return result
                except BaseException as exc:
                    if classify(exc) == "fatal":
                        emit("retry", site=name, attempt=attempt, outcome="fatal",
                             error=type(exc).__name__)
                        raise
                    # The failed attempt's frames hold what it placed: drop
                    # their locals so the next attempt meets the freed memory.
                    traceback.clear_frames(exc.__traceback__)
                    last = exc
                    if on_retry is not None and attempt + 1 < self.max_attempts:
                        on_retry(attempt, exc)
                delay = self.backoff(name, attempt + 1)
                if attempt + 1 < self.max_attempts:
                    histogram(
                        "retry.backoff_seconds",
                        "backoff slept between retry attempts",
                        buckets=TIME_BUCKETS,
                    ).observe(delay, site=name)
                    emit("retry", site=name, attempt=attempt, outcome="retry",
                         error=type(last).__name__, backoff=delay)
                    if delay > 0:
                        time.sleep(delay)
            bump_counter(f"retry.{name}.exhausted")
            emit("retry", site=name, attempt=self.max_attempts, outcome="exhausted",
                 error=type(last).__name__ if last else None)
            raise RetryExhaustedError(
                name, self.max_attempts, last, "retry budget exhausted"
            ) from last
        finally:
            # This frame is on the chained errors' tracebacks: drop its
            # reference to the last one, so no cycle keeps the failed
            # attempts' frames (and what they placed) alive.
            last = None


def default_policy() -> RetryPolicy:
    """The process-wide policy, read from the environment on every call so
    a knob set between stages takes effect at once."""
    return RetryPolicy.from_env()
