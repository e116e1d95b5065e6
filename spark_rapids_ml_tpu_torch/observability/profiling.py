"""``TPUML_PROFILE_DIR`` — wrap a fit in a ``torch.profiler`` session.

Port of the reference's ``observability/profiling.py``, which runs a
``jax.profiler`` trace. Point ``TPUML_PROFILE_DIR`` at a directory and
every top-level fit (the
:class:`~spark_rapids_ml_tpu_torch.observability.report.RunRecorder`
entry) runs inside a ``torch.profiler.profile`` session with the CPU
activity and, on a CUDA machine, the CUDA activity; at its end the
session is written there as one Chrome-trace JSON file
(``<label>-<pid>-<n>.trace.json``), which holds the card's kernels by
symbol and, since :class:`~spark_rapids_ml_tpu_torch.utils.tracing.
TraceRange` enters a ``record_function`` while a session is open, the
port's range names.

There is one session at a time: nested recorders (a transform inside a
fit, a CV loop's inner fits) yield ``None``, and so does a recorder that
finds a ``torch.profiler`` session already open (the caller's own
profiler). The profiler never raises into the fit: a session that fails
to start or to write is recorded as a ``profile`` event with
``action="failed"`` and the fit runs on.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import threading
from typing import Optional

from spark_rapids_ml_tpu_torch.utils.envknobs import env_str

PROFILE_DIR_ENV = "TPUML_PROFILE_DIR"

_lock = threading.Lock()
_active = False  # guarded-by: _lock
_session_seq = itertools.count(1)


def profile_dir() -> Optional[str]:
    return env_str(PROFILE_DIR_ENV)


def _trace_path(d: str, label: str) -> str:
    stem = re.sub(r"[^A-Za-z0-9_.-]+", "_", label).strip("_") or "run"
    return os.path.join(d, f"{stem}-{os.getpid()}-{next(_session_seq)}.trace.json")


@contextlib.contextmanager
def maybe_profile(label: str = ""):
    """Run the body inside a ``torch.profiler`` session when
    ``TPUML_PROFILE_DIR`` is set and no session is already active;
    otherwise a no-op. Yields the trace directory or None."""
    global _active
    d = profile_dir()
    if not d:
        yield None
        return
    import torch

    from spark_rapids_ml_tpu_torch.observability.events import emit
    from spark_rapids_ml_tpu_torch.utils.tracing import profiler_active

    with _lock:
        if _active or profiler_active():
            d = None
        else:
            _active = True
    if d is None:  # an outer session owns the profiler
        yield None
        return
    prof = None
    try:
        os.makedirs(d, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as exc:  # the profiler must never fail the fit
        prof = None
        with _lock:
            _active = False
        emit("profile", action="failed", dir=d, label=label, error=repr(exc))
        yield None
        return
    emit("profile", action="start", dir=d, label=label)
    path = None
    try:
        yield d
    finally:
        try:
            prof.__exit__(None, None, None)
            path = _trace_path(d, label)
            prof.export_chrome_trace(path)
        except Exception as exc:  # the profiler must never fail the fit
            emit("profile", action="failed", dir=d, label=label, error=repr(exc))
            path = None
        finally:
            with _lock:
                _active = False
            emit("profile", action="stop", dir=d, label=label, path=path)
