"""Device out-of-memory classification — the part of the reference's
``robustness/retry.py`` the fit memory guard needs (``OOM_MARKERS``,
:func:`is_oom_error`). The retry policy itself is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Message markers of a device out-of-memory failure: the reference's
#: three (``torch.OutOfMemoryError`` says "CUDA out of memory"), plus this
#: backend's form of XLA's RESOURCE_EXHAUSTED from the cuBLAS and
#: cuSOLVER workspace allocations, which arrive as plain RuntimeErrors.
OOM_MARKERS = (
    "resource_exhausted",
    "out of memory",
    "ran out of memory",
    "cublas_status_alloc_failed",
    "cusolver_status_alloc_failed",
)


def is_oom_error(exc: Optional[BaseException]) -> bool:
    """True when ``exc``, or anything on its ``__cause__`` chain, is a
    device out-of-memory failure: a ``torch.OutOfMemoryError`` or a
    ``RuntimeError`` carrying one of :data:`OOM_MARKERS`. Only the
    RuntimeError subtree is matched, so a ValueError that mentions memory
    is not an OOM."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, torch.OutOfMemoryError):
            return True
        if isinstance(exc, RuntimeError):
            text = str(exc).lower()
            if any(marker in text for marker in OOM_MARKERS):
                return True
        exc = exc.__cause__
    return False
