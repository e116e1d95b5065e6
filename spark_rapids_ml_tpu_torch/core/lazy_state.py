"""Lazy host views over device-or-host fitted model state.

Port of the reference's ``core/lazy_state.py``. A fit on a CUDA tensor
stores its raw tensor outputs, so the fit stays asynchronous until the
model is read; the public host views convert (and cache) on first read,
as host float64 numpy; pickling materializes host arrays and never ships
device tensors.

Usage::

    class FooModel(_FooParams, Model, LazyHostState):
        _lazy_host_fields = {"_coef_raw": ("_coef_np", np.float64)}
        _pickle_clear = ("_dev_cache",)   # device-side caches -> None

        @property
        def coefficients(self):
            return self._lazy_host_view("_coef_raw")
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def to_host(raw, dtype=None) -> np.ndarray:
    """A numpy copy or view of ``raw`` (a tensor anywhere, or array-like)."""
    if isinstance(raw, torch.Tensor):
        raw = raw.detach().cpu().numpy()
    return np.asarray(raw) if dtype is None else np.asarray(raw, dtype=dtype)


class LazyHostState:
    #: {raw_attr: (cache_attr, host_dtype_or_None)}
    _lazy_host_fields: dict = {}
    #: attributes reset to their "empty" value when pickling (device-side
    #: caches rebuilt lazily after load); value None unless overridden in
    #: _pickle_clear_values.
    _pickle_clear: tuple = ()
    _pickle_clear_values: dict = {}

    def _lazy_host_view(self, raw_attr: str):
        cache_attr, dtype = self._lazy_host_fields[raw_attr]
        cached = getattr(self, cache_attr)
        if cached is None:
            raw = getattr(self, raw_attr)
            if raw is not None:
                cached = to_host(raw, dtype)
                setattr(self, cache_attr, cached)
        return cached

    def __getstate__(self):
        state = dict(self.__dict__)
        for raw_attr, (cache_attr, _dtype) in self._lazy_host_fields.items():
            host = self._lazy_host_view(raw_attr)
            state[raw_attr] = host
            state[cache_attr] = host
        for attr in self._pickle_clear:
            # A fresh copy: an unpickled model must not share its empty
            # cache dict with every other one.
            state[attr] = copy.copy(self._pickle_clear_values.get(attr))
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
