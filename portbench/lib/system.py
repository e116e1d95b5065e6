"""The system under test: the port's public estimators, built from a
configuration's data.

A configuration names the estimator's class by its import path and its
parameters by their Spark names; :func:`estimator` sets each through its
``set<Name>`` method, and the benchmark's ``--seed`` through the parameter
the configuration names as the seed, if any. A fit is ``Estimator.fit``
on the resident tensor.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

import torch


def estimator_class(config: dict) -> type:
    """The estimator's class, its module imported."""
    module, cls = config["estimator"]["class"].rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def estimator(config: dict, seed: int) -> Any:
    """A fresh estimator as the configuration states it."""
    spec = config["estimator"]
    est = estimator_class(config)()
    params = dict(spec["params"])
    if spec.get("seed_param"):
        params[spec["seed_param"]] = seed
    for key, value in params.items():
        getattr(est, "set" + key[0].upper() + key[1:])(value)
    return est


def fitter(config: dict, seed: int, x: torch.Tensor) -> Callable[[], Any]:
    """One fit: a fresh estimator's ``fit`` on ``x``, its model on the
    device when the call returns."""
    def fit_once():
        model = estimator(config, seed).fit(x)
        wait(x.device)
        return model
    return fit_once


def wait(device: torch.device, event: Any = None) -> None:
    """Until ``device`` has finished everything queued so far: through one
    CUDA event (``event``, made with ``blocking=True`` so the waiting
    thread sleeps) or, without one, the whole device. On the CPU, where
    every call has finished when it returns, a no-op."""
    if device.type != "cuda":
        return
    if event is None:
        torch.cuda.synchronize()
        return
    event.record()
    event.synchronize()
