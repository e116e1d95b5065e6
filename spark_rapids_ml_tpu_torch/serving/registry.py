"""Versioned model registry — port of the reference's ``serving/registry.py``.

``register(name, model)`` assigns monotonic versions per name; aliases
(``"prod"``, ``"canary"``) pin a version apart from ``latest``, so a hot
swap is one alias move under the registry lock. Requests admitted against
the old version finish on its weights (the micro-batcher's coalescing key
carries the version); new resolutions see the new one.

``load`` reads an ``MLWriter`` directory through
``core/persistence.resolve_component_class``, so any servable, a
``PipelineModel`` too, loads by path alone. ``warm`` pushes zero batches
through the version's serving kernel per bucket: on the card that
captures the bucket's CUDA graph, so the first real request replays.
``retire`` drops the version's device-weight caches and closes every
program (graph) that reads its weights.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Type

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.core.serving import (
    HOST_DTYPE,
    bucket_rows,
    evict_programs,
    invalidate_device_caches,
    serve_rows,
)
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.serving.admission import signature_device
from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_rlock
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter


class ModelVersion:
    """One immutable (name, version) registration."""

    __slots__ = ("name", "version", "model", "signature", "created")

    def __init__(self, name: str, version: int, model: Any, signature: ServingSignature):
        self.name = name
        self.version = version
        self.model = model
        self.signature = signature
        self.created = time.time()

    @property
    def key(self) -> Tuple[str, int]:
        return (self.name, self.version)

    def __repr__(self) -> str:
        return f"ModelVersion({self.name!r}, v{self.version})"


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32}[np.dtype(dtype)]


class ModelRegistry:
    """Thread-safe versioned registry with alias pinning and warm-up."""

    def __init__(self):
        self._lock = make_rlock("serving.registry")
        self._versions: Dict[str, Dict[int, ModelVersion]] = {}  # guarded-by: _lock
        # High-water version per name: a retired number is never reissued.
        self._next: Dict[str, int] = {}  # guarded-by: _lock
        self._aliases: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock
        # Where each (name, alias) pointed before its latest move: the
        # one-op rollback target (rolling back twice returns).
        self._previous: Dict[Tuple[str, str], Optional[int]] = {}  # guarded-by: _lock

    def register(self, name: str, model: Any, *, alias: Optional[str] = None,
                 warm_buckets: Iterable[int] = (), warm_dtype: Any = None) -> ModelVersion:
        """Register ``model`` (anything with ``serving_signature()``) as the
        next version of ``name``; ``alias`` pins it in the same step and
        ``warm_buckets`` warms those buckets before it takes traffic."""
        sig_fn = getattr(model, "serving_signature", None)
        if sig_fn is None:
            raise TypeError(f"{type(model).__name__} declares no serving_signature(); "
                            "only servable model families can be registered")
        sig = sig_fn()
        with self._lock:
            versions = self._versions.setdefault(name, {})
            v = self._next.get(name, 0) + 1
            mv = ModelVersion(name, v, model, sig)
            versions[v] = mv
            self._next[name] = v
            bump_counter("serving.registry.register")
            emit("serving", action="register", model=name, version=v, kind=type(model).__name__)
            if alias is not None:
                self.set_alias(name, alias, v)
        if warm_buckets:
            self.warm(name, version=v, buckets=warm_buckets, dtype=warm_dtype)
        return mv

    def load(self, name: str, path: str, model_cls: Optional[Type] = None, *, alias: Optional[str] = None,
             warm_buckets: Iterable[int] = (), warm_dtype: Any = None) -> ModelVersion:
        """Load an ``MLWriter``-saved model from ``path`` and register it;
        without ``model_cls`` the saved metadata's class decides."""
        if model_cls is None:
            from spark_rapids_ml_tpu_torch.core.persistence import resolve_component_class

            model_cls = resolve_component_class(path)
        with TraceRange(f"registry load {name}", TraceColor.WHITE):
            model = model_cls.load(path)
        return self.register(name, model, alias=alias, warm_buckets=warm_buckets, warm_dtype=warm_dtype)

    def set_alias(self, name: str, alias: str, version: int) -> None:
        """Pin ``name@alias`` to ``version``: the hot-swap primitive."""
        with self._lock:
            if version not in self._versions.get(name, {}):
                raise KeyError(f"model {name!r} has no version {version}")
            previous = self._aliases.setdefault(name, {}).get(alias)
            self._aliases[name][alias] = version
            self._previous[(name, alias)] = previous
        bump_counter("serving.registry.swap")
        emit("serving", action="swap", model=name, alias=alias, version=version, previous=previous)

    def rollback_target(self, name: str, alias: str = "prod") -> int:
        """The version :meth:`rollback` would pin ``name@alias`` to."""
        with self._lock:
            if alias not in self._aliases.get(name, {}):
                raise KeyError(f"model {name!r} has no alias {alias!r}")
            prev = self._previous.get((name, alias))
            if prev is None:
                raise KeyError(f"model {name!r} alias {alias!r} has no previous version to roll back to")
            if prev not in self._versions.get(name, {}):
                raise KeyError(f"rollback target v{prev} of {name!r} was retired")
            return prev

    def rollback(self, name: str, alias: str = "prod") -> int:
        """Re-pin ``name@alias`` to the version it served before its latest
        move (calling it again undoes it); returns the version now served."""
        with self._lock:
            target = self.rollback_target(name, alias)
            current = self._aliases[name][alias]
            self._aliases[name][alias] = target
            self._previous[(name, alias)] = current
        bump_counter("serving.registry.rollback")
        emit("registry_rollback", model=name, alias=alias, version=target, previous=current)
        return target

    def retire(self, name: str, version: int) -> None:
        """Remove one version: it resolves no more, its aliases drop, its
        model's device-weight caches are invalidated, and every program
        that reads its weights is closed, so its device memory is freed."""
        with self._lock:
            mv = self._versions.get(name, {}).pop(version, None)
            if mv is None:
                raise KeyError(f"model {name!r} has no version {version}")
            aliases = self._aliases.get(name, {})
            for a in [a for a, v in aliases.items() if v == version]:
                del aliases[a]
        invalidate_device_caches(mv.model)
        sig = mv.signature
        evict_programs((sig.weights, sig.host_weights, list(sig._moved.values())))
        bump_counter("serving.registry.retire")
        emit("serving", action="retire", model=name, version=version)

    def resolve(self, name: str, version: Optional[Any] = None) -> ModelVersion:
        """The :class:`ModelVersion` for ``name``: the latest by default, or
        ``version=`` (an int or an alias), or ``"name@alias"`` / ``"name@3"``."""
        if version is None and "@" in name:
            name, _, version = name.partition("@")
        with self._lock:
            versions = self._versions.get(name)
            if not versions:
                raise KeyError(f"no model registered under {name!r}")
            if version is None:
                v = max(versions)
            elif isinstance(version, str) and not version.isdigit():
                alias_map = self._aliases.get(name, {})
                if version not in alias_map:
                    raise KeyError(f"model {name!r} has no alias {version!r}")
                v = alias_map[version]
            else:
                v = int(version)
            mv = versions.get(v)
            if mv is None:
                raise KeyError(f"model {name!r} has no version {v}")
            return mv

    def names(self) -> List[str]:
        with self._lock:
            return [n for n, vs in self._versions.items() if vs]

    def versions(self, name: str) -> List[int]:
        with self._lock:
            return sorted(self._versions.get(name, {}))

    def aliases(self, name: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._aliases.get(name, {}))

    def warm(self, name: str, *, version: Optional[int] = None, buckets: Iterable[int] = (),
             dtype: Any = None) -> int:
        """Run a zero batch through the version's serving kernel for each
        of ``buckets`` (row counts, each rounded up to its bucket) at
        ``dtype``: float64 by default, the dtype the runtime serves host
        rows at, with the host route's weights; another dtype warms the
        tensor route. On the card each new bucket captures its graph.
        Returns the number of distinct buckets warmed."""
        mv = self.resolve(name, version)
        sig = mv.signature
        dt = HOST_DTYPE if dtype is None else _torch_dtype(dtype)
        device = signature_device(sig)
        warmed = set()
        with TraceRange(f"registry warm {name}", TraceColor.YELLOW):
            for b in buckets:
                bucket = bucket_rows(int(b))
                if bucket in warmed:
                    continue
                warmed.add(bucket)
                if dt == HOST_DTYPE:
                    serve_rows(sig.kernel, np.zeros((bucket, sig.n_features)), sig.weights_on(device, host=True),
                               static=sig.static, name=sig.name, device=device)
                else:
                    serve_rows(sig.kernel, torch.zeros((bucket, sig.n_features), dtype=dt, device=device),
                               sig.weights_on(device), static=sig.static, name=sig.name)
                bump_counter("serving.registry.warm")
        emit("serving", action="warm", model=name, version=mv.version, buckets=sorted(warmed), dtype=str(dt))
        return len(warmed)

    def snapshot(self) -> dict:
        """JSON-able registry state."""
        with self._lock:
            return {
                name: {
                    "versions": sorted(vs),
                    "latest": max(vs),
                    "aliases": dict(self._aliases.get(name, {})),
                    "weights_bytes": {v: mv.signature.weights_bytes() for v, mv in vs.items()},
                }
                for name, vs in self._versions.items()
                if vs
            }
