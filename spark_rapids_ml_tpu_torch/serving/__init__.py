"""Online serving — port of the reference's ``serving/`` package, in
process: :class:`ServingSignature`, the contract each model family
declares; the versioned :class:`ModelRegistry` with aliases, warm-up, hot
swap and retire; the :class:`MicroBatcher` coalescing concurrent callers
into one bucketed execution (on the card, one CUDA graph replay);
admission with structured :class:`Overloaded` and
:class:`DeadlineExceeded`; and the :class:`ServingRuntime` façade over
them. See each module's docstring.

The distributed tier scales that façade across processes:
:class:`RoutingRuntime` (``router.py``) spreads micro-batches over N
``worker.py`` member processes (``ipc.py`` frames the socket hop) with
backpressure-weighted routing, a replicated registry with
version-atomic hot swap, and a sharded path for requests too big for any
one member; :class:`ElasticScaler` (``elastic.py``) grows and shrinks the
gang from its load signals.

The runtime names load on first use, so ``core/serving`` (which the
runtime builds on) can import ``serving.signature`` without a cycle.
"""

import importlib

from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature, spec_bytes

#: Runtime names and the module each lives in.
_RUNTIME = {
    "AdmissionQueue": "admission",
    "DeadlineExceeded": "admission",
    "Overloaded": "admission",
    "MicroBatcher": "batcher",
    "ModelRegistry": "registry",
    "ModelVersion": "registry",
    "ServingRuntime": "server",
    "runtime_snapshots": "server",
    "RoutingRuntime": "router",
    "router_snapshots": "router",
    "ElasticScaler": "elastic",
}

__all__ = ["ServingSignature", "spec_bytes", *sorted(_RUNTIME)]


def __getattr__(name: str):
    if name in _RUNTIME:
        return getattr(importlib.import_module(f"{__name__}.{_RUNTIME[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
