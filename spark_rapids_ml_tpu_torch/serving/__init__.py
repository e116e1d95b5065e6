"""Online serving — port of the reference's ``serving/`` package, in
process: :class:`ServingSignature`, the contract each model family
declares; the versioned :class:`ModelRegistry` with aliases, warm-up, hot
swap and retire; the :class:`MicroBatcher` coalescing concurrent callers
into one bucketed execution (on the card, one CUDA graph replay);
admission with structured :class:`Overloaded` and
:class:`DeadlineExceeded`; and the :class:`ServingRuntime` façade over
them. See each module's docstring.

The runtime names load on first use, so ``core/serving`` (which the
runtime builds on) can import ``serving.signature`` without a cycle.

The distributed tier (``RoutingRuntime``, ``router_snapshots``,
``ElasticScaler``: the reference's router, worker, ipc and elastic
modules) is not ported: ROADMAP A.9, item 17b.
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
}

#: The reference's distributed serving tier, not ported.
DISTRIBUTED_ITEM = "the distributed serving tier is not ported yet: ROADMAP A.9, item 17b"
_DISTRIBUTED = frozenset({"ElasticScaler", "RoutingRuntime", "router_snapshots"})

__all__ = ["ServingSignature", "spec_bytes", *sorted(_RUNTIME)]


def __getattr__(name: str):
    if name in _RUNTIME:
        return getattr(importlib.import_module(f"{__name__}.{_RUNTIME[name]}"), name)
    if name in _DISTRIBUTED:
        raise NotImplementedError(f"{name}: {DISTRIBUTED_ITEM}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
