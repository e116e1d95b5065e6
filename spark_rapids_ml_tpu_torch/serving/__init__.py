"""Serving — the part of the reference's ``serving/`` package that is
ported: :class:`ServingSignature`, the contract each model family
declares and the pipeline fuser composes.

The serving runtime (``ServingRuntime``, the registry, micro-batcher,
admission control, router, workers and elastic scaling) is not ported
yet: ROADMAP A.8, item 17.
"""

from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature, spec_bytes

__all__ = ["ServingSignature", "spec_bytes"]

#: The reference's runtime names, none of them ported yet.
RUNTIME_ITEM = "the serving runtime is not ported yet: ROADMAP A.8, item 17"
_RUNTIME = frozenset({
    "AdmissionQueue", "DeadlineExceeded", "ElasticScaler", "MicroBatcher", "ModelRegistry",
    "ModelVersion", "Overloaded", "RoutingRuntime", "ServingRuntime", "router_snapshots",
    "runtime_snapshots",
})


def __getattr__(name: str):
    if name in _RUNTIME:
        raise NotImplementedError(f"{name}: {RUNTIME_ITEM}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
