"""Robustness subsystem of the port: deterministic fault injection, the
retry policy, checkpoint/resume for iterative fits, and the degradation
records.

  - :mod:`~spark_rapids_ml_tpu_torch.robustness.faults`: named injection
    sites (``TPUML_FAULTS`` / ``inject(...)``);
  - :mod:`~spark_rapids_ml_tpu_torch.robustness.retry`: the one
    :class:`RetryPolicy` and the device OOM classification;
  - :mod:`~spark_rapids_ml_tpu_torch.robustness.checkpoint`: segmented-fit
    snapshots and mid-solve resume (``TPUML_CHECKPOINT_*``);
  - :mod:`~spark_rapids_ml_tpu_torch.robustness.degrade`: the structured
    degradation warning (the reference's CPU fallback is not ported).
"""

from spark_rapids_ml_tpu_torch.robustness.checkpoint import (
    CheckpointWriteWarning,
    EphemeralSegmenter,
    FitCheckpointer,
    data_fingerprint,
    params_hash,
    replicate_state_onto_mesh,
)
from spark_rapids_ml_tpu_torch.robustness.degrade import DegradationWarning
from spark_rapids_ml_tpu_torch.robustness.faults import (
    InjectedFault,
    arm,
    disarm,
    fault_point,
    inject,
)
from spark_rapids_ml_tpu_torch.robustness.retry import (
    RetryExhaustedError,
    RetryPolicy,
    classify,
    default_policy,
)

__all__ = [
    "CheckpointWriteWarning",
    "DegradationWarning",
    "EphemeralSegmenter",
    "FitCheckpointer",
    "InjectedFault",
    "RetryExhaustedError",
    "RetryPolicy",
    "arm",
    "classify",
    "data_fingerprint",
    "default_policy",
    "disarm",
    "fault_point",
    "inject",
    "params_hash",
    "replicate_state_onto_mesh",
]
