"""Pipeline fusion — a fitted pipeline's stages run as one composite
kernel on the device.

Port of the reference's ``pipeline_fusion/``. A fitted ``PipelineModel``
used stage-at-a-time hands each stage's output to the next through the
host (for host input). The fuser composes the stages'
``serving_signature()`` kernels into one callable, so the chain runs on
the device with host contact only at ingest and egress, and a fused
pipeline is one servable with one signature.
"""

from spark_rapids_ml_tpu_torch.pipeline_fusion.fuser import (
    CompositeSignature,
    FusionFallbackWarning,
    composite_kernel,
    fuse_pipeline_stages,
    fuse_signatures,
    fusion_fit_enabled,
    fusion_mode,
)

__all__ = [
    "CompositeSignature",
    "FusionFallbackWarning",
    "composite_kernel",
    "fuse_pipeline_stages",
    "fuse_signatures",
    "fusion_fit_enabled",
    "fusion_mode",
]
