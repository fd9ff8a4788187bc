"""Fault handling of the serving and training loops, and gradient
compression (the single-device half of ``repro/distributed``)."""
from .fault import (
    CheckpointPolicy,
    ElasticPlan,
    FaultEvent,
    FaultPlan,
    StragglerMonitor,
    downscale_plan,
)
from .grad_compress import GradCompressConfig, roundtrip_grads

__all__ = ["CheckpointPolicy", "ElasticPlan", "FaultEvent", "FaultPlan",
           "GradCompressConfig", "StragglerMonitor", "downscale_plan",
           "roundtrip_grads"]
