"""Fault handling of the serving and training loops, gradient
compression, the sharding rules (``sharding``) and the rank-order exchange
of data-parallel training (``exchange``): the torch port of
``repro/distributed``."""
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
