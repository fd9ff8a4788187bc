"""Fault handling of the serving loop (the torch port of
``repro/distributed/fault.py``, all but the elastic plan)."""
from .fault import CheckpointPolicy, FaultEvent, FaultPlan, StragglerMonitor

__all__ = ["CheckpointPolicy", "FaultEvent", "FaultPlan", "StragglerMonitor"]
