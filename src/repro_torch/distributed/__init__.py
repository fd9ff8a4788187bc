"""Fault handling of the serving loop (the torch port of
``repro/distributed``'s straggler monitor)."""
from .fault import StragglerMonitor

__all__ = ["StragglerMonitor"]
