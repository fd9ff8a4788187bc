"""Disk serializers (the torch port of ``repro/checkpoint``'s mini-cache
half; the step checkpoints arrive with the training port)."""
from .sharded import load_mini, save_mini  # noqa: F401
