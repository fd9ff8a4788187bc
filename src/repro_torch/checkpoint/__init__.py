"""Disk checkpoints: step checkpoints of the training loop and the
mini-cache serializers of the session cache."""
from .sharded import (  # noqa: F401
    AsyncCheckpointer,
    gc_old,
    latest_step,
    load_mini,
    restore,
    save,
    save_mini,
)
