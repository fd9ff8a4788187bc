"""Straggler detection (the torch port of ``repro/distributed/fault.py::
StragglerMonitor``; the checkpoint policy, the fault plan and the elastic
plan are not ported yet).

The serving scheduler feeds it each decode launch's wall time; a
sustained straggler verdict turns speculative decode off for the rest of
the run (``serving.engine.SlotServer._observe_launch``)."""
from __future__ import annotations

from collections import deque


class StragglerMonitor:
    """Flags steps slower than ``threshold`` times the rolling median of
    the last ``window`` steps; ``patience`` consecutive flags give
    'exclude'. Pure host state: tests inject timings."""

    def __init__(self, window: int = 32, threshold: float = 3.0, patience: int = 3):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.patience = patience
        self.consecutive = 0
        self.flagged_steps: list[int] = []
        self._step = 0

    def observe(self, dt: float) -> str:
        """Record one step of ``dt`` seconds; returns 'ok' | 'straggler' |
        'exclude'. The median is of the steps before this one (this step's
        own time when there are none); no flag before 4 steps are held."""
        self._step += 1
        med = sorted(self.times)[len(self.times) // 2] if self.times else dt
        self.times.append(dt)
        if len(self.times) >= 4 and dt > self.threshold * med:
            self.consecutive += 1
            self.flagged_steps.append(self._step)
            if self.consecutive >= self.patience:
                return "exclude"
            return "straggler"
        self.consecutive = 0
        return "ok"
