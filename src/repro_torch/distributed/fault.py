"""Fault handling of the serving and training loops (the torch port of
``repro/distributed/fault.py``).

``StragglerMonitor`` watches each decode launch's wall time; a sustained
straggler verdict turns speculative decode off for the rest of the run
(``serving.engine.SlotServer._observe_launch``). ``FaultPlan`` schedules
faults at exact scheduler steps (``SlotServer._apply_faults``), so a
hostile run is reproducible launch by launch. ``CheckpointPolicy`` is the
training loop's save cadence; ``downscale_plan`` is the elastic plan the
train launcher prints when the monitor asks to exclude a straggler (the
surrounding fleet controller would enact it and relaunch with
``--resume``)."""
from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass
class CheckpointPolicy:
    every_steps: int = 50
    keep: int = 3

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every_steps == 0


class StragglerMonitor:
    """Flags steps slower than ``threshold`` times the rolling median of
    the last ``window`` steps; ``patience`` consecutive flags give
    'exclude'. Pure host state: ``start`` / ``stop`` time a step, tests
    inject timings through ``observe``."""

    def __init__(self, window: int = 32, threshold: float = 3.0, patience: int = 3):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.patience = patience
        self.consecutive = 0
        self.flagged_steps: list[int] = []
        self._step = 0
        self._t0: float | None = None

    def start(self) -> None:
        """Open a step's wall-clock window (``stop`` closes it)."""
        self._t0 = time.perf_counter()

    def stop(self) -> str:
        """Observe the wall time since ``start``. A CUDA step returns
        before the device is done: call this after a read that waits for
        it."""
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        return self.observe(time.perf_counter() - self._t0)

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


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires when the serving scheduler's step counter
    reaches ``step``."""

    step: int
    kind: str  # one of FaultPlan.KINDS
    arg: float = 0.0


class FaultPlan:
    """Deterministic fault schedule for the serving scheduler: every fault
    fires at an exact scheduler step and acts through the seams real
    traffic uses, so the scheduler's conservation invariants (free + held
    pages == pool, refcounts, reservations) can be driven through hostile
    schedules reproducibly.

    Kinds:
      * ``pool_squeeze``: hold ``arg`` pool pages back from admission
        (0 releases the squeeze);
      * ``cancel``: cancel ``arg`` live requests, occupied slots in
        ascending order first, then queued requests in submit order, then
        the in-flight prefill;
      * ``deadline``: force-expire the same selection at the next reap;
      * ``chunk_abort``: abort the in-flight chunked admission at its
        chunk boundary and requeue it (its prefill restarts);
      * ``straggler``: feed an ``arg``-second launch time to the watchdog;
      * ``park``: end the turn of up to ``arg`` occupied slots (ascending):
        they retire as ``parked`` with their partial output, their cache
        parked in the session store when there is one;
      * ``resume``: submit up to ``arg`` returning sessions built from the
        oldest parked traces (a short fixed suffix, request ids far above
        real traffic);
      * ``session_expire``: force-expire up to ``arg`` parked sessions,
        oldest first.
    """

    KINDS = ("pool_squeeze", "cancel", "deadline", "chunk_abort", "straggler",
             "park", "resume", "session_expire")

    def __init__(self, events=()):
        self.events: list[FaultEvent] = sorted(events, key=lambda e: e.step)
        for e in self.events:
            if e.kind not in self.KINDS:
                raise ValueError(f"unknown fault kind {e.kind!r}")
        self.fired: list[FaultEvent] = []

    def at(self, step: int) -> list[FaultEvent]:
        """The events scheduled for ``step`` (the scheduler marks them
        fired)."""
        return [e for e in self.events if e.step == step]

    @classmethod
    def storm(cls, kind: str, start: int, count: int, every: int = 1,
              arg: float = 1.0) -> "FaultPlan":
        """``count`` events of ``kind`` from ``start``, one per ``every``
        steps."""
        return cls([FaultEvent(step=start + i * every, kind=kind, arg=arg)
                    for i in range(count)])

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan([*self.events, *other.events])


@dataclasses.dataclass
class ElasticPlan:
    """Mesh transition for an elastic rescale event. The checkpoint format
    is mesh-agnostic (whole arrays), so a rescale is a restore onto the
    new mesh; this records the decision."""

    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    reason: str  # 'exclude-straggler' | 'node-failure' | 'scale-up'

    @property
    def new_device_count(self) -> int:
        n = 1
        for d in self.new_shape:
            n *= d
        return n


def downscale_plan(shape: tuple[int, ...], reason: str) -> ElasticPlan:
    """Halve the data axis (the standard failure-domain response); the data
    axis is the last but one by convention ((pod,) data, model)."""
    axes = list(shape)
    i = len(axes) - 2
    if axes[i] % 2 == 0 and axes[i] > 1:
        axes[i] //= 2
    return ElasticPlan(old_shape=shape, new_shape=tuple(axes), reason=reason)
