"""Quantization configuration (the torch port of ``repro/core/quantization.py``;
the runtime token-wise quantizer itself lives in ``core/cache.py``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration of the (lossy) quantization stage.

    rel_scale: relative quantization scale in (0, 1]; the actual scale is
      ``rel_scale * (max - min)`` of the quantization unit.
    granularity: 'token' (PackKV) or 'channel' (KIVI-K).
    group_size: context-dim group length for channel-wise quantization.
    bits: optional hard cap on integer width; when set, levels = 2**bits
      and rel_scale is ignored.
    """

    rel_scale: float = 0.1
    granularity: str = "token"
    group_size: int = 64
    bits: int | None = None

    @property
    def levels(self) -> int:
        if self.bits is not None:
            return 2 ** self.bits
        return int(round(1.0 / self.rel_scale)) + 1

    @property
    def max_q(self) -> int:
        return self.levels - 1
