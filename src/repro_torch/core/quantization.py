"""Error-controlled quantization (the torch port of
``repro/core/quantization.py``): the paper's only lossy step (PackKV
section III-B2) plus the KIVI granularities of the baseline.

* **token-wise**: one (scale, zero) per (token, head), PackKV's choice
  for both K and V.
* **channel-wise**: one (scale, zero) per (channel group, channel),
  KIVI's choice for K (groups of 32/64/128 along the context dim).

Error model (paper section IV-A): ``scale = rel_scale * (max - min)``, so
the max abs error is ``scale / 2``. Integer outputs are int32; the storage
width is decided later by bit-packing. The runtime cache's centered
quantizer is ``core/cache.py::_quant_tokenwise``, kept apart as in the
reference.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import div


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


def _quantize(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, cfg: QuantConfig):
    """(q int32, safe scale f32, lo f32) of x against its unit's [lo, hi]."""
    rng = hi - lo
    scale = div(rng, cfg.max_q) if cfg.bits is not None else cfg.rel_scale * rng
    # guard degenerate all-equal units
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((x - lo) / safe), 0, cfg.max_q).to(torch.int32)
    return q, safe.to(torch.float32), lo.to(torch.float32)


def quantize_tokenwise(x: torch.Tensor, cfg: QuantConfig):
    """Token-wise quantization over the last dim.

    x: [..., L, D]; each (..., L) vector of length D gets its own (scale,
    zero). Returns (q int32 [..., L, D], scale f32 [..., L, 1], zero f32
    [..., L, 1]).
    """
    return _quantize(x, x.amin(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True), cfg)


def dequantize_tokenwise(q, scale, zero, dtype=torch.float32):
    return (q.to(torch.float32) * scale + zero).to(dtype)


def quantize_channelwise(x: torch.Tensor, cfg: QuantConfig):
    """Channel-wise (KIVI-K) quantization.

    x: [..., L, D]. The context dim is split into groups of ``group_size``;
    each (group, channel) pair gets its own (scale, zero). L must be a
    multiple of group_size. Returns (q int32 [..., L, D], scale f32 [...,
    L/g, 1, D], zero f32 [..., L/g, 1, D]).
    """
    g = cfg.group_size
    *lead, L, D = x.shape
    if L % g:
        raise ValueError(f"context {L} not divisible by group {g}")
    xg = x.reshape(*lead, L // g, g, D)
    q, safe, lo = _quantize(xg, xg.amin(dim=-2, keepdim=True),
                            xg.amax(dim=-2, keepdim=True), cfg)
    return q.reshape(*lead, L, D), safe, lo


def dequantize_channelwise(q, scale, zero, group_size: int, dtype=torch.float32):
    *lead, L, D = q.shape
    qg = q.reshape(*lead, L // group_size, group_size, D).to(torch.float32)
    return (qg * scale + zero).reshape(*lead, L, D).to(dtype)


def quantize(x: torch.Tensor, cfg: QuantConfig):
    if cfg.granularity == "token":
        return quantize_tokenwise(x, cfg)
    if cfg.granularity == "channel":
        return quantize_channelwise(x, cfg)
    raise ValueError(f"unknown granularity {cfg.granularity!r}")


def dequantize(q, scale, zero, cfg: QuantConfig, dtype=torch.float32):
    if cfg.granularity == "token":
        return dequantize_tokenwise(q, scale, zero, dtype)
    if cfg.granularity == "channel":
        return dequantize_channelwise(q, scale, zero, cfg.group_size, dtype)
    raise ValueError(f"unknown granularity {cfg.granularity!r}")


def max_relative_error(x: torch.Tensor, cfg: QuantConfig) -> float:
    """max |x - deq| / scale: at most 0.5 (+ rounding)."""
    q, s, z = quantize(x, cfg)
    deq = dequantize(q, s, z, cfg)
    if cfg.granularity == "channel":
        return float(torch.max(torch.abs(deq - x)
                               / torch.clamp(torch.max(s), min=1e-30)))
    return float(torch.max(torch.abs(deq - x) / torch.clamp(s, min=1e-30)))
