"""Tier-tile decompression (K1), plain PyTorch version.

The torch port of ``repro/kernels/unpack.py``. On the GPU this function
is not a launch of its own: ``csrc/unpack.cuh`` holds it as a
``__device__`` function inlined into the fused attention kernel. This
version is what the plain attention path and the tests run. Leading
dims are allowed (``[..., C, ...]``) so the plain attention decodes
every (batch, head) row at once.
"""
from __future__ import annotations

import torch


def _check_width(width: int) -> None:
    if not (width >= 1 and 32 % width == 0):
        raise ValueError(f"tier width {width} has no kernel decode "
                         "(widths 1, 2, 4, 8, 16 only)")


def unpack_words_2d(words: torch.Tensor, width: int) -> torch.Tensor:
    """int32 words [..., C, Wl] -> int32 [..., C, Wl * (32//width)]."""
    _check_width(width)
    vpw = 32 // width
    offs = torch.arange(vpw, device=words.device, dtype=torch.int64) * width
    w = words.to(torch.int64) & 0xFFFFFFFF
    vals = (w[..., None] >> offs) & ((1 << width) - 1)
    return vals.reshape(*words.shape[:-1], words.shape[-1] * vpw).to(torch.int32)


def unpack_shifts_2d(shift_bytes: torch.Tensor, n_packs: int) -> torch.Tensor:
    """u8 [..., C, ceil(P/4)] -> int32 [..., C, P] 2-bit shift fields."""
    sb = shift_bytes.to(torch.int32)
    offs = torch.arange(4, device=sb.device, dtype=torch.int32) * 2
    sh = (sb[..., None] >> offs) & 3
    return sh.reshape(*sb.shape[:-1], sb.shape[-1] * 4)[..., :n_packs]


def broadcast_packwise(per_pack: torch.Tensor, pack_size: int) -> torch.Tensor:
    """[..., C, P] -> [..., C, P*pack_size] repeating each pack value."""
    return torch.repeat_interleave(per_pack, pack_size, dim=-1)


def decode_tier_tile(payload: torch.Tensor, mins: torch.Tensor,
                     shift_bytes: torch.Tensor, width: int,
                     pack_size: int) -> torch.Tensor:
    """Decode one tier tile to integer values, as f32.

    payload:     int32 [..., C, TL*width/32] (uint32 bits)
    mins:        i8    [..., C, TL/pack_size]
    shift_bytes: u8    [..., C, ceil(TL/pack_size/4)]
    Returns f32 [..., C, TL]: ``(stored << shift) + half + min`` with the
    mid-rise ``half = 2^(shift-1)`` (0 when shift is 0).
    """
    stored = unpack_words_2d(payload, width)
    P = stored.shape[-1] // pack_size
    sh = broadcast_packwise(unpack_shifts_2d(shift_bytes, P), pack_size)
    mn = broadcast_packwise(mins.to(torch.int32), pack_size)
    half = torch.where(sh > 0, 1 << torch.clamp(sh - 1, min=0),
                       torch.zeros_like(sh))
    return ((stored << sh) + half + mn).to(torch.float32)
