"""One tier's weighted-V output w . V_int over the tier-packed V cache:
K4 over the dense cache, K7 over the page pool.

The torch port of ``repro/kernels/vpack_matvec.py::vpack_tier_out`` (K4)
and ``::vpack_tier_out_paged`` (K7), the paper's standalone V
matrix-vector kernel (Fig. 11). Each wrapper launches, on CUDA tensors,
the hand-written CUDA kernel of ``csrc/tier_matvec.cu`` (bound in
``kpack_matvec.py``); on CPU tensors, and only there, it runs its plain
version (``vpack_tier_out_torch`` / ``vpack_tier_out_paged_torch``, the
Pallas kernels' tile loop, accumulating over tiles in order). The
per-token V scale is folded into ``w`` and the zero term added outside
(``kernels/ops.py``). Each wrapper counts its kernel launches in
``.launches``.
"""
from __future__ import annotations

import torch

from ..core.tiered import TierBuffer
from .kpack_matvec import (
    DEFAULT_TILE_L,
    _check_paged_tier,
    _library,
    _live_mask,
    _n_live,
    _tier_len,
    _tier_params,
)
from .packed_attention import _check_tiling, _launch, _paged_tile, _tier_window
from .unpack import decode_tier_tile


def _out_tiles(tile, w, n_valid, L: int, tile_l: int, width: int, pack: int,
               C: int) -> torch.Tensor:
    """The Pallas kernels' tile loop, every row at once: weights at or past
    n_valid count as zero, tiles past every row's count are skipped, and
    the tiles' products are summed in order. Returns f32 [BH, G, C]."""
    BH, G, _ = w.shape
    n = None if n_valid is None else n_valid.to(torch.int64)
    out = torch.zeros((BH, G, C), dtype=torch.float32, device=w.device)
    for t0 in range(0, _n_live(n, L), tile_l):
        vals = decode_tier_tile(*tile(t0), width, pack)  # [BH, C, TL]
        wt = w[..., t0:t0 + tile_l].to(torch.float32)
        if n is not None:
            wt = torch.where(_live_mask(n, t0, tile_l), wt, 0.0)
        out = out + torch.bmm(wt, vals.transpose(1, 2))
    return out


def vpack_tier_out_torch(payload, mins, shifts, w, *, width: int,
                         pack_size: int, n_valid=None,
                         tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """Plain PyTorch version of K4. Arguments and result as
    ``vpack_tier_out``."""
    L = _tier_len(payload, width)
    tile_l = _check_tiling(L, pack_size, tile_l)
    t = TierBuffer(payload, mins, shifts, width, pack_size)
    tile = lambda t0: tuple(leaf[..., s] for leaf, s in
                            zip((payload, mins, shifts), _tier_window(t, t0, tile_l)))
    return _out_tiles(tile, w, n_valid, L, tile_l, width, pack_size,
                      payload.shape[-2])


def vpack_tier_out_paged_torch(payload, mins, shifts, w, page_table, n_valid,
                               *, width: int, pack_size: int, page_size: int,
                               tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """Plain PyTorch version of K7: K4's tile loop with each tile's
    physical page resolved through ``page_table``. Arguments and result as
    ``vpack_tier_out_paged``."""
    n_tokens = w.shape[-1]
    tile_l = _check_paged_tier(payload, page_table, n_tokens, width,
                               pack_size, page_size, tile_l)
    t = TierBuffer(payload, mins, shifts, width, pack_size)
    tile = lambda t0: _paged_tile(t, t0, tile_l, page_table, page_size)
    return _out_tiles(tile, w, n_valid, n_tokens, tile_l, width, pack_size,
                      payload.shape[-2])


def vpack_tier_out(payload: torch.Tensor, mins: torch.Tensor,
                   shifts: torch.Tensor, w: torch.Tensor, *, width: int,
                   pack_size: int, n_valid: torch.Tensor | None = None,
                   tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """K4: one tier's weighted-V output (tier channel order, the V scale
    folded into ``w``), in ONE kernel launch.

    payload: int32 [BH, C, L*width/32]; mins: i8 [BH, C, L/pack]; shifts:
    u8 [BH, C, ceil(L/pack/4)]; w: f32 [BH, G, L] whose rows start on
    16-byte boundaries (the kernel reads float4); n_valid: optional int
    [BH] (weights at or past it count as zero, and those tokens are never
    decoded). Returns out f32 [BH, G, C], summed in a fixed order (two
    launches are bitwise equal).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronization) or raise.
    """
    if not w.is_cuda:
        return vpack_tier_out_torch(payload, mins, shifts, w, width=width,
                                    pack_size=pack_size, n_valid=n_valid,
                                    tile_l=tile_l)
    L = _tier_len(payload, width)
    _check_tiling(L, pack_size, tile_l)
    BH, G = w.shape[:2]
    out = torch.empty((BH, G, payload.shape[-2]), dtype=torch.float32,
                      device=w.device)
    p, keep = _tier_params(payload, mins, shifts, w, n_valid, out, width=width,
                           pack_size=pack_size, L=L, units=L, x_len=L, vec4=True)
    if out.numel():
        lib = _library()
        vpack_tier_out.launches += 1
        _launch(lib.vpack_out_launch, p, w, "vpack_tier_out")
    return out


vpack_tier_out.launches = 0


def vpack_tier_out_paged(payload: torch.Tensor, mins: torch.Tensor,
                         shifts: torch.Tensor, w: torch.Tensor,
                         page_table: torch.Tensor, n_valid: torch.Tensor, *,
                         width: int, pack_size: int, page_size: int,
                         tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """K7: K4 over a PAGED pool in ONE kernel launch.

    payload/mins/shifts: pool leaves [H_kv, n_pool_pages, C, ·] of one
    page each; w: f32 [BH, G, n_tokens] (n_tokens a whole number of
    pages); page_table: int32 [B, max_pages]; n_valid: int [BH]. Returns
    out f32 [BH, G, C], bitwise equal to ``vpack_tier_out`` on the
    gathered dense view.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if not w.is_cuda:
        return vpack_tier_out_paged_torch(
            payload, mins, shifts, w, page_table, n_valid, width=width,
            pack_size=pack_size, page_size=page_size, tile_l=tile_l)
    n_tokens = w.shape[-1]
    _check_paged_tier(payload, page_table, n_tokens, width, pack_size,
                      page_size, tile_l)
    BH, G = w.shape[:2]
    out = torch.empty((BH, G, payload.shape[-2]), dtype=torch.float32,
                      device=w.device)
    p, keep = _tier_params(payload, mins, shifts, w, n_valid, out, width=width,
                           pack_size=pack_size, L=n_tokens, units=page_size,
                           x_len=n_tokens, page_table=page_table,
                           page_size=page_size, vec4=True)
    if out.numel():
        lib = _library()
        vpack_tier_out_paged.launches += 1
        _launch(lib.vpack_out_paged_launch, p, w, "vpack_tier_out_paged")
    return out


vpack_tier_out_paged.launches = 0
