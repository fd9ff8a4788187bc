"""One tier's integer scores q . K_int^T over the tier-packed K cache:
K3 over the dense cache, K6 over the page pool.

The torch port of ``repro/kernels/kpack_matvec.py::kpack_tier_scores``
(K3) and ``::kpack_tier_scores_paged`` (K6), the paper's standalone K
matrix-vector kernel (Fig. 8). Each wrapper launches, on CUDA tensors, the
hand-written CUDA kernel of ``csrc/tier_matvec.cu`` (one body, templated on
dense or paged addressing, tier width and group size: a block per (row,
256-token span), a producer warp staging q and then the tier's channel
groups into shared memory, by tensor copies where the layout allows, so
the storage rows ``S`` go along for the tensor maps; tier decode from
``csrc/unpack.cuh`` inlined);
on CPU tensors, and only there, it runs its plain version
(``kpack_tier_scores_torch`` / ``kpack_tier_scores_paged_torch``, the
Pallas kernels' tile loop). The per-token scale and zero are folded in
outside, as rank-1 corrections (``kernels/ops.py``). Each wrapper counts
its kernel launches in ``.launches``.

This module also binds ``csrc/tier_matvec.cu`` for ``vpack_matvec.py``
(K4, K7): one library, one parameter struct.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.tiered import TierBuffer
from .packed_attention import (
    SPAN,
    _check,
    _check_paged,
    _check_tiling,
    _launch,
    _paged_tile,
    _tier_window,
)
from .unpack import _check_width, decode_tier_tile

DEFAULT_TILE_L = 256
MAX_G = 8  # csrc/tier_matvec.cu limits
MAX_C = 256


def _tier_len(payload: torch.Tensor, width: int) -> int:
    """Tokens a tier's payload covers (its last axis)."""
    _check_width(width)
    return payload.shape[-1] * (32 // width)


def _live_mask(n, t0: int, tile_l: int) -> torch.Tensor:
    """[BH, 1, TL]: token t0 + j is below its row's count ``n`` [BH]."""
    gidx = torch.arange(t0, t0 + tile_l, device=n.device)
    return (gidx[None, :] < n[:, None])[:, None, :]


def _n_live(n, L: int) -> int:
    """Tokens to walk: rows' largest count (all L when unmasked); the tiles
    past it are dead in every row, never decoded."""
    if n is None:
        return L
    return min(int(n.max()), L) if n.numel() else 0


def _scores_tiles(tile, q, n_valid, L: int, tile_l: int, width: int,
                  pack: int) -> torch.Tensor:
    """The Pallas kernels' tile loop, every row at once. ``tile(t0)`` gives
    the tier's (payload, mins, shifts) at the tile from token ``t0`` as
    [BH, C, ·]. Returns si f32 [BH, G, L], zero at and past n_valid."""
    BH, G, _ = q.shape
    n = None if n_valid is None else n_valid.to(torch.int64)
    si = torch.zeros((BH, G, L), dtype=torch.float32, device=q.device)
    for t0 in range(0, _n_live(n, L), tile_l):
        out = torch.bmm(q.to(torch.float32), decode_tier_tile(*tile(t0), width, pack))
        if n is not None:
            out = torch.where(_live_mask(n, t0, tile_l), out, 0.0)
        si[..., t0:t0 + tile_l] = out
    return si


def kpack_tier_scores_torch(payload, mins, shifts, q, *, width: int,
                            pack_size: int, n_valid=None,
                            tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """Plain PyTorch version of K3. Arguments and result as
    ``kpack_tier_scores``."""
    L = _tier_len(payload, width)
    tile_l = _check_tiling(L, pack_size, tile_l)
    t = TierBuffer(payload, mins, shifts, width, pack_size)
    tile = lambda t0: tuple(leaf[..., s] for leaf, s in
                            zip((payload, mins, shifts), _tier_window(t, t0, tile_l)))
    return _scores_tiles(tile, q, n_valid, L, tile_l, width, pack_size)


def _check_paged_tier(payload, page_table, n_tokens: int, width: int,
                      pack_size: int, page_size: int, tile_l: int) -> int:
    """K6/K7's rules: those of K5, and at least one page."""
    pool_page = _tier_len(payload, width)
    tile_l = _check_paged(page_table, n_tokens, page_size, pack_size,
                          pool_page, tile_l)
    if n_tokens < page_size:
        raise ValueError(f"{n_tokens} tokens: at least one page of {page_size}")
    return tile_l


def kpack_tier_scores_paged_torch(payload, mins, shifts, q, page_table,
                                  n_valid, n_tokens: int, *, width: int,
                                  pack_size: int, page_size: int,
                                  tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """Plain PyTorch version of K6: K3's tile loop with each tile's
    physical page resolved through ``page_table``. Arguments and result as
    ``kpack_tier_scores_paged``."""
    tile_l = _check_paged_tier(payload, page_table, n_tokens, width,
                               pack_size, page_size, tile_l)
    t = TierBuffer(payload, mins, shifts, width, pack_size)
    tile = lambda t0: _paged_tile(t, t0, tile_l, page_table, page_size)
    return _scores_tiles(tile, q, n_valid, n_tokens, tile_l, width, pack_size)


# ---------------------------------------------------------------------------
# CUDA kernel binding (csrc/tier_matvec.cu, shared with vpack_matvec.py)
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of ``TierMatvecParams`` in csrc/tier_matvec.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("payload", "mins", "shifts")]
        + [(f"{leaf}_s{ax}", ctypes.c_int64)
           for leaf in ("pay", "min", "sft") for ax in "shc"]
        + [("x", ctypes.c_void_p), ("x_sr", ctypes.c_int64),
           ("x_sg", ctypes.c_int64)]
        + [(f, ctypes.c_void_p) for f in ("n_valid", "out", "page_table")]
        + [(f, ctypes.c_int64) for f in ("pt_sb", "page_size", "BH", "Hkv", "G",
                                         "C", "L", "log2_w", "log2_pack")]
        + [(f, ctypes.c_void_p) for f in ("part", "counters")]
        + [("S", ctypes.c_int64)]
    )


_ENTRIES = ("kpack_scores_launch", "kpack_scores_paged_launch",
            "vpack_out_launch", "vpack_out_paged_launch")
_lib = None


def _library():
    """Build (first use) and bind the tier matvec library."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("tier_matvec")
        for fn in (lib.tier_matvec_params_size, lib.tier_matvec_span):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        for name in _ENTRIES:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tier_matvec_smem_bytes.restype = ctypes.c_int
        lib.tier_matvec_smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        size = lib.tier_matvec_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(f"kernel params are {size} bytes in C, "
                               f"{ctypes.sizeof(_Params)} in Python")
        if lib.tier_matvec_span() != SPAN:
            raise RuntimeError(f"the kernels' span is {lib.tier_matvec_span()} "
                               f"tokens, {SPAN} in Python")
        _lib = lib
    return _lib


def tier_smem_bytes(width: int, pack_size: int, C: int, G: int, *,
                    scores: bool) -> int:
    """Dynamic shared memory of one span block of K3/K6 (``scores``) or
    K4/K7 for a tier of ``C`` channels at this width and pack and group
    size G, in bytes (the layout in csrc/tier_matvec.cu)."""
    p = _Params()
    p.G, p.C = G, C
    p.log2_w, p.log2_pack = width.bit_length() - 1, pack_size.bit_length() - 1
    return _library().tier_matvec_smem_bytes(ctypes.addressof(p), int(scores))


def _tier_params(payload, mins, shifts, x, n_valid, out, *, width: int,
                 pack_size: int, L: int, units: int, x_len: int,
                 page_table=None, page_size: int = 0, vec4: bool = False):
    """Check one tier matvec launch's inputs and fill the kernel's struct.

    Dense leaves are [BH, C, ·] over ``units`` = L tokens; pool leaves
    [H_kv, P, C, ·] over ``units`` = one page, with ``page_table`` int32
    [B, max_pages]. ``x`` is q f32 [BH, G, C] (K3/K6) or w f32 [BH, G, L]
    (K4/K7): its last axis has ``x_len`` entries; ``vec4``: the kernel
    reads x as float4. Returns (params, the tensors it points to, which
    the caller keeps alive)."""
    dev = x.device
    BH, G = x.shape[:2]
    paged = page_table is not None
    lead = payload.shape[:-2]
    C = payload.shape[-2]
    if pack_size not in (8, 16):
        raise ValueError(f"pack size {pack_size}: 8 or 16")
    if G > MAX_G or C > MAX_C:
        raise ValueError(f"group {G} / tier channels {C}: the kernel takes "
                         f"<= {MAX_G} / <= {MAX_C}")
    P = units // pack_size
    for leaf, dt, name, n_last in ((payload, torch.int32, "payload", units * width // 32),
                                   (mins, torch.int8, "mins", P),
                                   (shifts, torch.uint8, "shifts", -(-P // 4))):
        _check(leaf, name, dt, dev, 4 if paged else 3)
        if tuple(leaf.shape) != (*lead, C, n_last):
            raise ValueError(f"{name} shape {tuple(leaf.shape)}")
    _check(x, "x", torch.float32, dev, 3)
    if tuple(x.shape) != (BH, G, x_len):
        raise ValueError(f"x shape {tuple(x.shape)}")
    if vec4 and (x.data_ptr() % 16 or x.stride(0) % 4 or x.stride(1) % 4):
        raise ValueError("w must start its rows on 16-byte boundaries "
                         "(the kernel reads it as float4)")
    if paged:
        h_kv = lead[0]
        _check(page_table, "page_table", torch.int32, dev, 2)
        if BH % h_kv or page_table.shape[0] != BH // h_kv:
            raise ValueError(f"{BH} rows over {h_kv} kv heads and a table "
                             f"of {page_table.shape[0]} rows")
    elif lead != (BH,):
        raise ValueError(f"leaves lead with {tuple(lead)}, x with {BH} rows")
    if n_valid is None:
        n = torch.full((BH,), L, dtype=torch.int32, device=dev)
    else:
        n = n_valid.to(device=dev, dtype=torch.int32).contiguous()
    _check(n, "n_valid", torch.int32, dev, 1)
    if n.shape[0] != BH:
        raise ValueError(f"n_valid has {n.shape[0]} rows, x {BH}")

    p = _Params()
    p.payload, p.mins, p.shifts = payload.data_ptr(), mins.data_ptr(), shifts.data_ptr()
    for leaf, pre in ((payload, "pay"), (mins, "min"), (shifts, "sft")):
        st = leaf.stride()
        # storage row (batch row, or pool page), kv head, channel
        ss, sh, sc = (st[1], st[0], st[2]) if paged else (st[0], 0, st[1])
        for ax, stride in zip("shc", (ss, sh, sc)):
            setattr(p, f"{pre}_s{ax}", stride)
    p.x, p.x_sr, p.x_sg = x.data_ptr(), x.stride(0), x.stride(1)
    p.n_valid, p.out = n.data_ptr(), out.data_ptr()
    if paged:
        p.page_table, p.pt_sb, p.page_size = (page_table.data_ptr(),
                                              page_table.stride(0), page_size)
    p.BH, p.Hkv, p.G, p.C, p.L = BH, lead[0] if paged else 1, G, C, L
    p.S = lead[1] if paged else BH  # storage rows: pool pages, or batch rows
    p.log2_w, p.log2_pack = width.bit_length() - 1, pack_size.bit_length() - 1
    return p, (n,)


def kpack_tier_scores(payload: torch.Tensor, mins: torch.Tensor,
                      shifts: torch.Tensor, q: torch.Tensor, *, width: int,
                      pack_size: int, n_valid: torch.Tensor | None = None,
                      tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """K3: integer score contribution of one tier, in ONE kernel launch.

    payload: 32-bit words as int32 [BH, C, L*width/32]; mins: i8 [BH, C,
    L/pack]; shifts: u8 [BH, C, ceil(L/pack/4)]; q: f32 [BH, G, C] (the
    tier's channel slice of the permuted q); n_valid: optional int [BH].
    Returns si f32 [BH, G, L]; columns at or past n_valid are exact
    zeros, and a row's tokens past it are never decoded.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronization) or raise; the leaves may be
    bucket views, read through their strides.
    """
    if not q.is_cuda:
        return kpack_tier_scores_torch(payload, mins, shifts, q, width=width,
                                       pack_size=pack_size, n_valid=n_valid,
                                       tile_l=tile_l)
    L = _tier_len(payload, width)
    _check_tiling(L, pack_size, tile_l)
    BH, G = q.shape[:2]
    out = torch.empty((BH, G, L), dtype=torch.float32, device=q.device)
    p, keep = _tier_params(payload, mins, shifts, q, n_valid, out, width=width,
                           pack_size=pack_size, L=L, units=L,
                           x_len=payload.shape[-2])
    if out.numel():
        lib = _library()
        kpack_tier_scores.launches += 1
        _launch(lib.kpack_scores_launch, p, q, "kpack_tier_scores")
    return out


kpack_tier_scores.launches = 0


def kpack_tier_scores_paged(payload: torch.Tensor, mins: torch.Tensor,
                            shifts: torch.Tensor, q: torch.Tensor,
                            page_table: torch.Tensor, n_valid: torch.Tensor,
                            n_tokens: int, *, width: int, pack_size: int,
                            page_size: int,
                            tile_l: int = DEFAULT_TILE_L) -> torch.Tensor:
    """K6: K3 over a PAGED pool in ONE kernel launch.

    payload/mins/shifts: pool leaves [H_kv, n_pool_pages, C, ·] of one
    page each; q: f32 [BH, G, C]; page_table: int32 [B, max_pages];
    n_valid: int [BH]; n_tokens: the launch bucket, a whole number of
    pages. Each token resolves its physical page through the table; a
    row's tokens at or past n_valid never read it. Returns si f32 [BH, G,
    n_tokens], bitwise equal to ``kpack_tier_scores`` on the gathered
    dense view.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if not q.is_cuda:
        return kpack_tier_scores_paged_torch(
            payload, mins, shifts, q, page_table, n_valid, n_tokens,
            width=width, pack_size=pack_size, page_size=page_size, tile_l=tile_l)
    _check_paged_tier(payload, page_table, n_tokens, width, pack_size,
                      page_size, tile_l)
    BH, G = q.shape[:2]
    out = torch.empty((BH, G, n_tokens), dtype=torch.float32, device=q.device)
    p, keep = _tier_params(payload, mins, shifts, q, n_valid, out, width=width,
                           pack_size=pack_size, L=n_tokens, units=page_size,
                           x_len=payload.shape[-2], page_table=page_table,
                           page_size=page_size)
    if out.numel():
        lib = _library()
        kpack_tier_scores_paged.launches += 1
        _launch(lib.kpack_scores_paged_launch, p, q, "kpack_tier_scores_paged")
    return out


kpack_tier_scores_paged.launches = 0
