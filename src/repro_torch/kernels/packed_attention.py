"""Fused decode attention over the compressed KV cache: K2 over the dense
cache, K5 over the page pool.

The torch port of ``repro/kernels/packed_attention.py::
fused_packed_attention`` (K2) and ``::fused_packed_attention_paged`` (K5).
Each wrapper launches, on CUDA tensors, the hand-written CUDA kernel of
``csrc/packed_attention.cu`` (one body, templated on dense or paged
addressing; tier decode from ``csrc/unpack.cuh`` inlined): a block per
(row, SPAN-token span), the row's last span block merging the spans in
order; on CPU tensors, and only there, it runs its plain version
(``fused_packed_attention_torch`` / ``fused_packed_attention_paged_torch``,
which share the reference's tile loop). ``*_split_torch`` are plain
versions with the kernel's split structure (``_split_partials``). All
return the log-sum-exp partials of attention over the compressed region,
for the merge with the residual buffer in ``kernels/ops.py``. Each wrapper
counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.tiered import TieredCache, gather_page_meta
from .unpack import decode_tier_tile

NEG_INF = -1e30
DEFAULT_TILE_L = 256
SPAN = 256  # tokens per block of the CUDA kernel's split (csrc SPAN)
MAX_TIERS = 6  # csrc/packed_attention.cu limits
MAX_G = 8
MAX_D = 256


def _check_tiling(L: int, pack_size: int, tile_l: int) -> int:
    """The reference's tile rules over ``L`` tokens: tile clamped to L, L a
    multiple of it, the tile a multiple of 4 * pack_size."""
    tile_l = min(tile_l, L)
    if L % tile_l or tile_l % (pack_size * 4):
        raise ValueError(f"context {L} / tile {tile_l} break the tiling "
                         f"rules for pack_size {pack_size}")
    return tile_l


def _rows(n_comp, B: int, device) -> torch.Tensor:
    """Scalar or per-row [B] valid counts -> int32 [B]."""
    n = torch.as_tensor(n_comp, device=device).to(torch.int32)
    return n.expand(B).contiguous() if n.dim() == 0 else n


def _rows_to_bh(n_comp, B: int, h_kv: int, device) -> torch.Tensor:
    """Scalar or per-row [B] valid counts -> the flat [B * H_kv] layout."""
    return _rows(n_comp, B, device)[:, None].expand(B, h_kv).reshape(B * h_kv)


def _prologue(q, kc: TieredCache, n_comp):
    """q permuted by K's chan_perm as [BH, G, D] f32, its per-group sums
    [BH, G] and the valid counts [BH, 1]."""
    B, H, D = q.shape
    h_kv = kc.chan_perm.shape[1]
    qg = q.to(torch.float32).reshape(B, h_kv, H // h_kv, D)
    perm = kc.chan_perm.to(torch.int64)[:, :, None, :].expand_as(qg)
    qf = torch.gather(qg, -1, perm).reshape(B * h_kv, H // h_kv, D)
    return qf, qf.sum(-1), _rows_to_bh(n_comp, B, h_kv, q.device)[:, None]


def _scores(qf, qsum, kc: TieredCache, decode, kscale, kzero, tok, valid,
            sm_scale):
    """Masked scores [BH, G, TL] of the tokens ``tok``: every K tier's
    decoded ints (``decode(tier)``, [BH, C, TL]) against q's channels."""
    offs = kc.spec.offsets()
    si = None
    for i, t in enumerate(kc.tiers):
        d = torch.bmm(qf[..., offs[i]:offs[i + 1]], decode(t))
        si = d if si is None else si + d
    scores = (si * kscale[:, None, tok]
              + qsum[..., None] * kzero[:, None, tok]) * sm_scale
    return torch.where(valid > 0, scores, NEG_INF)


def _weighted_v(acc, ws, vc: TieredCache, decode):
    """acc[..., tier channels] += ws @ V_int^T per V tier, IN PLACE."""
    offs = vc.spec.offsets()
    for i, t in enumerate(vc.tiers):
        acc[..., offs[i]:offs[i + 1]] += torch.bmm(ws, decode(t).transpose(1, 2))
    return acc


def _finish(acc, zsum, m, lsum, vc: TieredCache, B: int, H: int):
    """o = acc + zsum in original channel order (the V inverse
    permutation: o_orig[..., perm[j]] = o[..., j]), m and l as [B, H]."""
    h_kv = vc.chan_perm.shape[1]
    o = (acc + zsum[..., None]).reshape(B, h_kv, H // h_kv, -1)
    vperm = vc.chan_perm.to(torch.int64)[:, :, None, :].expand_as(o)
    o = torch.empty_like(o).scatter_(-1, vperm, o)
    return o.reshape(B, H, -1), m.reshape(B, H), lsum.reshape(B, H)


def _flash_partials(q, kc: TieredCache, vc: TieredCache, n_comp, sm_scale,
                    L: int, tile_l: int, tier_tile, meta):
    """The Pallas kernels' tile loop (flash recurrence over context tiles),
    every (batch, kv-head) row at once; both plain versions run it.

    ``tier_tile(buf, t0)`` gives a tier's (payload, mins, shifts) at the
    tile starting at token ``t0`` as [BH, C, ·]; ``meta`` holds (kscale,
    kzero, vscale, vzero) dense [BH, L]. Returns (o_unnorm [B, H, Dv] in
    original channel order, m [B, H], l [B, H])."""
    B, H = q.shape[:2]
    qf, qsum, n = _prologue(q, kc, n_comp)
    BH, G = qf.shape[:2]
    pack = kc.spec.pack_size
    dev = q.device
    kscale, kzero, vscale, vzero = meta

    acc = torch.zeros((BH, G, vc.spec.head_dim), dtype=torch.float32, device=dev)
    zsum = torch.zeros((BH, G), dtype=torch.float32, device=dev)
    m = torch.full((BH, G), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((BH, G), dtype=torch.float32, device=dev)
    # tiles at or past every row's count are exact no-ops of the recurrence
    n_live = min(int(n.max()), L) if BH else 0
    for t0 in range(0, n_live, tile_l):
        decode = lambda t: decode_tier_tile(*tier_tile(t, t0), t.width, pack)
        tok = slice(t0, t0 + tile_l)
        gidx = torch.arange(t0, t0 + tile_l, device=dev)
        valid = (gidx[None, :] < n).to(torch.float32)[:, None, :]  # [BH,1,TL]
        scores = _scores(qf, qsum, kc, decode, kscale, kzero, tok, valid,
                         sm_scale)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None]) * valid
        lsum = lsum * alpha + p.sum(-1)
        m = m_new
        acc = _weighted_v(acc * alpha[..., None], p * vscale[:, None, tok], vc,
                          decode)
        zsum = zsum * alpha + (p * vzero[:, None, tok]).sum(-1)
    return _finish(acc, zsum, m, lsum, vc, B, H)


def _split_partials(q, kc: TieredCache, vc: TieredCache, n_comp, sm_scale,
                    L: int, window, meta):
    """The CUDA kernel's structure in plain PyTorch: each SPAN-token window
    of a row on its own (one max, one sum: the window's partials), then
    the live windows merged in window order (fixed-order LSE merge).

    ``window(buf, s0, n)`` gives a tier's (payload, mins, shifts) for the
    ``n`` tokens from ``s0`` as [BH, C, ·]; ``meta`` as ``_flash_partials``.
    Every window but a bucket's last holds SPAN tokens whatever L or the
    page size, so the float operations depend on token indices alone."""
    B, H = q.shape[:2]
    qf, qsum, n = _prologue(q, kc, n_comp)
    BH, G = qf.shape[:2]
    pack = kc.spec.pack_size
    dev = q.device
    kscale, kzero, vscale, vzero = meta
    Dv = vc.spec.head_dim

    m = torch.full((BH, G), NEG_INF, dtype=torch.float32, device=dev)
    spans = []
    for s0 in range(0, min(int(n.max()), L) if BH else 0, SPAN):
        tl = min(SPAN, L - s0)
        decode = lambda t: decode_tier_tile(*window(t, s0, tl), t.width, pack)
        tok = slice(s0, s0 + tl)
        gidx = torch.arange(s0, s0 + tl, device=dev)
        valid = (gidx[None, :] < n).to(torch.float32)[:, None, :]
        scores = _scores(qf, qsum, kc, decode, kscale, kzero, tok, valid,
                         sm_scale)
        m_s = scores.amax(-1)
        p = torch.exp(scores - m_s[..., None]) * valid
        acc_s = torch.zeros((BH, G, Dv), dtype=torch.float32, device=dev)
        acc_s = _weighted_v(acc_s, p * vscale[:, None, tok], vc, decode)
        live = s0 < n  # [BH, 1]
        spans.append((m_s, p.sum(-1), (p * vzero[:, None, tok]).sum(-1), acc_s, live))
        m = torch.where(live, torch.maximum(m, m_s), m)
    acc = torch.zeros((BH, G, Dv), dtype=torch.float32, device=dev)
    zsum = torch.zeros((BH, G), dtype=torch.float32, device=dev)
    lsum = torch.zeros((BH, G), dtype=torch.float32, device=dev)
    for m_s, l_s, z_s, acc_s, live in spans:
        a = torch.where(live, torch.exp(m_s - m), 0.0)
        acc = acc + a[..., None] * acc_s
        lsum = lsum + a * l_s
        zsum = zsum + a * z_s
    return _finish(acc, zsum, m, lsum, vc, B, H)


def _tier_window(t, t0: int, tile_l: int):
    """Last-axis slices of a tier's (payload, mins, shifts) holding the
    ``tile_l`` tokens from ``t0`` (the pool-layout contract of
    ``repro/kernels/pallas_utils.py::load_tier_pool_tile``: words, packs
    and shift bytes of the tile)."""
    P0, TP = t0 // t.pack_size, tile_l // t.pack_size
    return (slice(t0 * t.width // 32, (t0 + tile_l) * t.width // 32),
            slice(P0, P0 + TP), slice(P0 // 4, (P0 + TP) // 4))


def _paged_tile(t, t0: int, tile_l: int, page_table: torch.Tensor,
                page_size: int):
    """A pool tier's (payload, mins, shifts) at the tile starting at token
    ``t0`` of every row, as [B * H_kv, C, ·]: the tile's physical page
    resolved through ``page_table`` (int32 [B, max_pages]), then the
    tile's window within that page."""
    B, h_kv = page_table.shape[0], t.payload.shape[0]
    phys = page_table[:, t0 // page_size].to(torch.int64)  # [B]
    w = _tier_window(t, t0 % page_size, tile_l)
    return tuple(
        leaf[..., s][:, phys].transpose(0, 1).reshape(B * h_kv, *leaf.shape[2:-1], -1)
        for leaf, s in zip((t.payload, t.mins, t.shifts), w))


def fused_packed_attention_torch(q: torch.Tensor, kc: TieredCache,
                                 vc: TieredCache, n_comp, sm_scale: float,
                                 *, tile_l: int = DEFAULT_TILE_L):
    """Plain PyTorch version of K2 over the dense cache.

    q: f32 [B, H, D] in ORIGINAL channel order; n_comp: scalar or per-row
    [B]. Returns (o_unnorm [B, H, Dv] in original channel order, m [B, H],
    l [B, H]).
    """
    B = q.shape[0]
    h_kv = kc.scale.shape[-2]
    L = kc.capacity
    tile_l = _check_tiling(L, kc.spec.pack_size, tile_l)
    flat = lambda a: a.reshape(B * h_kv, *a.shape[2:])

    def tier_tile(t, t0):
        w = _tier_window(t, t0, tile_l)
        return tuple(flat(leaf)[..., s] for leaf, s in
                     zip((t.payload, t.mins, t.shifts), w))

    meta = tuple(flat(a) for a in (kc.scale, kc.zero, vc.scale, vc.zero))
    return _flash_partials(q, kc, vc, n_comp, sm_scale, L, tile_l, tier_tile,
                           meta)


def _check_paged(page_table, n_tokens: int, page_size: int, pack_size: int,
                 pool_page: int, tile_l: int) -> int:
    """The paged kernels' tiling rules: tiles never straddle a page, the
    launch covers whole pages of the table, the pool's pages hold
    ``pool_page`` tokens. Returns the tile."""
    tile_l = min(tile_l, page_size)
    if page_size % tile_l or tile_l % (pack_size * 4):
        raise ValueError(f"page {page_size} / tile {tile_l} break the tiling "
                         f"rules for pack_size {pack_size}")
    if n_tokens % page_size or n_tokens // page_size > page_table.shape[-1]:
        raise ValueError(f"{n_tokens} tokens are not whole pages of "
                         f"{page_size} within the table's "
                         f"{page_table.shape[-1]}")
    if pool_page != page_size:
        raise ValueError(f"pool pages hold {pool_page} tokens, not {page_size}")
    return tile_l


def fused_packed_attention_paged_torch(q: torch.Tensor, kc: TieredCache,
                                       vc: TieredCache, page_table, n_comp,
                                       n_tokens: int, sm_scale: float, *,
                                       page_size: int,
                                       tile_l: int = DEFAULT_TILE_L):
    """Plain PyTorch version of K5 over the page pool: the Pallas kernel's
    tile loop with each tile's physical page resolved through
    ``page_table`` (int32 [B, max_pages]); the per-token scale/zero are
    gathered dense first (``gather_page_meta``), as the reference does.
    Arguments and results as ``fused_packed_attention_paged``."""
    B = q.shape[0]
    h_kv = kc.scale.shape[0]
    tile_l = _check_paged(page_table, n_tokens, page_size, kc.spec.pack_size,
                          kc.scale.shape[-1], tile_l)
    tier_tile = lambda t, t0: _paged_tile(t, t0, tile_l, page_table, page_size)
    meta = tuple(gather_page_meta(a, page_table, n_tokens, page_size)
                 .reshape(B * h_kv, n_tokens)
                 for a in (kc.scale, kc.zero, vc.scale, vc.zero))
    return _flash_partials(q, kc, vc, n_comp, sm_scale, n_tokens, tile_l,
                           tier_tile, meta)


def fused_packed_attention_split_torch(q: torch.Tensor, kc: TieredCache,
                                       vc: TieredCache, n_comp,
                                       sm_scale: float):
    """Plain PyTorch version of K2 with the CUDA kernel's split structure
    (``_split_partials``): SPAN-token windows merged in window order.
    Arguments and results as ``fused_packed_attention_torch``; within
    f32 rounding of it, bitwise equal over any bucket that holds every
    row's count (buckets a multiple of SPAN) and to
    ``fused_packed_attention_paged_split_torch`` on the pages."""
    B = q.shape[0]
    h_kv = kc.scale.shape[-2]
    L = kc.capacity
    _check_tiling(L, kc.spec.pack_size, DEFAULT_TILE_L)
    flat = lambda a: a.reshape(B * h_kv, *a.shape[2:])

    def window(t, s0, n):
        return tuple(flat(leaf)[..., s] for leaf, s in
                     zip((t.payload, t.mins, t.shifts), _tier_window(t, s0, n)))

    meta = tuple(flat(a) for a in (kc.scale, kc.zero, vc.scale, vc.zero))
    return _split_partials(q, kc, vc, n_comp, sm_scale, L, window, meta)


def fused_packed_attention_paged_split_torch(q: torch.Tensor, kc: TieredCache,
                                             vc: TieredCache, page_table, n_comp,
                                             n_tokens: int, sm_scale: float, *,
                                             page_size: int):
    """Plain PyTorch version of K5 with the CUDA kernel's split structure:
    each window's tiers gathered from its pages (runs of ``min(SPAN,
    page_size)`` tokens, each resolving its page through ``page_table``).
    Arguments and results as ``fused_packed_attention_paged_torch``."""
    B = q.shape[0]
    h_kv = kc.scale.shape[0]
    _check_paged(page_table, n_tokens, page_size, kc.spec.pack_size,
                 kc.scale.shape[-1], DEFAULT_TILE_L)
    run = min(SPAN, page_size)

    def window(t, s0, n):
        pieces = [_paged_tile(t, r0, run, page_table, page_size)
                  for r0 in range(s0, s0 + n, run)]
        return tuple(torch.cat(leaf, -1) for leaf in zip(*pieces))

    meta = tuple(gather_page_meta(a, page_table, n_tokens, page_size)
                 .reshape(B * h_kv, n_tokens)
                 for a in (kc.scale, kc.zero, vc.scale, vc.zero))
    return _split_partials(q, kc, vc, n_comp, sm_scale, n_tokens, window, meta)


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------


class _TierDesc(ctypes.Structure):
    _fields_ = [("payload", ctypes.c_void_p), ("mins", ctypes.c_void_p),
                ("shifts", ctypes.c_void_p), ("log2_w", ctypes.c_int64),
                ("count", ctypes.c_int64)] + [
        (f"{leaf}_s{ax}", ctypes.c_int64)
        for leaf in ("pay", "min", "sft") for ax in "bhc"]


_ROW_TENSORS = ("kperm", "vperm", "kscale", "kzero", "vscale", "vzero")


class _Params(ctypes.Structure):
    """Mirror of ``PackedAttnParams`` in csrc/packed_attention.cu."""

    _fields_ = (
        [("k", _TierDesc * MAX_TIERS), ("v", _TierDesc * MAX_TIERS),
         ("nk", ctypes.c_int64), ("nv", ctypes.c_int64), ("q", ctypes.c_void_p)]
        + [(f"{n}{s}", ctypes.c_int64 if s else ctypes.c_void_p)
           for n in _ROW_TENSORS for s in ("", "_sb", "_sh")]
        + [(f, ctypes.c_void_p) for f in
           ("n_comp", "out", "m_out", "l_out", "page_table")]
        + [(f, ctypes.c_int64) for f in ("pt_sb", "page_size", "B", "Hkv", "G",
                                         "D", "Dv", "L", "log2_pack")]
        + [("sm_scale", ctypes.c_double), ("part", ctypes.c_void_p),
           ("counters", ctypes.c_void_p)]
    )


_lib = None
_counters: dict = {}


def _arrivals(device, n: int, owner: str = "attention") -> torch.Tensor:
    """The span blocks' arrival counters for ``n`` rows: zero between
    launches (the block that merges a row resets its counter), one tensor
    per kernel family (``owner``: K2/K5 here, K4/K7 in vpack_matvec.py) and
    device, so launches on one stream at a time."""
    c = _counters.get((owner, device))
    if c is None or c.numel() < n:
        c = _counters[owner, device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                   device=device)
    return c


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("packed_attention")
        lib.packed_attention_params_size.restype = ctypes.c_int
        lib.packed_attention_params_size.argtypes = []
        for fn in (lib.packed_attention_launch, lib.packed_attention_paged_launch):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.packed_attention_span.restype = ctypes.c_int
        lib.packed_attention_span.argtypes = []
        lib.packed_attention_smem_bytes.restype = ctypes.c_int
        lib.packed_attention_smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        size = lib.packed_attention_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(f"kernel params are {size} bytes in C, "
                               f"{ctypes.sizeof(_Params)} in Python")
        if lib.packed_attention_span() != SPAN:
            raise RuntimeError(f"the kernel's span is {lib.packed_attention_span()} "
                               f"tokens, {SPAN} in Python")
        _lib = lib
    return _lib


def kernel_smem_bytes(kc: TieredCache, vc: TieredCache, G: int) -> int:
    """Dynamic shared memory of one span block of K2 / K5 at these specs
    and group size, in bytes (the layout in csrc/packed_attention.cu)."""
    p = _Params()
    for descs, tc in ((p.k, kc), (p.v, vc)):
        for d, w, c in zip(descs, tc.spec.widths, tc.spec.counts):
            d.log2_w, d.count = w.bit_length() - 1, c
    p.nk, p.nv = len(kc.spec.widths), len(vc.spec.widths)
    p.G, p.D, p.Dv = G, kc.spec.head_dim, vc.spec.head_dim
    p.log2_pack, p.L = kc.spec.pack_size.bit_length() - 1, SPAN
    return _library().packed_attention_smem_bytes(ctypes.addressof(p), 0)


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} is not contiguous in its last axis")


def _tier_descs(tc: TieredCache, lead: tuple, device, name: str,
                paged: bool = False):
    """Per-tier descriptors. ``lead``: the leaves' two leading dims, [B,
    H_kv] (dense) or [H_kv, n_pool_pages] (paged); the descriptor's row
    stride is then the batch stride or the page stride."""
    descs = (_TierDesc * MAX_TIERS)()
    for i, t in enumerate(tc.tiers):
        if t.width not in (1, 2, 4, 8, 16):
            raise ValueError(f"{name} tier width {t.width} has no kernel "
                             "decode (widths 1, 2, 4, 8, 16 only)")
        for leaf, dt in ((t.payload, torch.int32), (t.mins, torch.int8),
                         (t.shifts, torch.uint8)):
            _check(leaf, f"{name} tier {i}", dt, device, 4)
            if tuple(leaf.shape[:3]) != (*lead, tc.spec.counts[i]):
                raise ValueError(f"{name} tier {i} shape {tuple(leaf.shape)}")
        d = descs[i]
        d.payload, d.mins, d.shifts = (t.payload.data_ptr(), t.mins.data_ptr(),
                                       t.shifts.data_ptr())
        d.log2_w, d.count = t.width.bit_length() - 1, tc.spec.counts[i]
        for leaf, pre in ((t.payload, "pay"), (t.mins, "min"), (t.shifts, "sft")):
            sr, sh, sc = leaf.stride()[:3]
            if paged:  # [H_kv, P, ...]: the row stride steps a page
                sr, sh = sh, sr
            for ax, stride in zip("bhc", (sr, sh, sc)):
                setattr(d, f"{pre}_s{ax}", stride)
    return descs


def _params(q, kc: TieredCache, vc: TieredCache, n_comp, sm_scale: float,
            L: int, lead: tuple, meta_shape: tuple,
            paged: bool):
    """Check a launch's inputs and fill the kernel's parameter struct.
    Returns (params, out, m, l); the caller keeps every tensor alive."""
    dev = q.device
    B, H, D = q.shape
    h_kv = kc.chan_perm.shape[1]
    Dv = vc.spec.head_dim
    pack = kc.spec.pack_size
    if H % h_kv or H // h_kv > MAX_G:
        raise ValueError(f"{H} query heads over {h_kv} kv heads: the kernel "
                         f"takes group sizes up to {MAX_G}")
    if D > MAX_D or Dv > MAX_D or kc.spec.head_dim != D:
        raise ValueError(f"head dims {D}/{Dv} (the kernel takes <= {MAX_D})")
    if pack not in (8, 16) or vc.spec.pack_size != pack:
        raise ValueError(f"pack sizes {pack}/{vc.spec.pack_size}: 8 or 16")
    if len(kc.tiers) > MAX_TIERS or len(vc.tiers) > MAX_TIERS:
        raise ValueError(f"at most {MAX_TIERS} tiers per tensor")
    if vc.scale.shape != kc.scale.shape:
        raise ValueError(f"K covers {tuple(kc.scale.shape)}, V "
                         f"{tuple(vc.scale.shape)}")
    qf = q.to(torch.float32).contiguous()
    n = _rows(n_comp, B, dev)
    _check(n, "n_comp", torch.int32, dev, 1)
    for name, t in (("k chan_perm", kc.chan_perm), ("v chan_perm", vc.chan_perm)):
        _check(t, name, torch.int32, dev, 3)
        if tuple(t.shape) != (B, h_kv, D):
            raise ValueError(f"{name} shape {tuple(t.shape)}")
    for name, t in (("kscale", kc.scale), ("kzero", kc.zero),
                    ("vscale", vc.scale), ("vzero", vc.zero)):
        _check(t, name, torch.float32, dev, 3)
        if tuple(t.shape) != meta_shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}")

    out = torch.empty((B, H, Dv), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    lsum = torch.empty((B, H), dtype=torch.float32, device=dev)
    # each live span's partials: acc [G, Dv], then m, l, z [G] each
    part = torch.empty((B * h_kv, -(-L // SPAN), H // h_kv * (Dv + 3)),
                       dtype=torch.float32, device=dev)
    p = _Params()
    p.k = _tier_descs(kc, lead, dev, "K", paged)
    p.v = _tier_descs(vc, lead, dev, "V", paged)
    p.nk, p.nv, p.q = len(kc.tiers), len(vc.tiers), qf.data_ptr()
    rows = (kc.chan_perm, vc.chan_perm, kc.scale, kc.zero, vc.scale, vc.zero)
    for i, (name, t) in enumerate(zip(_ROW_TENSORS, rows)):
        sr, sh = t.stride(0), t.stride(1)
        if paged and i >= 2:  # pool metadata [H_kv, P, page]
            sr, sh = sh, sr
        setattr(p, name, t.data_ptr())
        setattr(p, f"{name}_sb", sr)
        setattr(p, f"{name}_sh", sh)
    p.n_comp, p.out, p.m_out, p.l_out = (n.data_ptr(), out.data_ptr(),
                                         m.data_ptr(), lsum.data_ptr())
    p.B, p.Hkv, p.G, p.D, p.Dv, p.L = B, h_kv, H // h_kv, D, Dv, L
    p.log2_pack, p.sm_scale = pack.bit_length() - 1, sm_scale
    p.part = part.data_ptr()
    p.counters = _arrivals(dev, B * h_kv).data_ptr()
    return p, (qf, n, part), out, m, lsum


def _launch(fn, p, q, name: str) -> None:
    rc = fn(ctypes.addressof(p), torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def fused_packed_attention(q: torch.Tensor, kc: TieredCache, vc: TieredCache,
                           n_comp, sm_scale: float, *,
                           tile_l: int = DEFAULT_TILE_L):
    """K2: compressed-region attention partials in ONE kernel launch.

    q: [B, H, D] in ORIGINAL channel order (cast to f32); n_comp: scalar or
    per-row [B]. Returns (o_unnorm [B, H, Dv] in original channel order,
    m [B, H], l [B, H]), all f32.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronization) or raise: the cache may be a
    prefix view (``slice_compressed``) and is read through its strides,
    never copied.
    """
    if not q.is_cuda:
        return fused_packed_attention_torch(q, kc, vc, n_comp, sm_scale,
                                            tile_l=tile_l)
    B = q.shape[0]
    h_kv = kc.scale.shape[-2]
    L = kc.capacity
    _check_tiling(L, kc.spec.pack_size, tile_l)  # the reference's contract
    p, keep, out, m, lsum = _params(q, kc, vc, n_comp, sm_scale, L,
                                    (B, h_kv), (B, h_kv, L), paged=False)
    lib = _library()
    fused_packed_attention.launches += 1
    _launch(lib.packed_attention_launch, p, q, "fused_packed_attention")
    return out, m, lsum


fused_packed_attention.launches = 0


def fused_packed_attention_paged(q: torch.Tensor, kc: TieredCache,
                                 vc: TieredCache, page_table: torch.Tensor,
                                 n_comp, n_tokens: int, sm_scale: float, *,
                                 page_size: int, tile_l: int = DEFAULT_TILE_L):
    """K5: K2 over a PAGED cache in ONE kernel launch.

    kc/vc: pool-layout TieredCaches (leaves [H_kv, n_pool_pages, ...],
    ``chan_perm`` [B, H_kv, D]); page_table: int32 [B, max_pages];
    n_tokens: the launch bucket, a whole number of pages. The kernel
    stages each span in runs that never straddle a page, each run
    resolving its physical page through the table; rows read at most
    ``min(n_comp, n_tokens)`` tokens, so table entries past a row's live
    pages are never read. The tiling rules (``tile_l``) are the
    reference's and are checked; the plain version runs them. Returns the
    same partials as ``fused_packed_attention``, bitwise equal to it on
    the gathered dense view at any page size.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if not q.is_cuda:
        return fused_packed_attention_paged_torch(
            q, kc, vc, page_table, n_comp, n_tokens, sm_scale,
            page_size=page_size, tile_l=tile_l)
    _check_paged(page_table, n_tokens, page_size, kc.spec.pack_size,
                 kc.scale.shape[-1], tile_l)
    B = q.shape[0]
    h_kv, P = kc.scale.shape[:2]
    _check(page_table, "page_table", torch.int32, q.device, 2)
    if page_table.shape[0] != B:
        raise ValueError(f"page_table has {page_table.shape[0]} rows, q {B}")
    p, keep, out, m, lsum = _params(q, kc, vc, n_comp, sm_scale, n_tokens,
                                    (h_kv, P), (h_kv, P, page_size), paged=True)
    p.page_table, p.pt_sb, p.page_size = (page_table.data_ptr(),
                                          page_table.stride(0), page_size)
    lib = _library()
    fused_packed_attention_paged.launches += 1
    _launch(lib.packed_attention_paged_launch, p, q,
            "fused_packed_attention_paged")
    return out, m, lsum


fused_packed_attention_paged.launches = 0
