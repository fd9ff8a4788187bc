"""Single-launch fused decode attention over the compressed KV cache (K2).

The torch port of ``repro/kernels/packed_attention.py::
fused_packed_attention``. ``fused_packed_attention`` is the kernel
wrapper: on CUDA tensors it launches the hand-written CUDA kernel of
``csrc/packed_attention.cu`` (tier decode from ``csrc/unpack.cuh``
inlined); on CPU tensors, and only there, it runs the plain version
``fused_packed_attention_torch``. Both return the log-sum-exp partials of
attention over the compressed region, for the merge with the residual
buffer in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.tiered import TieredCache
from .unpack import decode_tier_tile

NEG_INF = -1e30
DEFAULT_TILE_L = 256
MAX_TIERS = 6  # csrc/packed_attention.cu limits
MAX_G = 8
MAX_D = 256


def _check_tiling(kc: TieredCache, tile_l: int) -> int:
    """The reference's tile rules: tile clamped to L, L a multiple of it,
    the tile a multiple of 4 * pack_size."""
    L = kc.capacity
    tile_l = min(tile_l, L)
    if L % tile_l or tile_l % (kc.spec.pack_size * 4):
        raise ValueError(f"context {L} / tile {tile_l} break the tiling "
                         f"rules for pack_size {kc.spec.pack_size}")
    return tile_l


def _rows(n_comp, B: int, device) -> torch.Tensor:
    """Scalar or per-row [B] valid counts -> int32 [B]."""
    n = torch.as_tensor(n_comp, device=device).to(torch.int32)
    return n.expand(B).contiguous() if n.dim() == 0 else n


def _rows_to_bh(n_comp, B: int, h_kv: int, device) -> torch.Tensor:
    """Scalar or per-row [B] valid counts -> the flat [B * H_kv] layout."""
    return _rows(n_comp, B, device)[:, None].expand(B, h_kv).reshape(B * h_kv)


def fused_packed_attention_torch(q: torch.Tensor, kc: TieredCache,
                                 vc: TieredCache, n_comp, sm_scale: float,
                                 *, tile_l: int = DEFAULT_TILE_L):
    """Plain PyTorch version of the kernel: the Pallas kernel's tile loop
    (flash recurrence over context tiles), every (batch, kv-head) row at
    once.

    q: f32 [B, H, D] in ORIGINAL channel order; n_comp: scalar or per-row
    [B]. Returns (o_unnorm [B, H, Dv] in original channel order, m [B, H],
    l [B, H]).
    """
    B, H, D = q.shape
    h_kv = kc.scale.shape[-2]
    G = H // h_kv
    BH = B * h_kv
    L = kc.capacity
    tile_l = _check_tiling(kc, tile_l)
    pack = kc.spec.pack_size
    Dv = vc.spec.head_dim
    dev = q.device

    qg = q.to(torch.float32).reshape(B, h_kv, G, D)
    perm = kc.chan_perm.to(torch.int64)[:, :, None, :].expand_as(qg)
    qf = torch.gather(qg, -1, perm).reshape(BH, G, D)
    qsum = qf.sum(-1)  # [BH, G]
    n = _rows_to_bh(n_comp, B, h_kv, dev)[:, None]  # [BH, 1]
    flat = lambda a: a.reshape(BH, *a.shape[2:])
    k_offs, v_offs = kc.spec.offsets(), vc.spec.offsets()

    acc = torch.zeros((BH, G, Dv), dtype=torch.float32, device=dev)
    zsum = torch.zeros((BH, G), dtype=torch.float32, device=dev)
    m = torch.full((BH, G), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((BH, G), dtype=torch.float32, device=dev)
    # tiles at or past every row's count are exact no-ops of the recurrence
    n_live = min(int(n.max()), L) if BH else 0
    for t0 in range(0, n_live, tile_l):
        P0, TP = t0 // pack, tile_l // pack

        def decode(t):
            w = t.width
            return decode_tier_tile(
                flat(t.payload)[..., t0 * w // 32:(t0 + tile_l) * w // 32],
                flat(t.mins)[..., P0:P0 + TP],
                flat(t.shifts)[..., P0 // 4:(P0 + TP) // 4], w, pack)

        si = None
        for i, t in enumerate(kc.tiers):
            d = torch.bmm(qf[..., k_offs[i]:k_offs[i + 1]], decode(t))
            si = d if si is None else si + d  # [BH, G, TL]
        tok = slice(t0, t0 + tile_l)
        scores = (si * flat(kc.scale)[:, None, tok]
                  + qsum[..., None] * flat(kc.zero)[:, None, tok]) * sm_scale
        gidx = torch.arange(t0, t0 + tile_l, device=dev)
        valid = (gidx[None, :] < n).to(torch.float32)[:, None, :]  # [BH,1,TL]
        scores = torch.where(valid > 0, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None]) * valid
        lsum = lsum * alpha + p.sum(-1)
        m = m_new
        ws = p * flat(vc.scale)[:, None, tok]
        acc = acc * alpha[..., None]
        for i, t in enumerate(vc.tiers):
            acc[..., v_offs[i]:v_offs[i + 1]] += torch.bmm(ws, decode(t).transpose(1, 2))
        zsum = zsum * alpha + (p * flat(vc.zero)[:, None, tok]).sum(-1)

    o = (acc + zsum[..., None]).reshape(B, h_kv, G, Dv)
    # V inverse permutation: o_orig[..., perm[j]] = o[..., j]
    vperm = vc.chan_perm.to(torch.int64)[:, :, None, :].expand_as(o)
    o = torch.empty_like(o).scatter_(-1, vperm, o)
    return o.reshape(B, H, Dv), m.reshape(B, H), lsum.reshape(B, H)


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
        + [(f, ctypes.c_void_p) for f in ("n_comp", "out", "m_out", "l_out")]
        + [(f, ctypes.c_int64) for f in
           ("B", "Hkv", "G", "D", "Dv", "L", "log2_pack", "tile_l")]
        + [("sm_scale", ctypes.c_double)]
    )


_lib = None


def _library():
    """Build (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("packed_attention")
        lib.packed_attention_params_size.restype = ctypes.c_int
        lib.packed_attention_params_size.argtypes = []
        lib.packed_attention_launch.restype = ctypes.c_int
        lib.packed_attention_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        size = lib.packed_attention_params_size()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(f"kernel params are {size} bytes in C, "
                               f"{ctypes.sizeof(_Params)} in Python")
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} is not contiguous in its last axis")


def _tier_descs(tc: TieredCache, B: int, h_kv: int, device, name: str):
    descs = (_TierDesc * MAX_TIERS)()
    for i, t in enumerate(tc.tiers):
        if t.width not in (1, 2, 4, 8, 16):
            raise ValueError(f"{name} tier width {t.width} has no kernel "
                             "decode (widths 1, 2, 4, 8, 16 only)")
        for leaf, dt in ((t.payload, torch.int32), (t.mins, torch.int8),
                         (t.shifts, torch.uint8)):
            _check(leaf, f"{name} tier {i}", dt, device, 4)
            if tuple(leaf.shape[:3]) != (B, h_kv, tc.spec.counts[i]):
                raise ValueError(f"{name} tier {i} shape {tuple(leaf.shape)}")
        d = descs[i]
        d.payload, d.mins, d.shifts = (t.payload.data_ptr(), t.mins.data_ptr(),
                                       t.shifts.data_ptr())
        d.log2_w, d.count = t.width.bit_length() - 1, tc.spec.counts[i]
        for leaf, pre in ((t.payload, "pay"), (t.mins, "min"), (t.shifts, "sft")):
            for ax, s in zip("bhc", leaf.stride()[:3]):
                setattr(d, f"{pre}_s{ax}", s)
    return descs


def fused_packed_attention(q: torch.Tensor, kc: TieredCache, vc: TieredCache,
                           n_comp, sm_scale: float, *,
                           tile_l: int = DEFAULT_TILE_L):
    """Compressed-region attention partials in ONE kernel launch.

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
    dev = q.device
    B, H, D = q.shape
    h_kv = kc.scale.shape[-2]
    Dv = vc.spec.head_dim
    L = kc.capacity
    tile_l = _check_tiling(kc, tile_l)
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
    if vc.capacity != L:
        raise ValueError(f"K covers {L} tokens, V {vc.capacity}")
    qf = q.to(torch.float32).contiguous()
    n = _rows(n_comp, B, dev)
    _check(n, "n_comp", torch.int32, dev, 1)
    for name, t in (("k chan_perm", kc.chan_perm), ("v chan_perm", vc.chan_perm)):
        _check(t, name, torch.int32, dev, 3)
    for name, t in (("kscale", kc.scale), ("kzero", kc.zero),
                    ("vscale", vc.scale), ("vzero", vc.zero)):
        _check(t, name, torch.float32, dev, 3)
        if tuple(t.shape) != (B, h_kv, L):
            raise ValueError(f"{name} shape {tuple(t.shape)}")

    out = torch.empty((B, H, Dv), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    lsum = torch.empty((B, H), dtype=torch.float32, device=dev)
    p = _Params()
    p.k = _tier_descs(kc, B, h_kv, dev, "K")
    p.v = _tier_descs(vc, B, h_kv, dev, "V")
    p.nk, p.nv, p.q = len(kc.tiers), len(vc.tiers), qf.data_ptr()
    rows = (kc.chan_perm, vc.chan_perm, kc.scale, kc.zero, vc.scale, vc.zero)
    for name, t in zip(_ROW_TENSORS, rows):
        setattr(p, name, t.data_ptr())
        setattr(p, f"{name}_sb", t.stride(0))
        setattr(p, f"{name}_sh", t.stride(1))
    p.n_comp, p.out, p.m_out, p.l_out = (n.data_ptr(), out.data_ptr(),
                                         m.data_ptr(), lsum.data_ptr())
    p.B, p.Hkv, p.G, p.D, p.Dv, p.L = B, h_kv, H // h_kv, D, Dv, L
    p.log2_pack, p.tile_l, p.sm_scale = pack.bit_length() - 1, tile_l, sm_scale
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fused_packed_attention.launches += 1
    rc = lib.packed_attention_launch(ctypes.addressof(p), stream)
    if rc:
        raise RuntimeError(f"fused_packed_attention launch failed: CUDA error {rc}")
    return out, m, lsum


fused_packed_attention.launches = 0
