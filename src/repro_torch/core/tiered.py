"""Static-shape tiered packing: the compute-tier cache format.

The torch port of ``repro/core/tiered.py`` (normative byte spec:
``docs/formats.md``). Channels of each kv-head are bucketed into width
tiers by a per-head channel permutation; within a tier, values are packed
at the tier width into 32-bit words along the context axis, with an int8
``min`` and a 2-bit ``shift`` per pack of ``pack_size`` tokens.

Layout (channels-major), leading dims ``[B, H_kv]``:

  payload[t] : 32-bit words [..., C_t, L*w_t/32]
  mins[t]    : i8  [..., C_t, L/pack]
  shifts[t]  : u8  [..., C_t, ceil(L/pack/4)]

A PAGE POOL (``alloc_tiered_pool``) has the same leaves with leading dims
``[H_kv, n_pool_pages]`` and a token axis of one page; ``chan_perm`` stays
per slot, ``[B, H_kv, D]``. ``gather_tiered_pages`` turns it back into
the dense layout through a page-table prefix.

PyTorch has no shifts on ``uint32``, so payload words are held as
``int32`` with the same bits: packing builds each word in int64 and
reinterprets the low 32 bits, unpacking widens to int64 and masks.
Every byte therefore equals the reference's ``uint32`` word viewed as
``int32``.

Writes (``append_block``, ``append_block_rows``) update the cache tensors
IN PLACE, where the reference returned new arrays from donated buffers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import bits_required, cdiv

PACK = 8  # values per pack
MAX_SHIFT = 3


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Static tier layout for one cache tensor (K or V).

    widths: ascending bit widths, each in {0,1,2,4,8,16}.
    counts: channels per tier; sums to head_dim.
    """

    widths: tuple[int, ...] = (2, 4, 8)
    counts: tuple[int, ...] = (32, 64, 32)
    pack_size: int = PACK

    def __post_init__(self):
        for w in self.widths:
            if not (w == 0 or 32 % w == 0):
                raise ValueError(f"width {w} must divide 32")
        if len(self.widths) != len(self.counts):
            raise ValueError("widths and counts differ in length")
        if tuple(sorted(self.widths)) != tuple(self.widths):
            raise ValueError(f"widths {self.widths} must ascend")

    @property
    def head_dim(self) -> int:
        return sum(self.counts)

    def payload_words(self, tier: int, n_tokens: int) -> int:
        return n_tokens * self.widths[tier] // 32 if self.widths[tier] else 0

    def offsets(self) -> tuple[int, ...]:
        """Channel offsets of the tiers: (0, c0, c0+c1, ..., head_dim)."""
        return (0, *np.cumsum(self.counts).tolist())

    def avg_bits_per_value(self) -> float:
        """Payload + pack metadata bits per value (excl. token meta)."""
        d = self.head_dim
        payload = sum(w * c for w, c in zip(self.widths, self.counts)) / d
        return payload + (8 + 2) / self.pack_size

    @staticmethod
    def for_head_dim(head_dim: int, widths=(2, 4, 8), fracs=(0.25, 0.5, 0.25)):
        if abs(sum(fracs) - 1.0) >= 1e-6:
            raise ValueError(f"fracs {fracs} must sum to 1")
        counts = [int(round(f * head_dim / 8)) * 8 for f in fracs[:-1]]
        counts.append(head_dim - sum(counts))
        return TierSpec(widths=tuple(widths), counts=tuple(counts))


@dataclasses.dataclass
class TierBuffer:
    payload: torch.Tensor  # int32 [..., C_t, L*w/32] (uint32 bits)
    mins: torch.Tensor  # int8  [..., C_t, L/pack]
    shifts: torch.Tensor  # uint8 [..., C_t, ceil(L/pack/4)]
    width: int
    pack_size: int


@dataclasses.dataclass
class TieredCache:
    """One compressed cache tensor (K or V of one layer).

    Leading dims of every tensor are [B, H_kv].
    """

    tiers: tuple[TierBuffer, ...]
    chan_perm: torch.Tensor  # int32 [B, H_kv, D] position -> original channel
    scale: torch.Tensor  # f32 [B, H_kv, L] per-token quant scale
    zero: torch.Tensor  # f32 [B, H_kv, L]
    spec: TierSpec

    @property
    def capacity(self) -> int:
        return self.scale.shape[-1]


# ---------------------------------------------------------------------------
# Packing / unpacking primitives
# ---------------------------------------------------------------------------

_U32 = 1 << 32


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - _U32, x).to(torch.int32)


def pack_words(stored: torch.Tensor, width: int) -> torch.Tensor:
    """Pack integer values (already < 2**width) along the last dim into
    32-bit words. stored: [..., L] -> int32 [..., L*width/32]."""
    if width == 0:
        return torch.zeros(stored.shape[:-1] + (0,), dtype=torch.int32,
                           device=stored.device)
    vpw = 32 // width
    *lead, L = stored.shape
    if L % vpw:
        raise ValueError(f"length {L} is not a multiple of {vpw} values/word")
    s = stored.to(torch.int64).reshape(*lead, L // vpw, vpw)
    offsets = torch.arange(vpw, device=stored.device, dtype=torch.int64) * width
    return _to_i32_bits(torch.sum(s << offsets, dim=-1))


def unpack_words(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Inverse of pack_words: int32 [..., n*width/32] -> int32 [..., n]."""
    if width == 0:
        return torch.zeros(words.shape[:-1] + (n,), dtype=torch.int32,
                           device=words.device)
    vpw = 32 // width
    offsets = torch.arange(vpw, device=words.device, dtype=torch.int64) * width
    w = words.to(torch.int64) & (_U32 - 1)
    vals = (w[..., None] >> offsets) & ((1 << width) - 1)
    return vals.reshape(*words.shape[:-1], n).to(torch.int32)


def pack_shift_fields(shifts: torch.Tensor) -> torch.Tensor:
    """Pack 2-bit shift fields, 4 per uint8. [..., P] -> u8 [..., ceil(P/4)]."""
    *lead, P = shifts.shape
    pad = (-P) % 4
    s = torch.nn.functional.pad(shifts.to(torch.int64), (0, pad))
    s = s.reshape(*lead, (P + pad) // 4, 4)
    offsets = torch.arange(4, device=shifts.device, dtype=torch.int64) * 2
    return torch.sum(s << offsets, dim=-1).to(torch.uint8)


def unpack_shift_fields(packed: torch.Tensor, P: int) -> torch.Tensor:
    """u8 [..., ceil(P/4)] -> int32 [..., P] 2-bit shift fields."""
    idx = torch.arange(P, device=packed.device)
    word = packed.to(torch.int32)[..., idx // 4]
    return (word >> (2 * (idx % 4)).to(torch.int32)) & 3


def pack_tier(q: torch.Tensor, width: int, pack_size: int = PACK) -> TierBuffer:
    """Pack quantized integers of one tier's channels.

    q: int32 [..., C_t, L] channels-major.
    """
    *lead, C, L = q.shape
    if L % pack_size:
        raise ValueError(f"length {L} is not a multiple of pack {pack_size}")
    P = L // pack_size
    qp = q.reshape(*lead, C, P, pack_size)
    mins = qp.amin(dim=-1)
    rng = qp.amax(dim=-1) - mins
    shift = torch.clamp(bits_required(rng) - width, 0, MAX_SHIFT)
    # saturate mins to the i8 field instead of wrapping (docs/formats.md)
    mins = torch.clamp(mins, -128, 127)
    stored = (qp - mins[..., None]) >> shift[..., None]
    stored = torch.clamp(stored, 0, (1 << width) - 1 if width else 0)
    payload = pack_words(stored.reshape(*lead, C, L), width)
    return TierBuffer(
        payload=payload,
        mins=mins.to(torch.int8),
        shifts=pack_shift_fields(shift),
        width=width,
        pack_size=pack_size,
    )


def unpack_tier(buf: TierBuffer, L: int) -> torch.Tensor:
    """Reconstruct quantized integers: int32 [..., C_t, L] (mid-rise)."""
    pack_size = buf.pack_size
    P = L // pack_size
    stored = unpack_words(buf.payload, buf.width, L)
    *lead, C, _ = stored.shape
    stored = stored.reshape(*lead, C, P, pack_size)
    shift = unpack_shift_fields(buf.shifts, P)[..., None]
    mins = buf.mins.to(torch.int32)[..., None]
    half = torch.where(shift > 0, 1 << torch.clamp(shift - 1, min=0),
                       torch.zeros_like(shift))
    q = (stored << shift) + half + mins
    return q.reshape(*lead, C, L)


# ---------------------------------------------------------------------------
# Channel tier assignment (calibration)
# ---------------------------------------------------------------------------


def required_channel_widths(q: torch.Tensor, pack_size: int = PACK) -> torch.Tensor:
    """Max per-pack width needed by each channel. q: [..., C, L] -> [..., C]."""
    *lead, C, L = q.shape
    qp = q.reshape(*lead, C, L // pack_size, pack_size)
    rng = qp.amax(dim=-1) - qp.amin(dim=-1)
    return bits_required(rng).amax(dim=-1)


def assign_channel_tiers(widths: torch.Tensor, spec: TierSpec) -> torch.Tensor:
    """Channel permutation: ascending required width fills tiers in order.

    widths: [..., D] -> perm int32 [..., D]; perm[i] = original channel at
    packed position i (stable for equal widths).
    """
    return torch.argsort(widths, dim=-1, stable=True).to(torch.int32)


def choose_tier_spec(
    widths,
    candidates: tuple[int, ...] = (1, 2, 4, 8),
    pack_size: int = PACK,
    align: int = 8,
    slack: int = 0,
) -> TierSpec:
    """Pick STATIC tier widths/counts from calibrated channel widths
    (host-side numpy, once at engine build; see the reference docstring).

    widths: [..., D] required per-channel widths; leading dims are pooled
    worst-case per channel RANK.
    """
    if isinstance(widths, torch.Tensor):
        widths = widths.cpu().numpy()
    w = np.asarray(widths)
    D = w.shape[-1]
    rank_w = np.sort(w.reshape(-1, D), axis=1).max(axis=0)
    need = int(rank_w.max())
    cands = [c for c in candidates if c < need + 1] or [candidates[0]]
    top = min([c for c in candidates if c >= need] or [max(candidates)])
    if top not in cands:
        cands.append(top)
    specs: list[tuple[int, int]] = []
    offs = 0
    for c in cands[:-1]:
        n = int((rank_w <= c + slack).sum())
        n = (n // align) * align
        take = max(0, n - offs)
        if take:
            specs.append((c, take))
            offs += take
    if D - offs:
        specs.append((cands[-1], D - offs))
    return TierSpec(
        widths=tuple(c for c, _ in specs),
        counts=tuple(n for _, n in specs),
        pack_size=pack_size,
    )


def chan_inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    """inv[..., perm[..., i]] = i."""
    D = perm.shape[-1]
    inv = torch.empty_like(perm)
    src = torch.arange(D, device=perm.device, dtype=perm.dtype).expand_as(perm)
    return inv.scatter_(-1, perm.to(torch.int64), src)


# ---------------------------------------------------------------------------
# Whole-cache helpers
# ---------------------------------------------------------------------------


def split_tiers(x: torch.Tensor, spec: TierSpec, dim: int = -2):
    """Split a channels-major tensor into per-tier chunks along ``dim``."""
    return torch.split(x, list(spec.counts), dim=dim)


def pack_tiered(
    q_chan_major: torch.Tensor,
    chan_perm: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    spec: TierSpec,
) -> TieredCache:
    """Pack a full quantized tensor into a TieredCache.

    q_chan_major: int32 [..., H_kv, D, L] (original channel order).
    chan_perm:    int32 [..., H_kv, D] from assign_channel_tiers.
    scale, zero:  f32 [..., H_kv, L].
    """
    idx = chan_perm.to(torch.int64)[..., None].expand_as(q_chan_major)
    qp = torch.gather(q_chan_major, -2, idx)
    tiers = tuple(
        pack_tier(chunk, w, spec.pack_size)
        for chunk, w in zip(split_tiers(qp, spec), spec.widths)
    )
    return TieredCache(tiers=tiers, chan_perm=chan_perm, scale=scale,
                       zero=zero, spec=spec)


def unpack_tiered(cache: TieredCache) -> torch.Tensor:
    """int32 [..., H_kv, D, L] in TIER order (apply chan_perm to undo)."""
    L = cache.capacity
    return torch.cat([unpack_tier(t, L) for t in cache.tiers], dim=-2)


def dequantize_tiered(cache: TieredCache, dtype=torch.float32) -> torch.Tensor:
    """Dense [..., H_kv, D, L] in ORIGINAL channel order (oracle path)."""
    q = unpack_tiered(cache).to(torch.float32)
    x = q * cache.scale[..., None, :] + cache.zero[..., None, :]
    inv = chan_inverse_perm(cache.chan_perm).to(torch.int64)
    return torch.gather(x, -2, inv[..., None].expand_as(x)).to(dtype)


def tiered_bits_per_value(spec: TierSpec, head_dim: int | None = None) -> float:
    """Compute-tier bits/value incl. pack + token metadata (16-bit scale
    and zero per (token, head), as the paper counts them)."""
    d = head_dim or spec.head_dim
    return spec.avg_bits_per_value() + 32.0 / d


def alloc_tiered(batch: int, h_kv: int, capacity: int, spec: TierSpec,
                 device="cuda") -> TieredCache:
    """Preallocate an empty TieredCache (zeros) with static capacity."""
    P = capacity // spec.pack_size
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    tiers = tuple(
        TierBuffer(
            payload=z((batch, h_kv, c, spec.payload_words(i, capacity)),
                      torch.int32),
            mins=z((batch, h_kv, c, P), torch.int8),
            shifts=z((batch, h_kv, c, cdiv(P, 4)), torch.uint8),
            width=w,
            pack_size=spec.pack_size,
        )
        for i, (w, c) in enumerate(zip(spec.widths, spec.counts))
    )
    D = spec.head_dim
    perm = torch.arange(D, dtype=torch.int32, device=device)
    return TieredCache(
        tiers=tiers,
        chan_perm=perm.expand(batch, h_kv, D).clone(),
        scale=torch.ones((batch, h_kv, capacity), dtype=torch.float32,
                         device=device),
        zero=z((batch, h_kv, capacity), torch.float32),
        spec=spec,
    )


def slice_tiered_prefix(cache: TieredCache, n: int) -> TieredCache:
    """Prefix VIEW (no copy): the first ``n`` tokens of every buffer.

    ``n`` must be a multiple of ``4 * pack_size`` so payload words, pack
    metadata and shift bytes all slice on exact boundaries.
    """
    if n >= cache.capacity:
        return cache
    spec = cache.spec
    if n % (4 * spec.pack_size):
        raise ValueError(f"prefix {n} not a multiple of 4*{spec.pack_size}")
    P = n // spec.pack_size
    tiers = tuple(
        TierBuffer(
            payload=t.payload[..., : n * t.width // 32],
            mins=t.mins[..., :P],
            shifts=t.shifts[..., : P // 4],
            width=t.width,
            pack_size=t.pack_size,
        )
        for t in cache.tiers
    )
    return TieredCache(tiers=tiers, chan_perm=cache.chan_perm,
                       scale=cache.scale[..., :n], zero=cache.zero[..., :n],
                       spec=spec)


def slice_tiered_suffix(cache: TieredCache, start: int) -> TieredCache:
    """Suffix VIEW (no copy): every buffer's tokens from ``start`` on, a
    multiple of ``4 * pack_size`` (page starts are). The mirror of
    ``slice_tiered_prefix``: a prefix-cache admission scatters only its
    newly compressed pages."""
    if start == 0:
        return cache
    spec = cache.spec
    if start % (4 * spec.pack_size):
        raise ValueError(f"suffix start {start} not a multiple of 4*{spec.pack_size}")
    P0 = start // spec.pack_size
    tiers = tuple(
        TierBuffer(
            payload=t.payload[..., start * t.width // 32:],
            mins=t.mins[..., P0:],
            shifts=t.shifts[..., P0 // 4:],
            width=t.width,
            pack_size=t.pack_size,
        )
        for t in cache.tiers
    )
    return TieredCache(tiers=tiers, chan_perm=cache.chan_perm,
                       scale=cache.scale[..., start:], zero=cache.zero[..., start:],
                       spec=spec)


def write_tiered_prefix(dst: TieredCache, src: TieredCache) -> TieredCache:
    """Write ``src``'s whole token range into the leading tokens of ``dst``,
    IN PLACE: payload, mins, shifts, scale and zero (``dst.chan_perm`` is
    the caller's to set). ``src.capacity`` must be a multiple of
    ``4 * pack_size`` (gathered whole pages are). Seeds a dense mini-cache
    with a shared compressed prefix."""
    n = src.capacity
    if n % (4 * dst.spec.pack_size):
        raise ValueError(f"prefix {n} not a multiple of 4*{dst.spec.pack_size}")

    def put(d, s):
        d[..., :s.shape[-1]] = s

    for dt, st in zip(dst.tiers, src.tiers):
        if dt.width:
            put(dt.payload, st.payload)
        put(dt.mins, st.mins)
        put(dt.shifts, st.shifts)
    put(dst.scale, src.scale)
    put(dst.zero, src.zero)
    return dst


# ---------------------------------------------------------------------------
# Page pool layout
# ---------------------------------------------------------------------------


def alloc_tiered_pool(batch: int, h_kv: int, n_pool_pages: int,
                      page_size: int, spec: TierSpec,
                      device="cuda") -> TieredCache:
    """Preallocate a PAGE-POOL TieredCache: data leaves lead with
    ``[H_kv, n_pool_pages]`` and their token axis covers one page;
    ``chan_perm`` stays per slot ``[batch, H_kv, D]``."""
    if page_size % (4 * spec.pack_size):
        raise ValueError(f"page_size {page_size} not a multiple of "
                         f"4*{spec.pack_size}")
    P = page_size // spec.pack_size
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    tiers = tuple(
        TierBuffer(
            payload=z((h_kv, n_pool_pages, c, spec.payload_words(i, page_size)),
                      torch.int32),
            mins=z((h_kv, n_pool_pages, c, P), torch.int8),
            shifts=z((h_kv, n_pool_pages, c, cdiv(P, 4)), torch.uint8),
            width=w,
            pack_size=spec.pack_size,
        )
        for i, (w, c) in enumerate(zip(spec.widths, spec.counts))
    )
    D = spec.head_dim
    perm = torch.arange(D, dtype=torch.int32, device=device)
    return TieredCache(
        tiers=tiers,
        chan_perm=perm.expand(batch, h_kv, D).clone(),
        scale=torch.ones((h_kv, n_pool_pages, page_size), dtype=torch.float32,
                         device=device),
        zero=z((h_kv, n_pool_pages, page_size), torch.float32),
        spec=spec,
    )


def page_prefix_ids(page_table: torch.Tensor, n_tokens: int,
                    page_size: int) -> torch.Tensor:
    """The page-table prefix ``[B, n_tokens // page_size]`` addressing the
    first ``n_tokens`` (a whole number of pages) of every row."""
    if n_tokens % page_size:
        raise ValueError(f"{n_tokens} tokens are not whole pages of {page_size}")
    return page_table[..., : n_tokens // page_size]


def gather_pool_leaf(leaf: torch.Tensor, idx: torch.Tensor,
                     token_axis: int = -1) -> torch.Tensor:
    """Gather pool pages into the dense layout along the token axis.

    leaf: ``[H_kv, n_pool_pages, ...]`` whose ``token_axis`` covers one
    page; idx: int ``[B, k]`` page ids. Returns ``[B, H_kv, ...]`` with the
    token axis covering ``k`` pages (a copy)."""
    x = leaf[:, idx.to(torch.int64)]  # [H, B, k, *rest]
    t = token_axis % leaf.dim() + 1  # the token axis in x
    rest = range(3, x.dim())
    perm = [1, 0, *[d for d in rest if d < t], 2, *[d for d in rest if d >= t]]
    x = x.permute(perm)
    ta = perm.index(t)
    return x.reshape(*x.shape[:ta - 1], x.shape[ta - 1] * x.shape[ta],
                     *x.shape[ta + 1:])


def gather_page_meta(leaf: torch.Tensor, page_table: torch.Tensor,
                     n_tokens: int, page_size: int) -> torch.Tensor:
    """Per-token metadata (scale / zero, pool ``[H_kv, P, page]``) of the
    first ``n_tokens`` gathered to the dense ``[B, H_kv, n_tokens]``."""
    return gather_pool_leaf(leaf, page_prefix_ids(page_table, n_tokens, page_size))


def gather_tiered_pages(pool: TieredCache, idx: torch.Tensor) -> TieredCache:
    """Page-table gather: pool layout -> a dense TieredCache of capacity
    ``k * page_size`` (idx: int ``[B, k]``) whose live bytes equal a dense
    cache holding the same tokens."""
    tiers = tuple(
        TierBuffer(payload=gather_pool_leaf(t.payload, idx),
                   mins=gather_pool_leaf(t.mins, idx),
                   shifts=gather_pool_leaf(t.shifts, idx),
                   width=t.width, pack_size=t.pack_size)
        for t in pool.tiers
    )
    return TieredCache(tiers=tiers, chan_perm=pool.chan_perm,
                       scale=gather_pool_leaf(pool.scale, idx),
                       zero=gather_pool_leaf(pool.zero, idx), spec=pool.spec)


def _clamped_start(start: int, size: int, n: int) -> int:
    """The start index ``jax.lax.dynamic_update_slice`` uses: clamped so
    an ``n``-long write fits in ``size``."""
    return max(0, min(start, size - n))


def _put(dst: torch.Tensor, src: torch.Tensor, start: int) -> None:
    """dst[..., s:s+n] = src with the reference's clamped start."""
    n = src.shape[-1]
    s = _clamped_start(start, dst.shape[-1], n)
    dst[..., s:s + n] = src


def append_block(cache: TieredCache, block: TieredCache, offset: int) -> TieredCache:
    """Write a packed block at token ``offset`` IN PLACE; returns ``cache``.

    The start of each leaf's write is clamped into range exactly as the
    reference's ``dynamic_update_slice`` clamps it, so an offset past
    ``capacity - block`` overwrites the tail like the reference does.
    """
    spec = cache.spec
    for t, b in zip(cache.tiers, block.tiers):
        if t.width:
            _put(t.payload, b.payload, offset * t.width // 32)
        pk_off = offset // spec.pack_size
        _put(t.mins, b.mins, pk_off)
        _put(t.shifts, b.shifts, pk_off // 4)
    _put(cache.scale, block.scale, offset)
    _put(cache.zero, block.zero, offset)
    return cache


def _select(buf: TierBuffer | TieredCache, rows) -> TieredCache:
    if isinstance(buf, TierBuffer):
        return dataclasses.replace(buf, payload=buf.payload[rows],
                                   mins=buf.mins[rows],
                                   shifts=buf.shifts[rows])
    return dataclasses.replace(
        buf, tiers=tuple(_select(t, rows) for t in buf.tiers),
        chan_perm=buf.chan_perm[rows], scale=buf.scale[rows],
        zero=buf.zero[rows])


def append_block_rows(cache: TieredCache, block: TieredCache,
                      offsets: list[int], rows: list[int] | None = None
                      ) -> TieredCache:
    """Per-row ``append_block`` IN PLACE: block row i lands in cache row
    ``rows[i]`` (default: row i) at token ``offsets[i]``."""
    rows = list(range(len(offsets))) if rows is None else rows
    for i, (r, off) in enumerate(zip(rows, offsets)):
        append_block(_select(cache, r), _select(block, i), int(off))
    return cache
