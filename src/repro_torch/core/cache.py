"""Runtime PackKV cache manager (paper III-B1/B4 + III-C glue).

The torch port of ``repro/core/cache.py``, dense and paged storage. A
fixed-size residual buffer holds recent tokens in full precision; when a
row's residual is full, its oldest 64-token block is quantized, V-median
repacked, tier-packed and appended to that row's compressed region.

Paged storage (``PackKVConfig.paged``) keeps the compressed region in a
shared pool of ``page_size``-token pages with a refcounted free stack and
per-row page tables (``PagePool``); the ledger lives on the device as
int32 tensors and every pool operation updates it without a host read,
in the reference's order (descending stack, cumsum ranks among the rows
that pop), so ledgers equal the reference's after the same operations.

Sequence state is per row: ``n_comp``/``n_resid`` are int32 ``[B]``
tensors and rows flush independently. A model's cache is a Python list of
``LayerKVCache`` (one per layer), where the reference stacked layers on a
leading axis.

Where the reference returned a new cache from donated buffers, these
functions update the cache tensors IN PLACE and return the same object:
``prefill_cache``, ``prefill_append``, ``append_token``, ``reset_slot``,
``mask_free_slots``, ``insert_row``, ``insert_row_paged``, the pool
primitives, the prefix-sharing ops (``share_pages``, ``acquire_pages``,
``release_pages``, ``seed_prefix_from_pages``) and ``restore_row``.
``slice_compressed`` returns views (dense) or a gathered copy (paged) for
reads only. ``evacuate_row`` frees a row in place and returns its bytes
as a fresh dense B=1 mini-cache, which ``SwapStore`` (preempted rows) and
``SessionStore`` (parked sessions, host RAM with an optional disk tier)
keep on the host.

Invariants (as in the reference): ``n_comp`` is block-aligned; a flush
fires before the write that would overflow the residual; free slots have
zero counters at rest.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .quantization import QuantConfig
from .repacking import median_repack
from ..utils import cdiv, leaf_nbytes, round_up, to_host, tree_flatten, tree_map
from .tiered import (
    TierSpec,
    TieredCache,
    alloc_tiered,
    alloc_tiered_pool,
    append_block,
    append_block_rows,
    assign_channel_tiers,
    choose_tier_spec,
    gather_pool_leaf,
    gather_tiered_pages,
    pack_tiered,
    page_prefix_ids,
    required_channel_widths,
    slice_tiered_prefix,
    slice_tiered_suffix,
    write_tiered_prefix,
)

BLOCK = 64  # truncated block size (consistent with KIVI, paper IV-A)


@dataclasses.dataclass(frozen=True)
class PackKVConfig:
    """Tunable knobs of the paper's pipeline (paper IV-A)."""

    policy: str = "packkv"  # none | kivi | packkv
    k_rel_scale: float = 0.1
    v_rel_scale: float = 0.2
    pack_size: int = 8
    repack: str = "median_v"  # none | median_v
    residual: int = 128  # max buffer size (recent tokens kept in bf16)
    block: int = BLOCK
    k_tiers: tuple[int, ...] = (2, 4, 8)
    k_fracs: tuple[float, ...] = (0.25, 0.5, 0.25)
    v_tiers: tuple[int, ...] = (2, 4, 8)
    v_fracs: tuple[float, ...] = (0.25, 0.5, 0.25)
    # calibrated static specs (engine build, ``calibrate_specs``)
    k_spec_static: Optional[TierSpec] = None
    v_spec_static: Optional[TierSpec] = None
    # paged compressed region: a shared pool of ``page_size``-token pages
    # (a power of two, a multiple of ``block`` and of ``4 * pack_size``);
    # pool_pages None -> batch * capacity / page_size at alloc time
    paged: bool = False
    page_size: int = 256
    pool_pages: Optional[int] = None

    def k_quant(self) -> QuantConfig:
        return QuantConfig(rel_scale=self.k_rel_scale, granularity="token")

    def v_quant(self) -> QuantConfig:
        return QuantConfig(rel_scale=self.v_rel_scale, granularity="token")

    def k_spec(self, head_dim: int) -> TierSpec:
        if self.k_spec_static is not None:
            return self.k_spec_static
        if self.policy == "kivi":
            return TierSpec(widths=(4,), counts=(head_dim,), pack_size=self.pack_size)
        return TierSpec.for_head_dim(head_dim, self.k_tiers, self.k_fracs)

    def v_spec(self, head_dim: int) -> TierSpec:
        if self.v_spec_static is not None:
            return self.v_spec_static
        if self.policy == "kivi":
            return TierSpec(widths=(4,), counts=(head_dim,), pack_size=self.pack_size)
        return TierSpec.for_head_dim(head_dim, self.v_tiers, self.v_fracs)


@dataclasses.dataclass
class PagePool:
    """Refcounted page allocator and per-slot page tables (paged mode).

    ONE pool serves a layer's K, V (and, policy 'none', raw) storage: they
    append in lock-step, so one physical page id addresses the K, V and
    raw page of the same ``page_size``-token span. The contract (as the
    reference's):

      * ``ref[p]`` counts the holders of page ``p``; ``ref[p] == 0`` iff
        ``p`` is free iff ``p`` is in ``free[:n_free]`` (entries above
        ``n_free`` are stale pops, never read);
      * a slot's live pages are the prefix
        ``page_table[b, :ceil(n_comp[b] / page_size)]``; entries past it
        are stale but in-range ids;
      * pops hand out unique ids at ``ref = 1``; a release decrements and
        a page returns to the stack when its count reaches zero;
      * a page with ``ref > 1`` is read-only: a flush into it copies it to
        a fresh page first (copy-on-write);
      * pool exhaustion is the scheduler's to prevent (page reservations);
        pops clamp their stack reads, so an over-pop corrupts data but
        never faults.
    """

    page_table: torch.Tensor  # int32 [B, max_pages] logical -> physical
    free: torch.Tensor  # int32 [n_pool_pages] stack of free page ids
    n_free: torch.Tensor  # int32 [] live stack height
    ref: torch.Tensor  # int32 [n_pool_pages] holders per page
    page_size: int

    @property
    def n_pool_pages(self) -> int:
        return self.free.shape[-1]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[-1]


@dataclasses.dataclass
class LayerKVCache:
    """Per-layer decode cache. ``k``/``v`` are None for policy 'none'
    (which keeps ``raw_k``/``raw_v`` instead).

    Dense mode: compressed leaves lead with [B, Hkv] and cover
    ``capacity`` tokens. Paged mode (``pages`` is not None): compressed
    (or raw) leaves are page pools leading with [Hkv, n_pool_pages] and
    covering one page each; the residual buffer and the counters keep the
    dense layout either way."""

    k: Optional[TieredCache]  # compressed region (channels-major)
    v: Optional[TieredCache]
    raw_k: Optional[torch.Tensor]  # policy 'none': bf16 [B, Hkv, Lcap, D]
    raw_v: Optional[torch.Tensor]  # (paged: [Hkv, n_pool_pages, page, D])
    resid_k: torch.Tensor  # bf16 [B, Hkv, R, D]
    resid_v: torch.Tensor
    n_comp: torch.Tensor  # int32 [B] tokens in the compressed/raw region
    n_resid: torch.Tensor  # int32 [B] tokens in the residual buffer
    cfg: PackKVConfig
    pages: Optional[PagePool] = None  # paged mode: the layer's page pool

    @property
    def capacity(self) -> int:
        if self.pages is not None:
            return self.pages.max_pages * self.pages.page_size
        return self.raw_k.shape[-2] if self.cfg.policy == "none" else self.k.capacity


def alloc_page_pool(batch: int, capacity: int, page_size: int,
                    pool_pages: Optional[int] = None, device="cuda") -> PagePool:
    """Fresh pool: every page free, tables zeroed (valid ids)."""
    max_pages = capacity // page_size
    P = batch * max_pages if pool_pages is None else pool_pages
    i32 = dict(dtype=torch.int32, device=device)
    return PagePool(
        page_table=torch.zeros((batch, max_pages), **i32),
        # descending stack, so pops hand out 0, 1, 2, ...
        free=torch.arange(P - 1, -1, -1, **i32),
        n_free=torch.tensor(P, **i32),
        ref=torch.zeros((P,), **i32),
        page_size=page_size,
    )


def alloc_layer_cache(cfg: PackKVConfig, batch: int, h_kv: int, head_dim: int,
                      capacity: int, dtype=torch.bfloat16,
                      device="cuda") -> LayerKVCache:
    """Preallocate a cache with static ``capacity``. Paged mode holds
    ``cfg.pool_pages`` pages (default ``batch * capacity / page_size``)
    instead of ``batch * capacity`` tokens."""
    R = cfg.residual
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    resid = lambda: z((batch, h_kv, R, head_dim), dtype)
    counters = dict(n_comp=z((batch,), torch.int32),
                    n_resid=z((batch,), torch.int32), cfg=cfg)
    if cfg.paged:
        page = cfg.page_size
        if page & (page - 1) or capacity % page or page % cfg.block:
            raise ValueError(f"page_size {page} must be a power of two, a "
                             f"multiple of the block {cfg.block} and divide "
                             f"the capacity {capacity}")
        pool = alloc_page_pool(batch, capacity, page, cfg.pool_pages, device)
        P = pool.n_pool_pages
        if cfg.policy == "none":
            raw = lambda: z((h_kv, P, page, head_dim), dtype)
            return LayerKVCache(k=None, v=None, raw_k=raw(), raw_v=raw(),
                                resid_k=resid(), resid_v=resid(), pages=pool,
                                **counters)
        return LayerKVCache(
            k=alloc_tiered_pool(batch, h_kv, P, page, cfg.k_spec(head_dim), device),
            v=alloc_tiered_pool(batch, h_kv, P, page, cfg.v_spec(head_dim), device),
            raw_k=None, raw_v=None, resid_k=resid(), resid_v=resid(),
            pages=pool, **counters)
    if cfg.policy == "none":
        raw = lambda: z((batch, h_kv, capacity, head_dim), dtype)
        return LayerKVCache(k=None, v=None, raw_k=raw(), raw_v=raw(),
                            resid_k=resid(), resid_v=resid(), **counters)
    return LayerKVCache(
        k=alloc_tiered(batch, h_kv, capacity, cfg.k_spec(head_dim), device),
        v=alloc_tiered(batch, h_kv, capacity, cfg.v_spec(head_dim), device),
        raw_k=None, raw_v=None, resid_k=resid(), resid_v=resid(), **counters)


# ---------------------------------------------------------------------------
# Quantize + repack + pack one block
# ---------------------------------------------------------------------------


def _quant_tokenwise(x: torch.Tensor, qc: QuantConfig):
    """x: [B,H,N,D] -> (q int32, scale f32 [B,H,N], zero f32 [B,H,N]).

    Integers are CENTERED at zero (q in [-c, max_q - c], c = (max_q+1)//2)
    with the offset folded into the zero-point. ``hi - lo`` is taken in
    the input dtype (bf16) before the cast to f32, as in the reference.
    """
    lo = x.amin(dim=-1)
    hi = x.amax(dim=-1)
    rng = (hi - lo).to(torch.float32)
    scale = torch.where(rng > 0, qc.rel_scale * rng, torch.ones_like(rng))
    c = (qc.max_q + 1) // 2
    lo32 = lo.to(torch.float32)
    q = torch.clamp(
        torch.round((x.to(torch.float32) - lo32[..., None]) / scale[..., None]),
        0, qc.max_q,
    ).to(torch.int32) - c
    return q, scale, lo32 + c * scale


def _repack_tokens(qk, qv, cfg: PackKVConfig):
    """Joint token permutation from the V medians, applied to K and V.
    Returns (qk, qv, perm); perm is None for repack='none'."""
    if cfg.repack != "median_v":
        return qk, qv, None
    perm = median_repack(qv)
    take = lambda a: torch.gather(a, -2, perm[..., None].expand_as(a))
    return take(qk), take(qv), perm


def compress_block(k, v, cfg: PackKVConfig, k_perm, v_perm
                   ) -> tuple[TieredCache, TieredCache]:
    """Compress one [B,H,N,D] block pair into single-block TieredCaches.

    k_perm/v_perm: [B,H,D] channel -> tier assignment (from calibration).
    """
    qk, sk, zk = _quant_tokenwise(k, cfg.k_quant())
    qv, sv, zv = _quant_tokenwise(v, cfg.v_quant())
    qk, qv, perm = _repack_tokens(qk, qv, cfg)
    if perm is not None:
        take = lambda a: torch.gather(a, -1, perm)
        sk, zk, sv, zv = take(sk), take(zk), take(sv), take(zv)
    kc = pack_tiered(qk.transpose(-1, -2), k_perm, sk, zk, cfg.k_spec(k.shape[-1]))
    vc = pack_tiered(qv.transpose(-1, -2), v_perm, sv, zv, cfg.v_spec(v.shape[-1]))
    return kc, vc


def _calib_widths(k, v, cfg: PackKVConfig):
    """Per-channel widths measured AFTER token repacking, or None when
    there is less than one block of data."""
    qk, _, _ = _quant_tokenwise(k, cfg.k_quant())
    qv, _, _ = _quant_tokenwise(v, cfg.v_quant())
    Lb = (k.shape[-2] // cfg.block) * cfg.block
    if Lb == 0:
        return None
    qk, qv, _ = _repack_tokens(qk[..., :Lb, :], qv[..., :Lb, :], cfg)
    return (required_channel_widths(qk.transpose(-1, -2), cfg.pack_size),
            required_channel_widths(qv.transpose(-1, -2), cfg.pack_size))


def calibrate_channel_tiers(k, v, cfg: PackKVConfig):
    """Assign channel tiers from (prefill) data. k, v: [B,H,L,D]."""
    w = _calib_widths(k, v, cfg)
    D = k.shape[-1]
    if w is None:  # not enough data: identity assignment
        eye = torch.arange(D, dtype=torch.int32, device=k.device)
        eye = eye.expand(*k.shape[:-2], D)
        return eye, eye
    return (assign_channel_tiers(w[0], cfg.k_spec(D)),
            assign_channel_tiers(w[1], cfg.v_spec(D)))


def calibrate_specs(k, v, cfg: PackKVConfig, slack: int = 0) -> PackKVConfig:
    """Host-side: pick static TierSpecs from calibration K/V ([B,H,L,D]).
    Returns a new PackKVConfig with k_spec_static / v_spec_static set."""
    w = _calib_widths(k, v, cfg)
    if w is None:
        return cfg
    return dataclasses.replace(
        cfg,
        k_spec_static=choose_tier_spec(w[0], pack_size=cfg.pack_size, slack=slack),
        v_spec_static=choose_tier_spec(w[1], pack_size=cfg.pack_size, slack=slack),
    )


# ---------------------------------------------------------------------------
# Length-aware launch buckets
# ---------------------------------------------------------------------------

BUCKET_UNIT = 256  # smallest bucket; a multiple of the kernel tile


def bucket_length(n_max: int, capacity: int, unit: int = BUCKET_UNIT) -> int:
    """Host-side: the launch bucket covering ``n_max`` live tokens
    (power-of-two multiples of ``unit`` clamped to ``capacity``)."""
    if capacity <= unit or n_max >= capacity:
        return capacity
    b = unit
    while b < n_max:
        b *= 2
    return min(b, capacity)


def bucket_set(capacity: int, unit: int = BUCKET_UNIT) -> tuple[int, ...]:
    """Every bucket ``bucket_length`` can return for this capacity."""
    out = []
    b = unit
    while b < capacity:
        out.append(b)
        b *= 2
    return tuple(out) + (capacity,)


def slice_compressed(cache: LayerKVCache, n_bucket: int | None) -> LayerKVCache:
    """Prefix VIEW of the compressed region for a bucketed read (no copy).
    Use only for reads: appends go through the full-capacity cache.

    Paged caches return the page-table gather of the first ``n_bucket``
    tokens instead (``gather_paged``): the same dense layout, read-only."""
    if cache.pages is not None:
        return gather_paged(cache, n_bucket)
    if n_bucket is None or n_bucket >= cache.capacity:
        return cache
    if cache.cfg.policy == "none":
        return dataclasses.replace(cache, raw_k=cache.raw_k[..., :n_bucket, :],
                                   raw_v=cache.raw_v[..., :n_bucket, :])
    return dataclasses.replace(cache, k=slice_tiered_prefix(cache.k, n_bucket),
                               v=slice_tiered_prefix(cache.v, n_bucket))


# ---------------------------------------------------------------------------
# Per-row primitives
# ---------------------------------------------------------------------------


def row_update_tokens(buf: torch.Tensor, new: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
    """Per-row write along the token axis (-2), IN PLACE.

    buf: [B, ..., N, D]; new: [B, ..., n, D]; starts: int [B]. Each start
    is clamped to [0, N - n] as ``dynamic_update_slice`` clamps it.
    """
    B, n, N = buf.shape[0], new.shape[-2], buf.shape[-2]
    s = torch.clamp(starts.to(torch.int64), 0, N - n)
    pos = s[:, None] + torch.arange(n, device=buf.device)  # [B, n]
    shape = (B,) + (1,) * (buf.dim() - 3) + (n, 1)
    idx = pos.reshape(shape).expand(*new.shape)
    buf.scatter_(-2, idx, new.to(buf.dtype))
    return buf


def select_rows(mask: torch.Tensor, new, old):
    """Row b of the result is ``new[b]`` where mask[b], else ``old[b]``
    (tensors lead with B)."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


# ---------------------------------------------------------------------------
# Paged pool primitives (ledger ops on the device, no host read)
# ---------------------------------------------------------------------------


def live_pages(n_comp, page_size: int):
    """Pages resident for ``n_comp`` compressed tokens (ceil division)."""
    return -(-n_comp // page_size)


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, val) -> None:
    """``dst[idx] = val`` IN PLACE on a 1-D ledger vector, dropping every
    entry whose index is ``>= len(dst)`` (the reference's ``mode='drop'``:
    ``index_put_`` would fault on it, so the write goes through one
    sentinel slot past the end)."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    idx = torch.clamp(idx.to(torch.int64), max=n)
    val = torch.as_tensor(val, dtype=dst.dtype, device=dst.device)
    ext.index_put_((idx,), val.expand(idx.shape))
    dst.copy_(ext[:n])


def pool_pop_rows(pool: PagePool, need: torch.Tensor, lp: torch.Tensor,
                  rows: torch.Tensor | None = None) -> PagePool:
    """Pop one page for every row with ``need`` and record it at logical
    index ``lp`` of that row's table, IN PLACE. ``rows``: the table rows
    of ``need``/``lp`` in ascending order (default: all rows). Pops are
    unique, ranked by cumsum among the needers, and land at ``ref = 1``."""
    P = pool.n_pool_pages
    if rows is None:
        rows = torch.arange(pool.page_table.shape[0], device=need.device)
    rank = torch.cumsum(need.to(torch.int32), 0) - 1  # position among needers
    pos = torch.clamp(pool.n_free - 1 - rank, 0, P - 1)
    phys = pool.free[pos.to(torch.int64)]
    lp_c = torch.clamp(lp, 0, pool.max_pages - 1).to(torch.int64)
    cur = pool.page_table[rows, lp_c]
    pool.page_table[rows, lp_c] = torch.where(need, phys, cur)
    _set_drop(pool.ref, torch.where(need, phys, P), 1)
    pool.n_free.copy_(torch.clamp(pool.n_free - need.sum(), min=0))
    return pool


def pool_pop_prefix(pool: PagePool, slot: int, k: int,
                    lp0: int = 0) -> torch.Tensor:
    """Pop ``k`` pages IN PLACE and write them to
    ``page_table[slot, lp0:lp0 + k]`` at ``ref = 1``. Returns their ids
    (int32 [k])."""
    if lp0 + k > pool.max_pages:
        raise ValueError(
            f"prompt needs {lp0 + k} pages but a slot's table holds "
            f"{pool.max_pages}; its block-aligned length exceeds the "
            "compressed capacity (SlotServer.submit rejects it)")
    dev = pool.free.device
    if k == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    pos = torch.clamp(pool.n_free - k + torch.arange(k, device=dev), 0,
                      pool.n_pool_pages - 1)
    phys = pool.free[pos.to(torch.int64)]
    pool.page_table[slot, lp0:lp0 + k] = phys
    pool.ref[phys.to(torch.int64)] = 1
    pool.n_free.copy_(torch.clamp(pool.n_free - k, min=0))
    return phys


def pool_pop_all_rows(pool: PagePool, k: int) -> torch.Tensor:
    """Pop ``k`` pages for EVERY row IN PLACE (whole-batch prefill).
    Returns their ids (int32 [B, k])."""
    B = pool.page_table.shape[0]
    dev = pool.free.device
    if k == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    total = B * k
    pos = torch.clamp(pool.n_free - total + torch.arange(total, device=dev),
                      0, pool.n_pool_pages - 1)
    phys = pool.free[pos.to(torch.int64)].reshape(B, k)
    pool.page_table[:, :k] = phys
    pool.ref[phys.reshape(-1).to(torch.int64)] = 1
    pool.n_free.copy_(torch.clamp(pool.n_free - total, min=0))
    return phys


def _pool_release_ids(pool: PagePool, ids: torch.Tensor) -> PagePool:
    """Drop ONE reference per entry of ``ids`` (int [m]) IN PLACE.

    Entries ``>= n_pool_pages`` are sentinels (ignored); duplicates each
    cost one reference, clamped to the page's count so an over-release
    never drives it negative. Pages reaching zero are pushed back on the
    free stack once each, in ``ids`` order."""
    P = pool.n_pool_pages
    ids = ids.to(torch.int32)
    ids_c = torch.clamp(ids, 0, P - 1).to(torch.int64)
    in_range = ids < P
    eq = ids[:, None] == ids[None, :]
    # occurrence rank among duplicates: only the first ref[id] decrement
    occ = (torch.tril(eq, -1) & in_range[None, :]).sum(1)
    valid = in_range & (occ < pool.ref[ids_c])
    pool.ref.index_put_((ids_c,), -valid.to(torch.int32), accumulate=True)
    hit0 = valid & (occ == 0) & (pool.ref[ids_c] == 0)
    dst = pool.n_free + torch.cumsum(hit0.to(torch.int32), 0) - 1
    _set_drop(pool.free, torch.where(hit0, dst, P), ids)
    pool.n_free += hit0.sum().to(torch.int32)
    return pool


def pool_release_row(pool: PagePool, slot: int, n_pages) -> PagePool:
    """Release row ``slot``'s first ``n_pages`` (an int or a device
    scalar) table entries, IN PLACE. The table row is left stale."""
    mp = pool.max_pages
    row = pool.page_table[slot]
    k = torch.clamp(torch.as_tensor(n_pages, device=row.device), 0, mp)
    ids = torch.where(torch.arange(mp, device=row.device) < k, row,
                      pool.n_pool_pages)
    return _pool_release_ids(pool, ids)


def pool_map_prefix(pool: PagePool, slot: int, phys: torch.Tensor) -> PagePool:
    """SHARE, IN PLACE: map already-held pages ``phys`` (int [k]) into
    ``page_table[slot, :k]`` by reference (``ref += 1``). Every entry must
    have ``ref >= 1`` (held by another slot or the prefix index), so a
    mapped page is never on the free stack."""
    k = phys.shape[0]
    if k == 0:
        return pool
    pool.page_table[slot, :k] = phys.to(torch.int32)
    pool.ref.index_put_((phys.to(torch.int64),),
                        torch.ones((k,), dtype=torch.int32, device=phys.device),
                        accumulate=True)
    return pool


def pool_acquire_ids(pool: PagePool, ids: torch.Tensor) -> PagePool:
    """Add one reference per entry of ``ids`` IN PLACE (sentinels
    ``>= n_pool_pages`` ignored). The prefix index pins its pages with
    this, before the owning slot releases them, so a count never dips to
    zero in between."""
    P = pool.n_pool_pages
    ids = ids.to(torch.int32)
    pool.ref.index_put_((torch.clamp(ids, 0, P - 1).to(torch.int64),),
                        (ids < P).to(torch.int32), accumulate=True)
    return pool


def _pool_write_rows(leaf: torch.Tensor, blk: torch.Tensor,
                     phys_r: torch.Tensor, phys_w: torch.Tensor,
                     off: torch.Tensor, axis: int = -1) -> None:
    """Per-row block write into pool pages, IN PLACE: page ``phys_w[i]``
    becomes page ``phys_r[i]`` (the same page, or the shared page a
    copy-on-write row copies) with row i's block written at element
    offset ``off[i]`` of ``axis``.

    leaf: [H, P, ..., page units]; blk: [m, H, ..., block units]. Every
    row given writes: the reference's masked rows (dropped writes to page
    ``P``) are simply not passed."""
    if axis == -2:
        leaf, blk = leaf.transpose(-1, -2), blk.transpose(-1, -2)
    dev = leaf.device
    pw = phys_w.to(torch.int64)
    leaf[:, pw] = leaf[:, phys_r.to(torch.int64)]
    n = blk.shape[-1]
    cols = off.to(torch.int64)[:, None] + torch.arange(n, device=dev)
    mid = leaf.shape[2:-1]
    nd = len(mid) + 2
    index = [pw.reshape(-1, *([1] * (nd - 1)))]
    for i, size in enumerate(mid):
        shape = [1] * nd
        shape[i + 1] = size
        index.append(torch.arange(size, device=dev).reshape(shape))
    index.append(cols.reshape(cols.shape[0], *([1] * len(mid)), n))
    leaf[(slice(None), *index)] = blk.transpose(0, 1).to(leaf.dtype)


def _pool_write_tiered(pool_tc: TieredCache, blk: TieredCache,
                       phys_r: torch.Tensor, phys_w: torch.Tensor,
                       wo: torch.Tensor) -> None:
    """Write per-row blocks into a tiered page pool at within-page token
    offset ``wo`` (block-aligned, so packs and shift bytes land on exact
    boundaries), IN PLACE."""
    pack = pool_tc.spec.pack_size
    for t, b in zip(pool_tc.tiers, blk.tiers):
        if t.width:
            _pool_write_rows(t.payload, b.payload, phys_r, phys_w,
                             wo * t.width // 32)
        _pool_write_rows(t.mins, b.mins, phys_r, phys_w, wo // pack)
        _pool_write_rows(t.shifts, b.shifts, phys_r, phys_w, wo // pack // 4)
    _pool_write_rows(pool_tc.scale, blk.scale, phys_r, phys_w, wo)
    _pool_write_rows(pool_tc.zero, blk.zero, phys_r, phys_w, wo)


def _scatter_pages(leaf: torch.Tensor, blk: torch.Tensor, phys: torch.Tensor,
                   axis: int = -1) -> None:
    """Scatter whole pages of a dense block into the pool, IN PLACE.

    leaf: [H, P, ...] whose ``axis`` covers one page (``u`` units); blk:
    [B, H, ...] whose ``axis`` covers up to ``k * u`` units (zero-padded
    to the page boundary); phys: int [B, k] target pages."""
    if axis == -2:
        leaf, blk = leaf.transpose(-1, -2), blk.transpose(-1, -2)
    B, k = phys.shape
    u = leaf.shape[-1]
    pad = k * u - blk.shape[-1]
    if pad:
        blk = torch.nn.functional.pad(blk, (0, pad))
    x = blk.reshape(*blk.shape[:-1], k, u).movedim(-2, 1)  # [B, k, H, ..., u]
    x = x.reshape(B * k, *x.shape[2:]).movedim(0, 1)  # [H, B*k, ..., u]
    leaf[:, phys.reshape(-1).to(torch.int64)] = x.to(leaf.dtype)


def _scatter_pages_tiered(pool_tc: TieredCache, blk: TieredCache,
                          phys: torch.Tensor) -> None:
    """Scatter a dense-layout compressed block (capacity <= k pages) into
    ``k`` pool pages per row, IN PLACE. ``chan_perm`` is not touched."""
    for pt, bt in zip(pool_tc.tiers, blk.tiers):
        _scatter_pages(pt.payload, bt.payload, phys)
        _scatter_pages(pt.mins, bt.mins, phys)
        _scatter_pages(pt.shifts, bt.shifts, phys)
    _scatter_pages(pool_tc.scale, blk.scale, phys)
    _scatter_pages(pool_tc.zero, blk.zero, phys)


def gather_paged(cache: LayerKVCache, n_bucket: int | None = None) -> LayerKVCache:
    """Dense read copy of a paged cache: the first ``n_bucket`` tokens'
    pages of every row gathered through its page table (full capacity
    when None). Its live bytes equal the dense storage mode's; read-only."""
    if cache.pages is None:
        raise ValueError("gather_paged needs a paged cache")
    n = cache.capacity if n_bucket is None else min(n_bucket, cache.capacity)
    idx = page_prefix_ids(cache.pages.page_table, n, cache.pages.page_size)
    if cache.cfg.policy == "none":
        return dataclasses.replace(
            cache, raw_k=gather_pool_leaf(cache.raw_k, idx, token_axis=-2),
            raw_v=gather_pool_leaf(cache.raw_v, idx, token_axis=-2), pages=None)
    return dataclasses.replace(cache, k=gather_tiered_pages(cache.k, idx),
                               v=gather_tiered_pages(cache.v, idx), pages=None)


# ---------------------------------------------------------------------------
# Cache update ops
# ---------------------------------------------------------------------------


def prefill_cache(cache: LayerKVCache, k: torch.Tensor, v: torch.Tensor
                  ) -> LayerKVCache:
    """Fill the cache IN PLACE from prefill K/V ([B,H,L,D]).

    Compresses all complete blocks (calibrating the channel tiers from
    them, per batch row and head); the remainder goes to the residual.
    A paged cache pops ``ceil(Lb / page_size)`` pages for every row and
    scatters the same compressed bytes page by page.
    """
    cfg = cache.cfg
    B, H, L, D = k.shape
    Lb = (L // cfg.block) * cfg.block
    if Lb > cache.capacity:
        raise ValueError(f"prompt's {Lb} block-aligned tokens exceed the "
                         f"compressed capacity {cache.capacity}")
    if cache.pages is not None:
        _prefill_paged(cache, k, v, Lb)
    elif cfg.policy == "none":
        cache.raw_k[..., :Lb, :] = k[..., :Lb, :]
        cache.raw_v[..., :Lb, :] = v[..., :Lb, :]
    elif Lb:
        k_perm, v_perm = calibrate_channel_tiers(k[..., :Lb, :], v[..., :Lb, :], cfg)
        kc, vc = compress_block(k[..., :Lb, :], v[..., :Lb, :], cfg, k_perm, v_perm)
        cache.k.chan_perm.copy_(k_perm)
        cache.v.chan_perm.copy_(v_perm)
        append_block(cache.k, kc, 0)
        append_block(cache.v, vc, 0)
    else:  # no full block: identity channel assignment (as the reference)
        eye = torch.arange(D, dtype=torch.int32, device=k.device)
        cache.k.chan_perm.copy_(eye.expand_as(cache.k.chan_perm))
        cache.v.chan_perm.copy_(eye.expand_as(cache.v.chan_perm))
    rem = L - Lb
    if rem:
        cache.resid_k[..., :rem, :] = k[..., Lb:, :]
        cache.resid_v[..., :rem, :] = v[..., Lb:, :]
    cache.n_comp.fill_(Lb)
    cache.n_resid.fill_(rem)
    return cache


def _prefill_paged(cache: LayerKVCache, k, v, Lb: int) -> None:
    """The compressed half of a whole-batch paged prefill: every row pops
    its pages; identical compression math to the dense path."""
    cfg = cache.cfg
    pool = cache.pages
    k_pg = cdiv(Lb, cfg.page_size)
    if k.shape[0] * k_pg > pool.n_pool_pages:
        raise ValueError(
            f"whole-batch paged prefill needs {k.shape[0] * k_pg} pages but "
            f"the pool has {pool.n_pool_pages}; an oversubscribed pool "
            "admits through insert_prefill (page-reservation scheduling)")
    phys = pool_pop_all_rows(pool, k_pg)
    if not k_pg:
        return
    if cfg.policy == "none":
        _scatter_pages(cache.raw_k, k[..., :Lb, :], phys, axis=-2)
        _scatter_pages(cache.raw_v, v[..., :Lb, :], phys, axis=-2)
        return
    k_perm, v_perm = calibrate_channel_tiers(k[..., :Lb, :], v[..., :Lb, :], cfg)
    kc, vc = compress_block(k[..., :Lb, :], v[..., :Lb, :], cfg, k_perm, v_perm)
    _scatter_pages_tiered(cache.k, kc, phys)
    _scatter_pages_tiered(cache.v, vc, phys)
    cache.k.chan_perm.copy_(k_perm)
    cache.v.chan_perm.copy_(v_perm)


def flush_rows(cache: LayerKVCache) -> list[int]:
    """Rows whose residual is full, so the next append flushes them (a
    host read of the counters: one device sync). A paged row at capacity
    never flushes (``append_token``)."""
    full = cache.n_resid >= cache.cfg.residual
    if cache.pages is not None:
        full &= cache.n_comp + cache.cfg.block <= cache.capacity
    return torch.nonzero(full).flatten().tolist()


def _flush_paged(cache: LayerKVCache, idx: torch.Tensor, blk_k, blk_v) -> None:
    """Page-granular flush of rows ``idx`` (int64 [m], ascending), IN
    PLACE: each compresses its oldest block into its current page at
    ``n_comp % page_size``; a row on a page boundary pops a fresh page
    first.

    COPY-ON-WRITE: a row about to write into a page with ``ref > 1`` pops
    a private page instead, copies the shared page into it through the
    read-modify-write, and drops its reference to the shared one, whose
    bytes never change."""
    cfg = cache.cfg
    pool = cache.pages
    page = pool.page_size
    n = cache.n_comp[idx]
    lp = n // page  # logical page the block lands in
    wo = n % page  # within-page token offset (block-aligned)
    lp_c = torch.clamp(lp, 0, pool.max_pages - 1).to(torch.int64)
    old = pool.page_table[idx, lp_c]
    cow = (wo > 0) & (pool.ref[old.to(torch.int64)] > 1)
    pool_pop_rows(pool, (wo == 0) | cow, lp, rows=idx)
    phys = pool.page_table[idx, lp_c]
    phys_r = torch.where(cow, old, phys)
    _pool_release_ids(pool, torch.where(cow, old, pool.n_pool_pages))
    if cfg.policy == "none":
        _pool_write_rows(cache.raw_k, blk_k, phys_r, phys, wo, axis=-2)
        _pool_write_rows(cache.raw_v, blk_v, phys_r, phys, wo, axis=-2)
        return
    kc, vc = compress_block(blk_k, blk_v, cfg, cache.k.chan_perm[idx],
                            cache.v.chan_perm[idx])
    _pool_write_tiered(cache.k, kc, phys_r, phys, wo)
    _pool_write_tiered(cache.v, vc, phys_r, phys, wo)


def append_token(cache: LayerKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 rows: list[int] | None = None, *, ring: bool = False
                 ) -> LayerKVCache:
    """Decode-step append at per-row offsets, IN PLACE. k_new/v_new:
    [B,H,1,D].

    Rows whose residual is full first compress their oldest block and
    append it to the compressed region at their own ``n_comp``, and their
    residual rolls left by one block. ``rows`` is the list of such rows
    when the caller already knows it (``flush_rows``; the counters are the
    same in every layer); None reads it from this cache's counters.

    ``ring``: sliding-window mode (recurrentgemma's local attention). The
    compressed region is a circular block buffer of ``capacity`` tokens: a
    flush writes at ``n_comp % capacity``, over the oldest block once the
    window is full, and ``n_comp`` keeps counting. Decode attention is
    invariant to the order of its tokens, so callers read the buffer with
    ``n_valid = min(n_comp, capacity)``. Paged storage has no ring mode.

    A paged row at capacity never flushes: an over-capacity flush would
    pop a page the scheduler's reservation never counted. Its residual
    write then lands on the last slot (the clamp), degrading that row's
    newest token; the scheduler rejects requests past capacity + residual.
    """
    cfg = cache.cfg
    blk = cfg.block
    if ring and cache.pages is not None:
        raise ValueError("paged storage has no ring (sliding-window) mode")
    if rows is None:
        rows = flush_rows(cache)
    if rows:
        idx = torch.tensor(rows, device=cache.n_comp.device)
        blk_k = cache.resid_k[idx, :, :blk]
        blk_v = cache.resid_v[idx, :, :blk]
        if cache.pages is not None:
            _flush_paged(cache, idx, blk_k, blk_v)
        elif cfg.policy == "none":
            offs = cache.n_comp[idx].tolist()
            if ring:
                offs = [off % cache.capacity for off in offs]
            for r, off in zip(rows, offs):
                s = max(0, min(off, cache.capacity - blk))  # reference clamp
                cache.raw_k[r, :, s:s + blk] = cache.resid_k[r, :, :blk]
                cache.raw_v[r, :, s:s + blk] = cache.resid_v[r, :, :blk]
        else:
            offs = cache.n_comp[idx].tolist()
            if ring:
                offs = [off % cache.capacity for off in offs]
            kc, vc = compress_block(blk_k, blk_v, cfg, cache.k.chan_perm[idx],
                                    cache.v.chan_perm[idx])
            append_block_rows(cache.k, kc, offs, rows)
            append_block_rows(cache.v, vc, offs, rows)
        cache.resid_k[idx] = torch.roll(cache.resid_k[idx], -blk, dims=-2)
        cache.resid_v[idx] = torch.roll(cache.resid_v[idx], -blk, dims=-2)
        cache.n_comp[idx] += blk
        cache.n_resid[idx] -= blk
    row_update_tokens(cache.resid_k, k_new, cache.n_resid)
    row_update_tokens(cache.resid_v, v_new, cache.n_resid)
    cache.n_resid += 1
    return cache


def append_window(cache: LayerKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  lens: torch.Tensor, rows: list[int] | None = None
                  ) -> LayerKVCache:
    """Speculative verify-window append, IN PLACE. k_new/v_new:
    [B, H, w, D]; lens: int [B] in [1, w], row b's valid window length
    (seed + drafts).

    Position 0 (the seed, the row's last committed token) goes through
    ``append_token`` with the caller's ``rows``: it may flush a block or
    pop a page and it advances the counters, as a plain decode step does.
    Drafts i = 1..w-1 are written into the residual buffer at
    ``n_resid + i - 1`` (clipped to R - 1) where ``i < lens``, on the
    device, with no counter moved and no flush: they stay invisible to
    every masked read until ``commit_window`` advances ``n_resid`` over
    the accepted prefix, and a rejected draft is dead bytes the next seed
    overwrites. The caller caps ``lens`` so ``n_resid + lens - 1 <= R``
    after the seed append (the scheduler's headroom cap), so a window
    never crosses a flush or a page pop."""
    w = k_new.shape[-2]
    append_token(cache, k_new[..., :1, :], v_new[..., :1, :], rows)
    R = cache.cfg.residual
    for i in range(1, w):
        write = (i < lens).reshape(-1, 1, 1, 1)
        off = torch.clamp(cache.n_resid + (i - 1), 0, R - 1)
        for buf, new in ((cache.resid_k, k_new), (cache.resid_v, v_new)):
            idx = off.to(torch.int64).reshape(-1, 1, 1, 1).expand(
                -1, buf.shape[1], 1, buf.shape[-1])
            old = torch.gather(buf, -2, idx)
            row_update_tokens(buf, torch.where(write, new[..., i:i + 1, :], old),
                              off)
    return cache


def commit_window(cache: LayerKVCache, n_accept: torch.Tensor) -> LayerKVCache:
    """Commit the accepted draft prefix of a verify window
    (``append_window``), IN PLACE: ``n_resid += n_accept`` (int [B], zero
    for free or fully rejected rows). The accepted bytes already sit at
    their residual offsets and drafts never touched the compressed region
    or the page ledger, so nothing else moves."""
    cache.n_resid += n_accept.to(cache.n_resid.dtype)
    return cache


# ---------------------------------------------------------------------------
# Per-slot lifecycle (continuous batching)
# ---------------------------------------------------------------------------


def reset_slot(cache: LayerKVCache, slot: int) -> LayerKVCache:
    """Free row ``slot`` IN PLACE: zero its counters so every cached token
    is masked (buffer bytes stay; the next insert overwrites the row). A
    paged row first releases its live pages (a free slot holds none)."""
    if cache.pages is not None:
        pool_release_row(cache.pages, slot,
                         live_pages(cache.n_comp[slot], cache.pages.page_size))
    cache.n_comp[slot] = 0
    cache.n_resid[slot] = 0
    return cache


def mask_free_slots(cache: LayerKVCache, active) -> LayerKVCache:
    """Zero, IN PLACE, the counters of rows where ``active`` (bool [B])
    is False."""
    act = torch.as_tensor(active, device=cache.n_comp.device).to(cache.n_comp.dtype)
    cache.n_comp *= act
    cache.n_resid *= act
    return cache


def _leaves(cache: LayerKVCache) -> list[torch.Tensor]:
    out = []
    for tc in (cache.k, cache.v):
        if tc is not None:
            for t in tc.tiers:
                out += [t.payload, t.mins, t.shifts]
            out += [tc.chan_perm, tc.scale, tc.zero]
    for x in (cache.raw_k, cache.raw_v, cache.resid_k, cache.resid_v,
              cache.n_comp, cache.n_resid):
        if x is not None:
            out.append(x)
    return out


def insert_row(cache: LayerKVCache, slot: int, row_cache: LayerKVCache
               ) -> LayerKVCache:
    """Copy batch-row 0 of ``row_cache`` into row ``slot`` of ``cache``,
    IN PLACE. Both caches have the same dense layout; ``row_cache`` has
    B=1."""
    for dst, src in zip(_leaves(cache), _leaves(row_cache)):
        dst[slot] = src[0]
    return cache


def insert_prefill(cache: LayerKVCache, slot: int, k: torch.Tensor,
                   v: torch.Tensor) -> LayerKVCache:
    """Admit one sequence into row ``slot``: compress its prefill K/V
    ([H, L, D] or [1, H, L, D]) exactly as a B=1 ``prefill_cache`` would
    and overwrite the row. A paged cache compresses through a dense
    mini-cache sized to the prompt (the same bytes) and scatters it into
    freshly popped pages (``insert_row_paged``)."""
    if k.dim() == 3:
        k, v = k[None], v[None]
    cfg, dev = cache.cfg, k.device
    if cache.pages is not None:
        dense_cfg, cap_mini, n_pages = paged_mini_spec(cfg, k.shape[-2])
        sub = alloc_layer_cache(dense_cfg, 1, k.shape[-3], k.shape[-1],
                                cap_mini, dtype=cache.resid_k.dtype, device=dev)
        return insert_row_paged(cache, slot, prefill_cache(sub, k, v), n_pages)
    sub = alloc_layer_cache(cfg, 1, k.shape[-3], k.shape[-1], cache.capacity,
                            dtype=cache.resid_k.dtype, device=dev)
    return insert_row(cache, slot, prefill_cache(sub, k, v))


def paged_mini_spec(cfg: PackKVConfig, L: int) -> tuple[PackKVConfig, int, int]:
    """(dense_cfg, cap_mini, n_pages) for admitting an ``L``-token prompt
    into a paged cache through a dense mini-cache. The mini capacity is
    ``n_pages`` whole pages (at least one) so the page scatter's zero
    padding lines up."""
    Lb = (L // cfg.block) * cfg.block
    cap_mini = max(cfg.page_size, round_up(Lb, cfg.page_size))
    return dataclasses.replace(cfg, paged=False), cap_mini, cdiv(Lb, cfg.page_size)


def insert_row_paged(cache: LayerKVCache, slot: int, row: LayerKVCache,
                     n_pages: int, n_shared: int = 0,
                     shared_phys: torch.Tensor | None = None) -> LayerKVCache:
    """Scatter a DENSE single-row cache into row ``slot`` of a paged cache,
    IN PLACE: the slot's old pages are released, ``n_pages - n_shared``
    fresh ones popped, and ``row``'s newly compressed bytes (capacity
    ``n_pages`` whole pages) land in them page by page; residual,
    counters and ``chan_perm`` are copied slot-wise.

    PREFIX SHARING: ``shared_phys`` (int [n_shared]) maps held pages into
    the table's leading entries by reference (``pool_map_prefix``); their
    bytes are not touched and ``row``'s first ``n_shared`` pages are
    ignored (they were seeded from those pages, ``seed_prefix_from_pages``)."""
    pool = cache.pages
    page = pool.page_size
    pool_release_row(pool, slot, live_pages(cache.n_comp[slot], page))
    if n_shared:
        pool_map_prefix(pool, slot, shared_phys)
    phys = pool_pop_prefix(pool, slot, n_pages - n_shared, lp0=n_shared)[None]
    start = n_shared * page
    if n_pages - n_shared and cache.cfg.policy == "none":
        _scatter_pages(cache.raw_k, row.raw_k[..., start:, :], phys, axis=-2)
        _scatter_pages(cache.raw_v, row.raw_v[..., start:, :], phys, axis=-2)
    elif n_pages - n_shared:
        _scatter_pages_tiered(cache.k, slice_tiered_suffix(row.k, start), phys)
        _scatter_pages_tiered(cache.v, slice_tiered_suffix(row.v, start), phys)
    if cache.cfg.policy != "none":
        cache.k.chan_perm[slot] = row.k.chan_perm[0]
        cache.v.chan_perm[slot] = row.v.chan_perm[0]
    for dst, src in ((cache.resid_k, row.resid_k), (cache.resid_v, row.resid_v),
                     (cache.n_comp, row.n_comp), (cache.n_resid, row.n_resid)):
        dst[slot] = src[0]
    return cache


# ---------------------------------------------------------------------------
# Prefix sharing (refcounted pages; the host side is serving/engine.py's)
# ---------------------------------------------------------------------------


def _per_layer(cache, fn):
    """Apply ``fn`` to one ``LayerKVCache`` or to each of a model's list."""
    for layer in (cache if isinstance(cache, list) else [cache]):
        fn(layer)
    return cache


def share_pages(cache, slot: int, phys: torch.Tensor):
    """Map held pages ``phys`` (int [k]) into the leading table entries of
    row ``slot`` by reference on every layer, IN PLACE (``ref += 1``; bytes
    untouched; counters are the caller's)."""
    return _per_layer(cache, lambda c: pool_map_prefix(c.pages, slot, phys))


def acquire_pages(cache, ids: torch.Tensor):
    """Add one reference per entry of ``ids`` on every layer's pool, IN
    PLACE: how the prefix index pins its pages. Sentinels (``>=
    pool_pages``) are ignored, so callers may pad to a fixed length."""
    return _per_layer(cache, lambda c: pool_acquire_ids(c.pages, ids))


def release_pages(cache, ids: torch.Tensor):
    """Drop one reference per entry of ``ids`` on every layer's pool, IN
    PLACE; pages reaching ``ref == 0`` return to the free stack (prefix
    index eviction). Sentinels are ignored."""
    return _per_layer(cache, lambda c: _pool_release_ids(c.pages, ids))


def seed_prefix_from_pages(cache: LayerKVCache, mini: LayerKVCache,
                           phys: torch.Tensor, n_prefix: int,
                           k_perm: torch.Tensor | None = None,
                           v_perm: torch.Tensor | None = None) -> LayerKVCache:
    """Seed a DENSE mini-cache, IN PLACE, with the shared compressed prefix
    held by pool pages ``phys`` (int [k], ``k * page_size == n_prefix``) of
    the paged ``cache``: its leading tokens, ``n_comp = n_prefix``,
    ``n_resid = 0``. ``k_perm`` / ``v_perm`` ([H_kv, D], from the prefix
    index) restore the channel permutation the prefix was compressed
    under, so the suffix compresses under the same one."""
    idx = phys[None]
    if cache.cfg.policy == "none":
        mini.raw_k[..., :n_prefix, :] = gather_pool_leaf(cache.raw_k, idx, token_axis=-2)
        mini.raw_v[..., :n_prefix, :] = gather_pool_leaf(cache.raw_v, idx, token_axis=-2)
    else:
        write_tiered_prefix(mini.k, gather_tiered_pages(cache.k, idx))
        write_tiered_prefix(mini.v, gather_tiered_pages(cache.v, idx))
        mini.k.chan_perm.copy_(k_perm[None])
        mini.v.chan_perm.copy_(v_perm[None])
    mini.n_comp.fill_(n_prefix)
    mini.n_resid.zero_()
    return mini


def prefill_append(cache: LayerKVCache, k: torch.Tensor, v: torch.Tensor,
                   calibrate: bool) -> LayerKVCache:
    """Append one prefill segment's K/V ([B,H,S,D]) to a DENSE cache at each
    row's own ``n_comp``, IN PLACE (the chunked-prefill building block).

    Preconditions: ``n_resid == 0`` and ``n_comp`` block-aligned on every
    row. Whole blocks compress under the cache's ``chan_perm``;
    ``calibrate`` (the first segment of a cold admission) computes it from
    this segment first, so every request that shares the first page shares
    the calibration. The sub-block remainder goes to the residual."""
    cfg = cache.cfg
    S = k.shape[-2]
    Lb = (S // cfg.block) * cfg.block
    if Lb:
        kb, vb = k[..., :Lb, :], v[..., :Lb, :]
        if cfg.policy == "none":
            row_update_tokens(cache.raw_k, kb, cache.n_comp)
            row_update_tokens(cache.raw_v, vb, cache.n_comp)
        else:
            if calibrate:
                k_perm, v_perm = calibrate_channel_tiers(kb, vb, cfg)
                cache.k.chan_perm.copy_(k_perm)
                cache.v.chan_perm.copy_(v_perm)
            kc, vc = compress_block(kb, vb, cfg, cache.k.chan_perm, cache.v.chan_perm)
            offs = cache.n_comp.tolist()
            append_block_rows(cache.k, kc, offs)
            append_block_rows(cache.v, vc, offs)
    elif calibrate and cfg.policy != "none":  # sub-block prompt: identity
        k_perm, v_perm = calibrate_channel_tiers(k[..., :0, :], v[..., :0, :], cfg)
        cache.k.chan_perm.copy_(k_perm)
        cache.v.chan_perm.copy_(v_perm)
    rem = S - Lb
    if rem:
        row_update_tokens(cache.resid_k, k[..., Lb:, :], cache.n_resid)
        row_update_tokens(cache.resid_v, v[..., Lb:, :], cache.n_resid)
    cache.n_comp += Lb
    cache.n_resid += rem
    return cache


# ---------------------------------------------------------------------------
# Preemption and sessions: a row out to a dense B=1 mini-cache and back
# ---------------------------------------------------------------------------


def evacuate_row(cache, slot: int, n_pages: int = 0, n_shared: int = 0):
    """Evacuate row ``slot`` into a dense batch-1 mini-cache and FREE the
    row, on one ``LayerKVCache`` or each of a model's list. Returns
    ``(cache, mini)``: the cache updated IN PLACE (exactly a
    ``reset_slot``), the mini a fresh copy (a list for a list), so the
    next admission into the slot cannot reach it.

    Dense: the mini copies the row's every leaf at full capacity
    (``n_pages`` / ``n_shared`` ignored). Paged: ``n_pages`` must be the
    row's live page count ``ceil(n_comp / page_size)``, which the
    scheduler mirrors on the host; the leading ``n_shared`` pages are a
    prefix mapped by reference, whose bytes are NOT copied: the row's
    reference is released (the prefix index still pins them) and
    ``restore_row`` maps the same ids back. The mini then holds only the
    ``n_pages - n_shared`` owned suffix pages in its leading tokens, plus
    the row's residual, counters (the full row's, prefix included) and
    channel permutation. No forward pass runs."""
    if isinstance(cache, list):
        return cache, [evacuate_row(layer, slot, n_pages, n_shared)[1]
                       for layer in cache]
    if cache.pages is None:
        mini = tree_map(lambda t: t[slot:slot + 1].clone(), cache)
    else:
        mini = _evacuate_row_paged(cache, slot, n_pages, n_shared)
    cache.n_comp[slot] = 0
    cache.n_resid[slot] = 0
    return cache, mini


def _evacuate_row_paged(cache: LayerKVCache, slot: int, n_pages: int,
                        n_shared: int) -> LayerKVCache:
    """The paged mini (a fresh dense B=1 cache) of row ``slot``; the row's
    live pages are released, one reference each, after the gather."""
    cfg, pool = cache.cfg, cache.pages
    page = pool.page_size
    h_kv, head_dim = cache.resid_k.shape[1], cache.resid_k.shape[-1]
    k_sfx = n_pages - n_shared  # suffix pages whose bytes the row owns
    if k_sfx < 0:
        raise ValueError(f"n_shared {n_shared} exceeds n_pages {n_pages}")
    mini = alloc_layer_cache(dataclasses.replace(cfg, paged=False), 1, h_kv,
                             head_dim, max(page, k_sfx * page),
                             dtype=cache.resid_k.dtype, device=cache.n_comp.device)
    if k_sfx:
        idx = pool.page_table[slot:slot + 1, n_shared:n_pages]
        if cfg.policy == "none":
            n = k_sfx * page
            mini.raw_k[..., :n, :] = gather_pool_leaf(cache.raw_k, idx, token_axis=-2)
            mini.raw_v[..., :n, :] = gather_pool_leaf(cache.raw_v, idx, token_axis=-2)
        else:
            write_tiered_prefix(mini.k, gather_tiered_pages(cache.k, idx))
            write_tiered_prefix(mini.v, gather_tiered_pages(cache.v, idx))
    if cfg.policy != "none":
        mini.k.chan_perm.copy_(cache.k.chan_perm[slot:slot + 1])
        mini.v.chan_perm.copy_(cache.v.chan_perm[slot:slot + 1])
    for dst, src in ((mini.resid_k, cache.resid_k), (mini.resid_v, cache.resid_v),
                     (mini.n_comp, cache.n_comp), (mini.n_resid, cache.n_resid)):
        dst.copy_(src[slot:slot + 1])
    # every live page gives back one reference: shared-prefix pages stay
    # alive through the index's pin
    pool_release_row(pool, slot, live_pages(cache.n_comp[slot], page))
    return mini


def restore_row(cache, slot: int, mini, shared_phys: torch.Tensor | None = None,
                n_pages: int = 0, n_shared: int = 0):
    """Stream an evacuated row back into row ``slot`` (the inverse of
    ``evacuate_row``), IN PLACE, on one ``LayerKVCache`` (``mini`` one
    mini) or each of a model's list (``mini`` a list). ``mini`` must lie
    on the cache's device.

    Dense: a plain ``insert_row``. Paged: the ``n_shared`` prefix pages
    ``shared_phys`` (int [n_shared], the ids the row released) are mapped
    back by reference, ``n_pages - n_shared`` fresh pages popped and the
    mini's suffix bytes scattered into them; residual, counters and
    channel permutation are restored slot-wise. Only the page placement
    may differ from before the evacuation, and every read goes through
    the page table, so decode resumes bitwise. No forward pass runs."""
    if isinstance(cache, list):
        for layer, m in zip(cache, mini):
            restore_row(layer, slot, m, shared_phys, n_pages, n_shared)
        return cache
    if cache.pages is None:
        return insert_row(cache, slot, mini)
    cfg, pool = cache.cfg, cache.pages
    k_sfx = n_pages - n_shared
    # a restored slot was free: this release is a no-op kept for safety
    pool_release_row(pool, slot, live_pages(cache.n_comp[slot], pool.page_size))
    if n_shared:
        pool_map_prefix(pool, slot, shared_phys)
    phys = pool_pop_prefix(pool, slot, k_sfx, lp0=n_shared)[None]
    if k_sfx and cfg.policy == "none":
        _scatter_pages(cache.raw_k, mini.raw_k, phys, axis=-2)
        _scatter_pages(cache.raw_v, mini.raw_v, phys, axis=-2)
    elif k_sfx:
        _scatter_pages_tiered(cache.k, mini.k, phys)
        _scatter_pages_tiered(cache.v, mini.v, phys)
    if cfg.policy != "none":
        cache.k.chan_perm[slot] = mini.k.chan_perm[0]
        cache.v.chan_perm[slot] = mini.v.chan_perm[0]
    for dst, src in ((cache.resid_k, mini.resid_k), (cache.resid_v, mini.resid_v),
                     (cache.n_comp, mini.n_comp), (cache.n_resid, mini.n_resid)):
        dst[slot] = src[0]
    return cache


class SwapStore:
    """Host-RAM tier of evacuated (preempted) rows: request id -> (host
    copy of the mini-cache, scheduler metadata). The swapped bytes are the
    compressed pages plus one residual buffer, not raw K/V. Pure host
    state: the device transfers are ``evacuate_row``'s gather before a
    put and ``restore_row``'s scatter after a pop."""

    def __init__(self):
        self._rows: dict[int, tuple[object, dict]] = {}
        self.swapped_out = 0  # evacuations stored (cumulative)
        self.swapped_in = 0  # restorations served (cumulative)
        self.peak_bytes = 0

    def put(self, rid: int, mini, meta: dict) -> None:
        if rid in self._rows:
            raise AssertionError(f"rid {rid} already swapped out")
        self._rows[rid] = (to_host(mini), dict(meta))
        self.swapped_out += 1
        self.peak_bytes = max(self.peak_bytes, self.nbytes)

    def pop(self, rid: int) -> tuple[object, dict]:
        """Remove and return (mini, meta) for re-admission."""
        row = self._rows.pop(rid)
        self.swapped_in += 1
        return row

    def drop(self, rid: int) -> None:
        """Discard a swapped row (its request was cancelled or expired)."""
        self._rows.pop(rid, None)

    def meta(self, rid: int) -> dict:
        return self._rows[rid][1]

    def metas(self):
        """The metadata of every swapped row."""
        return (m for _, m in self._rows.values())

    def __contains__(self, rid: int) -> bool:
        return rid in self._rows

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def nbytes(self) -> int:
        """Host bytes of every swapped row (scalar leaves count zero)."""
        return sum(getattr(leaf, "nbytes", 0) for mini, _ in self._rows.values()
                   for leaf in tree_flatten(mini)[0])


class SessionStore:
    """Parked multi-turn sessions, host-side (voluntary, unlike
    ``SwapStore``'s preempted rows): rows parked at retirement so a
    returning session skips its re-prefill.

    Keys are the session's raw token trace (prompt + generated, int64
    bytes), so they never collide with ``SwapStore``'s integer request
    ids; ``match`` finds the longest parked trace that prefixes a prompt.
    The host tier holds copies of the evacuated minis, LRU by bytes
    against ``capacity_bytes``; with ``disk_dir`` its LRU victims spill
    to disk through ``checkpoint.sharded.save_mini`` instead of being
    dropped. ``ttl_s`` expires idle entries on both tiers, checked at
    every public call against the injectable ``clock``. Metadata (prefix
    trie nodes included) stays on the host; only the mini's tensors
    spill. Same process only: the structure for loading is the first
    park's."""

    def __init__(self, capacity_bytes: int = 256 << 20, ttl_s: Optional[float] = None,
                 disk_dir: Optional[str] = None, clock=None):
        self.capacity_bytes = int(capacity_bytes)
        self.ttl_s = ttl_s
        self.disk_dir = disk_dir
        self.clock = clock if clock is not None else time.monotonic
        # key -> {mini, meta, nbytes, t_used}; order == recency (LRU first)
        self._host: OrderedDict[bytes, dict] = OrderedDict()
        self._disk: OrderedDict[bytes, dict] = OrderedDict()  # key -> {path, ...}
        self._len_count: dict[int, int] = {}  # trace length -> entries
        self._treedef = None
        self.parks = 0  # entries stored (cumulative)
        self.hits = 0  # entries served back
        self.evictions = 0  # capacity or replacement drops (entry lost)
        self.expired = 0  # TTL or forced expiries (entry lost)
        self.spills = 0  # host -> disk demotions
        self.loads = 0  # disk -> caller promotions
        self.peak_bytes = 0

    # -- keys ---------------------------------------------------------------
    @staticmethod
    def key_of(trace) -> bytes:
        return np.ascontiguousarray(np.asarray(trace, np.int64)).tobytes()

    @staticmethod
    def trace_of(key: bytes) -> np.ndarray:
        return np.frombuffer(key, np.int64)

    def _len_add(self, key: bytes, d: int) -> None:
        n = len(key) // 8
        c = self._len_count.get(n, 0) + d
        assert c >= 0
        if c:
            self._len_count[n] = c
        else:
            self._len_count.pop(n, None)

    # -- internals ----------------------------------------------------------
    def _spill_path(self, key: bytes) -> str:
        return os.path.join(self.disk_dir, f"sess-{hashlib.sha1(key).hexdigest()}")

    def _forget(self, key: bytes, counter: str) -> None:
        """Drop ``key`` from whichever tier holds it."""
        ent = self._host.pop(key, None)
        if ent is None:
            ent = self._disk.pop(key, None)
            if ent is not None:
                shutil.rmtree(ent["path"], ignore_errors=True)
        if ent is not None:
            self._len_add(key, -1)
            setattr(self, counter, getattr(self, counter) + 1)

    def _purge(self) -> None:
        if self.ttl_s is None:
            return
        now = self.clock()
        for tier in (self._host, self._disk):
            for key in [k for k, e in tier.items() if now - e["t_used"] > self.ttl_s]:
                self._forget(key, "expired")

    def _shrink(self) -> None:
        """LRU-evict (or spill to disk) until the host tier fits."""
        from ..checkpoint.sharded import save_mini

        while self.nbytes > self.capacity_bytes and self._host:
            key, ent = next(iter(self._host.items()))
            if self.disk_dir is not None:
                path = self._spill_path(key)
                save_mini(path, ent["mini"])
                del self._host[key]
                self._disk[key] = {"path": path, "meta": ent["meta"],
                                   "nbytes": ent["nbytes"], "t_used": ent["t_used"]}
                self.spills += 1
            else:
                self._forget(key, "evictions")

    # -- public -------------------------------------------------------------
    def put(self, trace, mini, meta: dict) -> None:
        """Park a session under its token ``trace``; a re-park of the same
        trace replaces the old entry (which counts as evicted)."""
        self._purge()
        key = self.key_of(trace)
        if key in self._host or key in self._disk:
            self._forget(key, "evictions")
        host_mini = to_host(mini)
        leaves, treedef = tree_flatten(host_mini)
        if self._treedef is None:
            self._treedef = treedef
        nbytes = sum(leaf_nbytes(x) for x in leaves)
        self._host[key] = {"mini": host_mini, "meta": dict(meta),
                           "nbytes": nbytes, "t_used": self.clock()}
        self._len_add(key, +1)
        self.parks += 1
        self.peak_bytes = max(self.peak_bytes, self.nbytes)
        self._shrink()

    def match(self, tokens) -> Optional[bytes]:
        """The longest parked trace that prefixes ``tokens``: a peek
        (``take`` claims it), so a blocked admission can retry."""
        self._purge()
        if not self._len_count:
            return None
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
        for n in sorted(self._len_count, reverse=True):
            if n > len(toks):
                continue
            key = toks[:n].tobytes()
            if key in self._host or key in self._disk:
                return key
        return None

    def meta(self, key: bytes) -> dict:
        ent = self._host.get(key) or self._disk.get(key)
        return ent["meta"]

    def take(self, key: bytes):
        """Claim a matched entry: remove it and return ``(mini, meta)``,
        loading it back from disk if it was spilled."""
        ent = self._host.pop(key, None)
        if ent is not None:
            mini, meta = ent["mini"], ent["meta"]
        else:
            from ..checkpoint.sharded import load_mini

            ent = self._disk.pop(key)
            mini, _ = load_mini(ent["path"], self._treedef)
            meta = ent["meta"]
            shutil.rmtree(ent["path"], ignore_errors=True)
            self.loads += 1
        self._len_add(key, -1)
        self.hits += 1
        return mini, meta

    def drop(self, key: bytes) -> None:
        """Discard an entry that can no longer be served (its shared
        prefix pages left the index while it was parked)."""
        self._forget(key, "evictions")

    def _by_age(self) -> list[tuple[float, bytes]]:
        return sorted([(e["t_used"], k) for k, e in self._host.items()]
                      + [(e["t_used"], k) for k, e in self._disk.items()])

    def expire_now(self, n: int) -> int:
        """Force-expire the ``n`` least recently used entries of both tiers
        (the ``session_expire`` fault). Returns how many there were."""
        order = self._by_age()
        for _, key in order[:n]:
            self._forget(key, "expired")
        return min(n, len(order))

    def traces(self, n: int) -> list[np.ndarray]:
        """The ``n`` least recently used parked traces, oldest first (the
        ``resume`` fault builds returning sessions from them)."""
        return [self.trace_of(k) for _, k in self._by_age()[:n]]

    def __contains__(self, key: bytes) -> bool:
        return key in self._host or key in self._disk

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    @property
    def nbytes(self) -> int:
        """Host-tier bytes (disk entries count zero)."""
        return sum(e["nbytes"] for e in self._host.values())
