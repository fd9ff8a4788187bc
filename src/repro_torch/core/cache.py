"""Runtime PackKV cache manager, dense storage (paper III-B1/B4 + III-C glue).

The torch port of the dense half of ``repro/core/cache.py``. A fixed-size
residual buffer holds recent tokens in full precision; when a row's
residual is full, its oldest 64-token block is quantized, V-median
repacked, tier-packed and appended to that row's compressed region.

Sequence state is per row: ``n_comp``/``n_resid`` are int32 ``[B]``
tensors and rows flush independently. A model's cache is a Python list of
``LayerKVCache`` (one per layer), where the reference stacked layers on a
leading axis.

Where the reference returned a new cache from donated buffers, these
functions update the cache tensors IN PLACE and return the same object:
``prefill_cache``, ``append_token``, ``reset_slot``, ``mask_free_slots``
and ``insert_row``. ``slice_compressed`` returns views for reads only.

Invariants (as in the reference): ``n_comp`` is block-aligned; a flush
fires before the write that would overflow the residual; free slots have
zero counters at rest.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .quantization import QuantConfig
from .repacking import median_repack
from .tiered import (
    TierSpec,
    TieredCache,
    alloc_tiered,
    append_block,
    append_block_rows,
    assign_channel_tiers,
    choose_tier_spec,
    pack_tiered,
    required_channel_widths,
    slice_tiered_prefix,
)

BLOCK = 64  # truncated block size (consistent with KIVI, paper IV-A)


@dataclasses.dataclass(frozen=True)
class PackKVConfig:
    """Tunable knobs of the paper's pipeline (paper IV-A). Dense storage
    only: the paged pool arrives in a later slice."""

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
class LayerKVCache:
    """Per-layer decode cache, dense storage. ``k``/``v`` are None for
    policy 'none' (which keeps ``raw_k``/``raw_v`` instead)."""

    k: Optional[TieredCache]  # compressed region (channels-major)
    v: Optional[TieredCache]
    raw_k: Optional[torch.Tensor]  # policy 'none': bf16 [B, Hkv, Lcap, D]
    raw_v: Optional[torch.Tensor]
    resid_k: torch.Tensor  # bf16 [B, Hkv, R, D]
    resid_v: torch.Tensor
    n_comp: torch.Tensor  # int32 [B] tokens in the compressed/raw region
    n_resid: torch.Tensor  # int32 [B] tokens in the residual buffer
    cfg: PackKVConfig

    @property
    def capacity(self) -> int:
        return self.raw_k.shape[-2] if self.cfg.policy == "none" else self.k.capacity


def alloc_layer_cache(cfg: PackKVConfig, batch: int, h_kv: int, head_dim: int,
                      capacity: int, dtype=torch.bfloat16,
                      device="cuda") -> LayerKVCache:
    """Preallocate a dense cache with static ``capacity``."""
    R = cfg.residual
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    resid = lambda: z((batch, h_kv, R, head_dim), dtype)
    if cfg.policy == "none":
        raw = lambda: z((batch, h_kv, capacity, head_dim), dtype)
        return LayerKVCache(
            k=None, v=None, raw_k=raw(), raw_v=raw(), resid_k=resid(),
            resid_v=resid(), n_comp=z((batch,), torch.int32),
            n_resid=z((batch,), torch.int32), cfg=cfg,
        )
    return LayerKVCache(
        k=alloc_tiered(batch, h_kv, capacity, cfg.k_spec(head_dim), device),
        v=alloc_tiered(batch, h_kv, capacity, cfg.v_spec(head_dim), device),
        raw_k=None, raw_v=None, resid_k=resid(), resid_v=resid(),
        n_comp=z((batch,), torch.int32), n_resid=z((batch,), torch.int32),
        cfg=cfg,
    )


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
    Use only for reads: appends go through the full-capacity cache."""
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


def prefill_cache(cache: LayerKVCache, k: torch.Tensor, v: torch.Tensor
                  ) -> LayerKVCache:
    """Fill the cache IN PLACE from prefill K/V ([B,H,L,D]).

    Compresses all complete blocks (calibrating the channel tiers from
    them, per batch row and head); the remainder goes to the residual.
    """
    cfg = cache.cfg
    B, H, L, D = k.shape
    Lb = (L // cfg.block) * cfg.block
    if Lb > cache.capacity:
        raise ValueError(f"prompt's {Lb} block-aligned tokens exceed the "
                         f"compressed capacity {cache.capacity}")
    if cfg.policy == "none":
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


def flush_rows(cache: LayerKVCache) -> list[int]:
    """Rows whose residual is full, so the next append flushes them (a
    host read of the counters: one device sync)."""
    full = cache.n_resid >= cache.cfg.residual
    return torch.nonzero(full).flatten().tolist()


def append_token(cache: LayerKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 rows: list[int] | None = None) -> LayerKVCache:
    """Decode-step append at per-row offsets, IN PLACE. k_new/v_new:
    [B,H,1,D].

    Rows whose residual is full first compress their oldest block and
    append it to the compressed region at their own ``n_comp``, and their
    residual rolls left by one block. ``rows`` is the list of such rows
    when the caller already knows it (``flush_rows``; the counters are the
    same in every layer); None reads it from this cache's counters.
    """
    cfg = cache.cfg
    blk = cfg.block
    if rows is None:
        rows = flush_rows(cache)
    if rows:
        idx = torch.tensor(rows, device=cache.n_comp.device)
        offs = cache.n_comp[idx].tolist()
        blk_k = cache.resid_k[idx, :, :blk]
        blk_v = cache.resid_v[idx, :, :blk]
        if cfg.policy == "none":
            for r, off in zip(rows, offs):
                s = max(0, min(off, cache.capacity - blk))  # reference clamp
                cache.raw_k[r, :, s:s + blk] = cache.resid_k[r, :, :blk]
                cache.raw_v[r, :, s:s + blk] = cache.resid_v[r, :, :blk]
        else:
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


# ---------------------------------------------------------------------------
# Per-slot lifecycle (continuous batching)
# ---------------------------------------------------------------------------


def reset_slot(cache: LayerKVCache, slot: int) -> LayerKVCache:
    """Free row ``slot`` IN PLACE: zero its counters so every cached token
    is masked (buffer bytes stay; the next insert overwrites the row)."""
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
    IN PLACE. Both caches have the same layout; ``row_cache`` has B=1."""
    for dst, src in zip(_leaves(cache), _leaves(row_cache)):
        dst[slot] = src[0]
    return cache


def insert_prefill(cache: LayerKVCache, slot: int, k: torch.Tensor,
                   v: torch.Tensor) -> LayerKVCache:
    """Admit one sequence into row ``slot``: compress its prefill K/V
    ([H, L, D] or [1, H, L, D]) exactly as a B=1 ``prefill_cache`` would
    and overwrite the row."""
    if k.dim() == 3:
        k, v = k[None], v[None]
    sub = alloc_layer_cache(cache.cfg, 1, k.shape[-3], k.shape[-1],
                            cache.capacity, dtype=cache.resid_k.dtype,
                            device=k.device)
    return insert_row(cache, slot, prefill_cache(sub, k, v))
