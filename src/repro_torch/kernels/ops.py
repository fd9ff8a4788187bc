"""Entry points over the compressed cache, with backends.

The torch port of ``repro/kernels/ops.py`` (dense and paged storage).
Backends:

  * ``"ref"``   - the plain oracle math of ``kernels/ref.py`` (the
    reference's ``"xla"`` backend); the paged functions gather the live
    pages into the dense layout first;
  * ``"fused"`` - the hand-written kernels (the reference's ``"pallas"``
    backend). Decode attention: ``fused_packed_attention`` (K2; paged:
    ``fused_packed_attention_paged``, K5) for the compressed region,
    merged with the residual buffer's partials by log-sum-exp. The
    standalone tier matvecs (the paper's Fig. 8 / Fig. 11 kernels):
    ``packed_qk_scores`` launches ``kpack_tier_scores`` (K3; paged K6) and
    ``packed_weighted_v`` ``vpack_tier_out`` (K4; paged K7) once per tier,
    with the per-token scale and zero applied outside as rank-1
    corrections.
"""
from __future__ import annotations

import torch

from ..core.cache import gather_paged, slice_compressed
from ..core.tiered import (
    TieredCache,
    gather_page_meta,
    gather_tiered_pages,
    page_prefix_ids,
)
from . import ref
from .kpack_matvec import kpack_tier_scores, kpack_tier_scores_paged
from .packed_attention import (
    _rows_to_bh,
    fused_packed_attention,
    fused_packed_attention_paged,
)
from .vpack_matvec import vpack_tier_out, vpack_tier_out_paged

NEG_INF = ref.NEG_INF
BACKENDS = ("ref", "fused")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


def _tier_slices(tc: TieredCache):
    """(tier, its channel slice of the permuted head dim), in tier order."""
    offs = tc.spec.offsets()
    return [(t, slice(offs[i], offs[i + 1])) for i, t in enumerate(tc.tiers)]


def _perm_q(q, kc: TieredCache, BH: int) -> torch.Tensor:
    """q [B, H, D] -> f32 [BH, G, D] in K's tier channel order."""
    h_kv = kc.chan_perm.shape[1]
    return ref._perm_q(ref._grouped_q(q.to(torch.float32), h_kv),
                       kc.chan_perm).reshape(BH, -1, q.shape[-1])


def _k_scores(si, qf, scale, zero, nv, sm_scale: float, shape) -> torch.Tensor:
    """The rank-1 corrections of the tier scores: si * scale + sum(q) *
    zero, the zero term masked at and past ``nv`` (si already is)."""
    zc = zero[:, None, :]
    if nv is not None:
        zc = torch.where(ref.valid_mask(nv, si.shape[-1], lead=2), zc, 0.0)
    scores = si * scale[:, None, :] + qf.sum(-1, keepdim=True) * zc
    return (scores * sm_scale).reshape(shape)


def _v_out(parts, wf, zero, nv, chan_perm, shape) -> torch.Tensor:
    """The tiers' outputs in tier order plus the zero term (weights masked
    at and past ``nv``), un-permuted to the original channel order."""
    out = torch.cat(parts, dim=-1)
    if nv is not None:
        wf = torch.where(ref.valid_mask(nv, wf.shape[-1], lead=2), wf, 0.0)
    out = out + torch.einsum("bgl,bl->bg", wf, zero)[..., None]
    B, h_kv = chan_perm.shape[:2]
    return ref._unpermute(out.reshape(B, h_kv, -1, out.shape[-1]),
                          chan_perm).reshape(shape)


def packed_qk_scores(q: torch.Tensor, kc: TieredCache, sm_scale: float = 1.0,
                     *, n_valid=None, backend: str = "fused",
                     tile_l: int = 256) -> torch.Tensor:
    """q . K^T over the compressed K cache. q: [B, H, D] -> scores f32
    [B, H, L].

    n_valid (scalar or per-row [B]): scores of positions at or past the
    row's valid length are zero (callers still mask before a softmax)."""
    B, H, D = q.shape
    h_kv = kc.scale.shape[-2]
    L = kc.capacity
    if backend == "ref":
        s = ref.kpack_scores_ref(q, kc, sm_scale)
        if n_valid is not None:
            n = torch.as_tensor(n_valid, device=q.device)
            s = torch.where(ref.valid_mask(n, L, lead=2), s, 0.0)
        return s
    _check_backend(backend)
    BH = B * h_kv
    qf = _perm_q(q, kc, BH)
    flat = lambda a: a.reshape(BH, *a.shape[2:])
    nv = None if n_valid is None else _rows_to_bh(n_valid, B, h_kv, q.device)
    si = torch.zeros((BH, H // h_kv, L), dtype=torch.float32, device=q.device)
    for t, c in _tier_slices(kc):
        si = si + kpack_tier_scores(
            flat(t.payload), flat(t.mins), flat(t.shifts), qf[..., c],
            width=t.width, pack_size=t.pack_size, n_valid=nv, tile_l=tile_l)
    return _k_scores(si, qf, flat(kc.scale), flat(kc.zero), nv, sm_scale, (B, H, L))


def packed_weighted_v(w: torch.Tensor, vc: TieredCache, *, n_valid=None,
                      backend: str = "fused", tile_l: int = 256) -> torch.Tensor:
    """w . V over the compressed V cache. w: [B, H, L] -> out f32 [B, H, D]
    in the original channel order.

    n_valid (scalar or per-row [B]): positions at or past the row's valid
    length contribute nothing."""
    B, H, L = w.shape
    h_kv = vc.scale.shape[-2]
    if backend == "ref":
        if n_valid is not None:
            n = torch.as_tensor(n_valid, device=w.device)
            w = torch.where(ref.valid_mask(n, L, lead=2), w, 0.0)
        return ref.vpack_out_ref(w, vc)
    _check_backend(backend)
    BH = B * h_kv
    flat = lambda a: a.reshape(BH, *a.shape[2:])
    nv = None if n_valid is None else _rows_to_bh(n_valid, B, h_kv, w.device)
    wf = w.to(torch.float32).reshape(BH, H // h_kv, L)
    ws = wf * flat(vc.scale)[:, None, :]
    parts = [vpack_tier_out(flat(t.payload), flat(t.mins), flat(t.shifts), ws,
                            width=t.width, pack_size=t.pack_size, n_valid=nv,
                            tile_l=tile_l)
             for t in vc.tiers]
    return _v_out(parts, wf, flat(vc.zero), nv, vc.chan_perm, (B, H, -1))


def packed_qk_scores_paged(q: torch.Tensor, kc: TieredCache, pages,
                           n_tokens: int, sm_scale: float = 1.0, *, n_valid,
                           backend: str = "fused",
                           tile_l: int = 256) -> torch.Tensor:
    """``packed_qk_scores`` over a PAGED K cache.

    kc: pool-layout TieredCache; pages: ``core.cache.PagePool``; n_tokens:
    the launch bucket (a whole number of pages). ``ref`` gathers the live
    pages into the dense layout first; ``fused`` resolves each token's
    physical page inside K6. Returns scores f32 [B, H, n_tokens]."""
    B, H, D = q.shape
    h_kv = kc.scale.shape[0]
    if backend == "ref":
        idx = page_prefix_ids(pages.page_table, n_tokens, pages.page_size)
        return packed_qk_scores(q, gather_tiered_pages(kc, idx), sm_scale,
                                n_valid=n_valid, backend="ref")
    _check_backend(backend)
    BH = B * h_kv
    qf = _perm_q(q, kc, BH)
    nv = _rows_to_bh(n_valid, B, h_kv, q.device)
    si = torch.zeros((BH, H // h_kv, n_tokens), dtype=torch.float32,
                     device=q.device)
    for t, c in _tier_slices(kc):
        si = si + kpack_tier_scores_paged(
            t.payload, t.mins, t.shifts, qf[..., c], pages.page_table, nv,
            n_tokens, width=t.width, pack_size=t.pack_size,
            page_size=pages.page_size, tile_l=tile_l)
    meta = lambda a: gather_page_meta(a, pages.page_table, n_tokens,
                                      pages.page_size).reshape(BH, n_tokens)
    return _k_scores(si, qf, meta(kc.scale), meta(kc.zero), nv, sm_scale,
                     (B, H, n_tokens))


def packed_weighted_v_paged(w: torch.Tensor, vc: TieredCache, pages, *,
                            n_valid, backend: str = "fused",
                            tile_l: int = 256) -> torch.Tensor:
    """``packed_weighted_v`` over a PAGED V cache. w: [B, H, n_tokens] (a
    whole number of pages); the backends split as in
    ``packed_qk_scores_paged``."""
    B, H, n_tokens = w.shape
    h_kv = vc.scale.shape[0]
    if backend == "ref":
        idx = page_prefix_ids(pages.page_table, n_tokens, pages.page_size)
        return packed_weighted_v(w, gather_tiered_pages(vc, idx),
                                 n_valid=n_valid, backend="ref")
    _check_backend(backend)
    BH = B * h_kv
    nv = _rows_to_bh(n_valid, B, h_kv, w.device)
    meta = lambda a: gather_page_meta(a, pages.page_table, n_tokens,
                                      pages.page_size).reshape(BH, n_tokens)
    wf = w.to(torch.float32).reshape(BH, H // h_kv, n_tokens)
    ws = wf * meta(vc.scale)[:, None, :]
    parts = [vpack_tier_out_paged(t.payload, t.mins, t.shifts, ws,
                                  pages.page_table, nv, width=t.width,
                                  pack_size=t.pack_size,
                                  page_size=pages.page_size, tile_l=tile_l)
             for t in vc.tiers]
    return _v_out(parts, wf, meta(vc.zero), nv, vc.chan_perm, (B, H, -1))


def _residual_partials(q, resid_k, resid_v, n_resid, sm_scale):
    """LSE partials (o_unnorm, m, l) of attention over the residual buffer.
    n_resid: scalar or per-row [B]."""
    B, H, D = q.shape
    h_kv = resid_k.shape[1]
    R = resid_k.shape[2]
    qg = q.to(torch.float32).reshape(B, h_kv, H // h_kv, D)
    s = torch.einsum("bhgd,bhrd->bhgr", qg, resid_k.to(torch.float32)) * sm_scale
    mask = ref.valid_mask(n_resid, R, lead=3)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhgr,bhrd->bhgd", p, resid_v.to(torch.float32))
    return o.reshape(B, H, D), m.reshape(B, H), p.sum(-1).reshape(B, H)


def merge_partials(o1, m1, l1, o2, m2, l2):
    """Log-sum-exp merge of two unnormalized attention partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)[..., None]
    a2 = torch.exp(m2 - m)[..., None]
    denom = l1[..., None] * a1 + l2[..., None] * a2
    return (o1 * a1 + o2 * a2) / torch.clamp(denom, min=1e-30)


def packed_decode_attention(q, kc: TieredCache, vc: TieredCache, resid_k,
                            resid_v, n_comp, n_resid, sm_scale: float, *,
                            backend: str = "fused", tile_l: int = 256):
    """Full decode attention over [compressed | residual] regions.
    q: [B, H, D] -> f32 [B, H, D]."""
    if backend == "ref":
        return ref.packed_decode_attention_ref(
            q, kc, vc, resid_k, resid_v, n_comp, n_resid, sm_scale)
    _check_backend(backend)
    o_c, m_c, l_c = fused_packed_attention(q, kc, vc, n_comp, sm_scale,
                                           tile_l=tile_l)
    o_r, m_r, l_r = _residual_partials(q, resid_k, resid_v, n_resid, sm_scale)
    return merge_partials(o_c, m_c, l_c, o_r, m_r, l_r)


def paged_decode_attention(q, cache, sm_scale: float, *,
                           n_bucket: int | None = None, backend: str = "fused",
                           tile_l: int = 256):
    """Full decode attention over a PAGED compressed cache + residual.

    cache: a paged ``core.cache.LayerKVCache`` (compressed policy). The
    ``ref`` backend gathers the first ``n_bucket`` tokens' pages into the
    dense layout and runs the oracle; ``fused`` launches K5 on the pool."""
    if backend == "ref":
        n_tokens = cache.capacity if n_bucket is None else min(n_bucket, cache.capacity)
        read = gather_paged(cache, n_tokens)
        return ref.packed_decode_attention_ref(
            q, read.k, read.v, read.resid_k, read.resid_v, read.n_comp,
            read.n_resid, sm_scale)
    _check_backend(backend)
    o_c, m_c, l_c = compressed_partials(q, cache, sm_scale, n_bucket=n_bucket,
                                        tile_l=tile_l)
    o_r, m_r, l_r = _residual_partials(q, cache.resid_k, cache.resid_v,
                                       cache.n_resid, sm_scale)
    return merge_partials(o_c, m_c, l_c, o_r, m_r, l_r)


def compressed_partials(q, cache, sm_scale: float, *, n_bucket: int | None = None,
                        tile_l: int = 256):
    """The compressed region's attention partials (o_unnorm, m, l) of one
    layer's cache (compressed policy) in ONE kernel launch: K5 on a paged
    pool (``n_bucket`` tokens of it), K2 on a dense cache's
    ``n_bucket``-token prefix view."""
    if cache.pages is None:
        read = slice_compressed(cache, n_bucket)
        return fused_packed_attention(q, read.k, read.v, read.n_comp, sm_scale,
                                      tile_l=tile_l)
    n_tokens = cache.capacity if n_bucket is None else min(n_bucket, cache.capacity)
    return fused_packed_attention_paged(
        q, cache.k, cache.v, cache.pages.page_table, cache.n_comp, n_tokens,
        sm_scale, page_size=cache.pages.page_size, tile_l=tile_l)


dense_decode_attention = ref.dense_decode_attention_ref
