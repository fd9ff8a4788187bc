"""Decode-attention entry points over the compressed cache, with backends.

The torch port of ``repro/kernels/ops.py`` (dense and paged storage).
Backends:

  * ``"ref"``   - the plain oracle math of ``kernels/ref.py`` (the
    reference's ``"xla"`` backend);
  * ``"fused"`` - the single-launch fused kernel (the reference's
    ``"pallas"`` backend): ``fused_packed_attention`` (K2; paged:
    ``fused_packed_attention_paged``, K5) for the compressed region,
    merged with the residual buffer's partials by log-sum-exp.

``packed_qk_scores`` / ``packed_weighted_v`` (the standalone Fig. 8 /
Fig. 11 kernels) arrive with their kernels.
"""
from __future__ import annotations

import torch

from ..core.cache import gather_paged
from ..core.tiered import TieredCache
from . import ref
from .packed_attention import fused_packed_attention, fused_packed_attention_paged

NEG_INF = ref.NEG_INF
BACKENDS = ("ref", "fused")


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
    if backend != "fused":
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
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
    n_tokens = cache.capacity if n_bucket is None else min(n_bucket, cache.capacity)
    if backend == "ref":
        read = gather_paged(cache, n_tokens)
        return ref.packed_decode_attention_ref(
            q, read.k, read.v, read.resid_k, read.resid_v, read.n_comp,
            read.n_resid, sm_scale)
    if backend != "fused":
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    o_c, m_c, l_c = fused_packed_attention_paged(
        q, cache.k, cache.v, cache.pages.page_table, cache.n_comp, n_tokens,
        sm_scale, page_size=cache.pages.page_size, tile_l=tile_l)
    o_r, m_r, l_r = _residual_partials(q, cache.resid_k, cache.resid_v,
                                       cache.n_resid, sm_scale)
    return merge_partials(o_c, m_c, l_c, o_r, m_r, l_r)


dense_decode_attention = ref.dense_decode_attention_ref
