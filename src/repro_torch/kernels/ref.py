"""Pure-torch oracles for the compressed-cache attention kernels.

The torch port of ``repro/kernels/ref.py``: the math the kernels must
reproduce, over the dense tiered layout. Token-wise dequantization is
never materialized; with K_deq[l, c] = q_int[l, c] * scale[l] + zero[l],

  scores[l] = scale[l] * (q . q_int[:, l]) + zero[l] * sum_c(q[c])
  out[c]    = sum_l (w[l] * scale[l]) * q_int[c, l]  +  sum_l w[l] * zero[l]
"""
from __future__ import annotations

import torch

from ..core.tiered import TieredCache, chan_inverse_perm, unpack_tier

NEG_INF = -1e30


def valid_mask(n, length: int, lead: int) -> torch.Tensor:
    """``arange(length) < n`` with ``lead`` broadcast axes before the length.

    ``n`` is a scalar (-> [1]*lead + [length]) or a per-row [B] tensor
    (-> [B] + [1]*(lead-1) + [length]).
    """
    n = torch.as_tensor(n)
    ar = torch.arange(length, device=n.device)
    if n.dim() == 0:
        return (ar < n).reshape((1,) * lead + (length,))
    return ar.reshape((1,) * lead + (length,)) < n.reshape((-1,) + (1,) * lead)


def _grouped_q(q: torch.Tensor, h_kv: int) -> torch.Tensor:
    """[B, H, D] -> [B, H_kv, G, D] (GQA grouping)."""
    B, H, D = q.shape
    return q.reshape(B, h_kv, H // h_kv, D)


def _perm_q(qg: torch.Tensor, chan_perm: torch.Tensor) -> torch.Tensor:
    """Absorb K's channel permutation into q: qp[..., i] = q[..., perm[i]]."""
    idx = chan_perm.to(torch.int64)[:, :, None, :].expand_as(qg)
    return torch.gather(qg, -1, idx)


def _unpermute(out: torch.Tensor, chan_perm: torch.Tensor) -> torch.Tensor:
    """Tier channel order -> original order over the last axis of
    out [B, H_kv, G, D]."""
    inv = chan_inverse_perm(chan_perm).to(torch.int64)
    return torch.gather(out, -1, inv[:, :, None, :].expand_as(out))


def _ints(tier, L: int) -> torch.Tensor:
    """A tier's decoded integers as contiguous f32 [B, Hkv, C_t, L]. Decoding
    a strided prefix view (a dense bucket) can leave its result strided,
    and the products below would then sum in another order than over a
    gathered copy (paged); contiguous operands make the sums depend on the
    shapes only."""
    return unpack_tier(tier, L).to(torch.float32).contiguous()


def kpack_scores_ref(q: torch.Tensor, kc: TieredCache, sm_scale: float = 1.0
                     ) -> torch.Tensor:
    """Fused K decompress + q.K^T. q: f32 [B, H, D] in ORIGINAL channel
    order -> scores f32 [B, H, L] (no masking)."""
    B, H, D = q.shape
    h_kv = kc.scale.shape[-2]
    L = kc.capacity
    qg = _grouped_q(q.to(torch.float32), h_kv)
    qp = _perm_q(qg, kc.chan_perm)
    si = torch.zeros((B, h_kv, qg.shape[2], L), dtype=torch.float32,
                     device=q.device)
    off = 0
    for t, c in zip(kc.tiers, kc.spec.counts):
        qint = _ints(t, L)  # [B, Hkv, C_t, L]
        si = si + torch.einsum("bhgc,bhcl->bhgl", qp[..., off:off + c], qint)
        off += c
    qsum = torch.sum(qg, dim=-1, keepdim=True)
    scores = si * kc.scale[:, :, None, :] + qsum * kc.zero[:, :, None, :]
    return (scores * sm_scale).reshape(B, H, L)


def vpack_out_ref(w: torch.Tensor, vc: TieredCache) -> torch.Tensor:
    """Fused w.V decompress + matvec. w: f32 [B, H, L] attention weights
    (softmaxed and masked) -> out f32 [B, H, D] in ORIGINAL channel order."""
    B, H, L = w.shape
    h_kv = vc.scale.shape[-2]
    wg = w.to(torch.float32).reshape(B, h_kv, H // h_kv, L)
    ws = wg * vc.scale[:, :, None, :]
    parts = [torch.einsum("bhgl,bhcl->bhgc", ws, _ints(t, L)) for t in vc.tiers]
    out = torch.cat(parts, dim=-1)
    out = out + torch.einsum("bhgl,bhl->bhg", wg, vc.zero)[..., None]
    return _unpermute(out, vc.chan_perm).reshape(B, H, -1)


def packed_decode_attention_ref(q, kc: TieredCache, vc: TieredCache, resid_k,
                                resid_v, n_comp, n_resid, sm_scale: float
                                ) -> torch.Tensor:
    """Full decode attention: softmax over [compressed | residual].

    q: [B, H, D]; resid_k/v: [B, H_kv, R, D]; n_comp/n_resid: scalar or
    per-row [B]. Returns the attention output f32 [B, H, D].
    """
    B, H, D = q.shape
    h_kv = resid_k.shape[1]
    L = kc.capacity
    R = resid_k.shape[2]
    s_comp = kpack_scores_ref(q, kc, sm_scale)
    mask_c = valid_mask(n_comp, L, lead=2)
    s_comp = torch.where(mask_c, s_comp, NEG_INF)
    qg = _grouped_q(q.to(torch.float32), h_kv)
    s_res = torch.einsum("bhgd,bhrd->bhgr", qg, resid_k.to(torch.float32)
                         ).reshape(B, H, R) * sm_scale
    mask_r = valid_mask(n_resid, R, lead=2)
    s_res = torch.where(mask_r, s_res, NEG_INF)
    m = torch.maximum(s_comp.amax(-1, keepdim=True), s_res.amax(-1, keepdim=True))
    w_comp = torch.where(mask_c, torch.exp(s_comp - m), 0.0)
    w_res = torch.where(mask_r, torch.exp(s_res - m), 0.0)
    denom = w_comp.sum(-1, keepdim=True) + w_res.sum(-1, keepdim=True)
    o_comp = vpack_out_ref(w_comp, vc)
    wg = w_res.reshape(B, h_kv, H // h_kv, R)
    o_res = torch.einsum("bhgr,bhrd->bhgd", wg, resid_v.to(torch.float32)
                         ).reshape(B, H, D)
    return (o_comp + o_res) / torch.clamp(denom, min=1e-30)


def dense_decode_attention_ref(q, raw_k, raw_v, resid_k, resid_v, n_comp,
                               n_resid, sm_scale: float) -> torch.Tensor:
    """Uncompressed-cache decode attention (the baseline policy 'none').
    raw_k/v: [B, H_kv, L, D] bf16; n_comp/n_resid: scalar or per-row [B]."""
    B, H, D = q.shape
    h_kv = raw_k.shape[1]
    L, R = raw_k.shape[2], resid_k.shape[2]
    qg = _grouped_q(q.to(torch.float32), h_kv)
    s_c = torch.einsum("bhgd,bhld->bhgl", qg, raw_k.to(torch.float32)) * sm_scale
    s_r = torch.einsum("bhgd,bhrd->bhgr", qg, resid_k.to(torch.float32)) * sm_scale
    mask_c = valid_mask(n_comp, L, lead=3)
    mask_r = valid_mask(n_resid, R, lead=3)
    s_c = torch.where(mask_c, s_c, NEG_INF)
    s_r = torch.where(mask_r, s_r, NEG_INF)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_r.amax(-1, keepdim=True))
    w_c = torch.where(mask_c, torch.exp(s_c - m), 0.0)
    w_r = torch.where(mask_r, torch.exp(s_r - m), 0.0)
    denom = w_c.sum(-1, keepdim=True) + w_r.sum(-1, keepdim=True)
    o = torch.einsum("bhgl,bhld->bhgd", w_c, raw_v.to(torch.float32)) + \
        torch.einsum("bhgr,bhrd->bhgd", w_r, resid_v.to(torch.float32))
    return (o / torch.clamp(denom, min=1e-30)).reshape(B, H, D)
