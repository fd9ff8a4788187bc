"""Shared neural-net layers (functional, dict params, bf16 compute).

The torch port of ``repro/models/layers.py``: compute in bf16 with
normalization, RoPE and attention in f32, and the reference's rounding
points kept (rmsnorm multiplies by ``w`` in bf16 after the cast; swiglu
applies silu in f32, casts to bf16, then multiplies by ``u``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


PREFILL_ROWS = 256  # positions a slab of the recurrent families' prefill products


def mm_slabs(x: torch.Tensor, w: torch.Tensor, rows: int | None) -> torch.Tensor:
    """x [B, T, K] @ w [K, N] in slabs of ``rows`` positions, the last
    zero-padded to ``rows`` (None: one product). Rows of a product are
    independent, so this changes no value; on the GPU a product's rows
    sum in another order at another row count, and slabs give a
    monolithic prefill and the chunks of a chunked one the same shapes."""
    T = x.shape[1]
    if rows is None or T == rows:
        return x @ w
    Tp = -(-T // rows) * rows
    xp = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
    return torch.cat([xp[:, s:s + rows] @ w for s in range(0, Tp, rows)], 1)[:, :T]


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u) @ w_down


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 1e4, device="cuda") -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [..., S, Dh]; positions: [S] or broadcastable to x[..., S]."""
    Dh = x.shape[-1]
    freqs = rope_freqs(Dh, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# flash attention (prefill): the reference's double-chunked tiling
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Memory-bounded attention with GQA broadcast, tiled exactly as the
    reference (q and kv chunks of min(1024, S), online softmax over kv
    chunks in order), so a later chunked prefill can resume it.

    q: [B, Hq, S, Dh]; k, v: [B, Hkv, S, Dh] -> [B, Hq, S, Dh]. Raises
    unless S is a multiple of min(1024, S). A kv chunk wholly above a q
    chunk's causal diagonal is skipped: in the reference it is an exact
    no-op of the recurrence (alpha = 1, p = 0).
    """
    B, Hq, S, Dh = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    qc, kc = min(q_chunk, S), min(kv_chunk, S)
    if S % qc or S % kc:
        raise ValueError(f"sequence length {S} must be a multiple of "
                         f"{min(qc, kc)} (the attention chunk)")
    qg = q.reshape(B, Hkv, G, S, Dh).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for q0 in range(0, S, qc):
        qi = qg[..., q0:q0 + qc, :]
        qpos = torch.arange(q0, q0 + qc, device=q.device)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((B, Hkv, G, qc, Dh), dtype=torch.float32, device=q.device)
        for k0 in range(0, S, kc):
            if causal and k0 > q0 + qc - 1:
                continue
            kpos = torch.arange(k0, k0 + kc, device=q.device)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kf[:, :, k0:k0 + kc]) * scale
            mask = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_n = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_n)
            p = torch.where(mask, torch.exp(s - m_n[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vf[:, :, k0:k0 + kc])
            m = m_n
        outs.append((o / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(B, Hq, S, Dh)


def resume_attention(q, k_all, v_all, n_ctx: int, *, causal: bool = True,
                     window: int = 0, kv_chunk: int = 1024,
                     sm_scale: float | None = None) -> torch.Tensor:
    """Chunk-resumable flash attention: queries at absolute positions
    ``n_ctx + arange(Sc)`` over a key scratch of which only the first
    ``n_ctx + Sc`` keys are written (later ones are masked causally, as a
    not-yet-reached key is in the monolithic pass).

    q: [B, Hq, Sc, Dh]; k_all, v_all: [B, Hkv, T, Dh] -> [B, Hq, Sc, Dh].
    Mirrors ``flash_attention``'s kv loop op for op (kv tiles of
    ``min(kv_chunk, T)``, the same einsums, masking and merge order, the
    same skip of tiles wholly above the causal diagonal), so with the
    monolithic pass's kv tiling each query row's output depends on the
    same keys in the same order as there.
    """
    B, Hq, Sc, Dh = q.shape
    Hkv, T = k_all.shape[1], k_all.shape[2]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    kc = min(kv_chunk, T)
    if T % kc:
        raise ValueError(f"key length {T} must be a multiple of {kc}")
    qg = q.reshape(B, Hkv, G, Sc, Dh).to(torch.float32)
    kf, vf = k_all.to(torch.float32), v_all.to(torch.float32)
    qpos = n_ctx + torch.arange(Sc, device=q.device)
    m = torch.full((B, Hkv, G, Sc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((B, Hkv, G, Sc, Dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, T, kc):
        if causal and k0 > n_ctx + Sc - 1:
            continue
        kpos = torch.arange(k0, k0 + kc, device=q.device)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf[:, :, k0:k0 + kc]) * scale
        mask = torch.ones((Sc, kc), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(mask, s, NEG_INF)
        m_n = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_n)
        p = torch.where(mask, torch.exp(s - m_n[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vf[:, :, k0:k0 + kc])
        m = m_n
    out = (o / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
    return out.reshape(B, Hq, Sc, Dh)


def ctx_attention(q, k_all, v_all, n_ctx: int, sm_scale: float) -> torch.Tensor:
    """Segment attention of a prefix-cache admission: queries over
    [context | self].

    q: [B, Hq, S, Dh]; k_all, v_all: [B, Hkv, n_ctx + S, Dh] whose first
    ``n_ctx`` keys are read-only context (in every query's past) and the
    last S the segment's own (causal). One f32 softmax, as the reference:
    a segment is at most one page of queries."""
    B, Hq, S, Dh = q.shape
    Hkv, T = k_all.shape[1], k_all.shape[2]
    qg = q.to(torch.float32).reshape(B, Hkv, Hq // Hkv, S, Dh)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k_all.to(torch.float32)) * sm_scale
    mask = (torch.arange(T, device=q.device)[None, :]
            <= (n_ctx + torch.arange(S, device=q.device))[:, None])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v_all.to(torch.float32))
    out = out / torch.clamp(p.sum(-1)[..., None], min=1e-30)
    return out.reshape(B, Hq, S, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# attention / MLP blocks
# ---------------------------------------------------------------------------


def attention_norm_init(head_dim: int, device="cuda") -> dict:
    """qk-norm weights (``q_norm`` / ``k_norm``): ones over the head dim,
    bf16, as the reference's ``attention_init`` makes them."""
    one = lambda: torch.ones((head_dim,), dtype=torch.bfloat16, device=device)
    return {"q_norm": one(), "k_norm": one()}


def qkv_proj(p: dict, x, n_heads: int, n_kv: int, head_dim: int, positions,
             rope_theta: float = 1e4, qk_norm: bool = False,
             use_rope: bool = True):
    """x: [B, S, D] -> q [B,H,S,Dh], k/v [B,Hkv,S,Dh] (k rotated).
    ``qk_norm``: q and k are rms-normalized over the head dim (weights
    ``p["q_norm"]``, ``p["k_norm"]``) after the projection, before RoPE."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, n_kv, head_dim).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, n_kv, head_dim).transpose(1, 2)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def mlp_apply(p: dict, x) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy. logits [..., V] (upcast to f32), labels [...] int."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - gold)
