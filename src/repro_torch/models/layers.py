"""Shared neural-net layers (functional, dict params, bf16 compute).

The torch port of ``repro/models/layers.py``: compute in bf16 with
normalization, RoPE and attention in f32, and the reference's rounding
points kept (rmsnorm multiplies by ``w`` in bf16 after the cast; swiglu
applies silu in f32, casts to bf16, then multiplies by ``u``).

Tensor parallelism (a ``distributed.exchange.ModelGroup`` ``tp``; None:
one device, the unchanged single-device math). A rank holds its block of
each leaf (``distributed.sharding.storage_specs``) and reaches a leaf only
through ``part`` (the rows or columns its own work needs: its stored
block, or the leaf gathered first where the block does not line up, as
where a slice cuts inside a head) or ``shared`` (a replicated leaf that
the split work uses). Work runs in column-parallel then row-parallel
pairs: the input enters whole (``enter``: the sequence-sharded stream
all-gathered, or a replicated stream whose gradient is summed), each rank
computes its heads / its F slice / its vocab slice, and the row-parallel
product's partial sums go back onto the stream (``leave``: reduce-scatter
by sequence, or a rank-order sum). A rank's gradients are then its
leaves' gradients, whole for a replicated leaf (summed by ``shared``) and
its slice for a sharded one.
"""
from __future__ import annotations

import math

import torch

from ..distributed.exchange import (
    ModelGroup,
    copy_to,
    gather_along,
    reduce_from,
    scatter_along,
    split_along,
)

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


def swiglu(x, w_gate, w_up, w_down, tp: ModelGroup | None = None,
           F: int = 0) -> torch.Tensor:
    """SwiGLU; under ``tp`` over this rank's slice of the ``F`` hidden
    units (column-parallel gate and up, row-parallel down): this rank's
    f32 partial sum of the output (``leave`` adds the ranks')."""
    if tp is not None:
        lo, hi = tp.range(F)
        w_gate, w_up = part(w_gate, -1, F, lo, hi, tp), part(w_up, -1, F, lo, hi, tp)
        w_down = part(w_down, -2, F, lo, hi, tp)
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return h @ w_down if tp is None else partial_mm(h, w_down)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def part(w: torch.Tensor, dim: int, full: int, lo: int, hi: int,
         tp: ModelGroup) -> torch.Tensor:
    """Items [lo, hi) along ``dim`` of the leaf (``full`` items long)
    whose this-rank storage is ``w``: the stored block itself when it is
    exactly that range; else the block gathered whole first (all-gather
    forward, reduce-scatter backward), or for a replicated leaf the leaf
    with its gradient summed over the ranks (each rank's work gives it a
    part). The math never changes: only where the weights come from."""
    n = w.shape[dim]
    if n != full:  # this rank's block of a sharded leaf
        if (lo, hi) == (tp.index * n, (tp.index + 1) * n):
            return w
        w = gather_along(w, dim, tp)
    else:
        w = copy_to(w, tp)
    return w.narrow(dim, lo, hi - lo)


def shared(w: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """A replicated leaf used by work the ranks split (the stream's norms
    under sequence sharding, a router, qk-norm gains): its gradient is
    the rank-order sum of the ranks' parts."""
    return w if tp is None else copy_to(w, tp)


def stream_param(w: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """A replicated leaf applied token by token to the residual stream:
    ``shared`` when the stream is sequence-sharded, else as it is (every
    rank computes the same whole stream, with the whole gradient)."""
    return shared(w, tp) if tp is not None and tp.seq else w


def enter(x: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """The stream [B, S_local, D] -> the whole sequence [B, S, D] that a
    column-parallel product reads: all-gathered when sequence-sharded,
    else the replicated stream whose gradient is summed."""
    if tp is None:
        return x
    return gather_along(x, 1, tp) if tp.seq else copy_to(x, tp)


def leave(y: torch.Tensor, tp: ModelGroup | None, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel product's partial sums [B, S, D] (f32: a partial is
    not rounded before the ranks' sum) -> the stream: reduce-scattered by
    sequence, or summed whole, in rank order, and rounded once to
    ``dtype`` (the stream's)."""
    if tp is None:
        return y
    return (scatter_along(y, 1, tp) if tp.seq else reduce_from(y, tp)).to(dtype)


def to_stream(x: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """A replicated [B, S, D] (every rank's the same) -> the stream."""
    return split_along(x, 1, tp) if tp is not None and tp.seq else x


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, vocab: int,
                 tp: ModelGroup | None) -> torch.Tensor:
    """Token embeddings [B, S, D]. Under ``tp`` vocab-parallel: each rank
    looks up the tokens of its vocab rows and zeros the rest, and the
    ranks' results are summed (one nonzero term a token: exact); returns
    this rank's partial sum (``leave`` adds them)."""
    ids = tokens.to(torch.int64)
    if tp is None:
        return embed[ids]
    lo, hi = tp.range(vocab)
    rows = part(embed, 0, vocab, lo, hi, tp)
    local = ids - lo
    valid = (local >= 0) & (local < hi - lo)
    e = rows[torch.clamp(local, 0, hi - lo - 1)]
    return torch.where(valid[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))


def head_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [..., D] @ w [D, V] in h's dtype. On the CPU the backward's
    product with w transposed reads a contiguous copy: torch's CPU oneDNN
    bf16 GEMM faults (SIGFPE) on the transposed operand at some shapes
    (32 rows by a vocab of 49152, smollm-135m's). On the card the product
    is the plain one."""
    if h.is_cuda:
        return h @ w
    return _CpuHead.apply(h, w)


class _CpuHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return h @ w

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gh = g @ w.t().contiguous() if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = h.reshape(-1, h.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return gh, gw


def logits_tp(h: torch.Tensor, w: torch.Tensor, vocab: int,
              tp: ModelGroup | None) -> torch.Tensor:
    """Every position's f32 logits of the normalized stream ``h``: [B, S,
    V], or under ``tp`` this rank's vocab slice [B, S, V_r]
    (column-parallel over the vocab, ``ModelGroup.range``)."""
    if tp is None:
        return head_logits(h, w).to(torch.float32)
    lo, hi = tp.range(vocab)
    return head_logits(enter(h, tp), part(w, -1, vocab, lo, hi, tp)).to(torch.float32)


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


def head_block(n_heads: int, n_kv: int, tp: ModelGroup) -> tuple[int, int, int, int]:
    """(qlo, qhi, klo, khi): the query heads and the KV heads this rank
    attends over. A rank takes 1/m of the query heads when they split
    into whole KV groups (n_kv divides over the ranks) or lie inside one
    KV group; otherwise (e.g. smollm-135m's 9 heads over 2 ranks) every
    rank computes every head, and the split comes at the row-parallel
    output product."""
    m = tp.size
    if n_heads % m == 0:
        qn, G = n_heads // m, n_heads // n_kv
        qlo = tp.index * qn
        if n_kv % m == 0:
            kn = n_kv // m
            return qlo, qlo + qn, tp.index * kn, (tp.index + 1) * kn
        if G % qn == 0:
            return qlo, qlo + qn, qlo // G, qlo // G + 1
    return 0, n_heads, 0, n_kv


def qkv_proj(p: dict, x, n_heads: int, n_kv: int, head_dim: int, positions,
             rope_theta: float = 1e4, qk_norm: bool = False,
             use_rope: bool = True, tp: ModelGroup | None = None):
    """x: [B, S, D] -> q [B,H,S,Dh], k/v [B,Hkv,S,Dh] (k rotated).
    ``qk_norm``: q and k are rms-normalized over the head dim (weights
    ``p["q_norm"]``, ``p["k_norm"]``) after the projection, before RoPE.
    Under ``tp`` column-parallel: the heads of ``head_block`` only."""
    B, S, _ = x.shape
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    if tp is not None:
        qlo, qhi, klo, khi = head_block(n_heads, n_kv, tp)
        hd = head_dim
        wq = part(wq, -1, n_heads * hd, qlo * hd, qhi * hd, tp)
        wk = part(wk, -1, n_kv * hd, klo * hd, khi * hd, tp)
        wv = part(wv, -1, n_kv * hd, klo * hd, khi * hd, tp)
        n_heads, n_kv = qhi - qlo, khi - klo
    q = (x @ wq).reshape(B, S, n_heads, head_dim).transpose(1, 2)
    k = (x @ wk).reshape(B, S, n_kv, head_dim).transpose(1, 2)
    v = (x @ wv).reshape(B, S, n_kv, head_dim).transpose(1, 2)
    if qk_norm:
        q = rmsnorm(q, shared(p["q_norm"], tp))
        k = rmsnorm(k, shared(p["k_norm"], tp))
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def row_parallel(y: torch.Tensor, y_lo: int, w: torch.Tensor, full: int,
                 tp: ModelGroup | None) -> torch.Tensor:
    """``y @ w`` for a leaf ``w`` of ``full`` input rows, where ``y`` holds
    the input's features [y_lo, y_lo + y.shape[-1]); under ``tp`` this
    rank's rows ``ModelGroup.range(full)`` only: the partial sum (f32,
    ``partial_mm``)."""
    if tp is None:
        return y @ w
    lo, hi = tp.range(full)
    return partial_mm(y[..., lo - y_lo:hi - y_lo], part(w, -2, full, lo, hi, tp))


def partial_mm(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum in f32: the bf16 values'
    products are exact in f32 and accumulate there, as the single-device
    GEMM accumulates, and the sum over the ranks rounds once."""
    return y.to(torch.float32) @ w.to(torch.float32)


def mlp_apply(p: dict, x, tp: ModelGroup | None = None, F: int = 0) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], tp, F)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 tp: ModelGroup | None = None, vocab: int = 0) -> torch.Tensor:
    """Mean cross-entropy. logits [..., V] (upcast to f32), labels [...] int.

    Under ``tp`` the logits are this rank's vocab slice (``logits_tp``) of
    a ``vocab`` of V: the max is taken over every rank's maxima, the sum of
    exponentials and the gold logit (each on one rank, zero elsewhere) are
    added over the ranks in rank order, so every rank gets the same loss;
    no rank holds all the logits."""
    lf = logits.to(torch.float32)
    if tp is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
        return torch.mean(lse - gold)
    from ..distributed.exchange import all_gather

    lo, hi = tp.range(vocab)
    m = torch.stack(all_gather(lf.detach().amax(-1), tp.group, tp.size)).amax(0)
    se = reduce_from(torch.sum(torch.exp(lf - m[..., None]), dim=-1), tp)
    lse = torch.log(se) + m
    local = labels.to(torch.int64) - lo
    valid = (local >= 0) & (local < hi - lo)
    g = torch.gather(lf, -1, torch.clamp(local, 0, hi - lo - 1)[..., None])[..., 0]
    gold = reduce_from(torch.where(valid, g, torch.zeros((), device=g.device)), tp)
    return torch.mean(lse - gold)
