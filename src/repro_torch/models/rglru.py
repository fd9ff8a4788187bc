"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU blocks and local
attention, 2:1.

The torch port of ``repro/models/rglru.py``: the training forward
(``forward_train``) and the serving path. Layers come in groups of
(recurrent, recurrent, attention), each sub-layer followed by an MLP; 38
layers are 12 groups and 2 trailing recurrent blocks. The local-attention layers keep a PackKV-compressed sliding-window
cache of ``window`` tokens (``core.cache.append_token(ring=True)``: valid
because decode attention does not depend on the order of its tokens) and
decode through K2 (``kernels.ops.packed_decode_attention``); the RG-LRU
layers carry O(1) state.

Recurrent block: x -> [linear -> causal depthwise conv(4) -> RG-LRU] *
gelu(linear) -> linear. RG-LRU: a_t = exp(-8 softplus(lambda) r_t),
h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t), a sequential scan.

Parameters are a dict with the reference's layout: ``groups`` (its
``rec`` leaves stacked [n_groups, 2, ...], its ``attn`` leaves
[n_groups, ...]), ``tail`` ([n_tail, ...], or None), ``embed``,
``final_ln``, ``head``. The state (``RGState``) is updated IN PLACE and
returned. Prefill runs its matrix products over slabs of
``PREFILL_ROWS`` positions (``layers.mm_slabs``), as ``models/rwkv6.py``
does and for the same reason, and its attention a slab of queries at a time through
``layers.resume_attention`` (flash attention's tiles, per query row), as
a chunk of chunked admission does: on the card a product of 256 query
rows over 256 channels sums in another order than one of 1024, so the
monolithic pass takes the chunks' shapes.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.cache import (
    LayerKVCache,
    PackKVConfig,
    alloc_layer_cache,
    append_token,
    flush_rows,
    insert_row,
    mask_free_slots,
    prefill_cache,
    reset_slot,
)
from ..kernels import dense_decode_attention, packed_decode_attention
from ..utils import round_up, tree_unbind
from .layers import (
    PREFILL_ROWS,
    apply_rope,
    dense_init,
    flash_attention,
    mlp_apply,
    qkv_proj,
    resume_attention,
    rmsnorm,
)
from .layers import mm_slabs as _mm

CONV_W = 4
LRU_C = 8.0


@dataclasses.dataclass
class RGState:
    """Decode state. Grouped leaves lead with [n_groups, ...]."""

    lru_h: torch.Tensor  # f32 [n_groups, 2, B, R]
    conv: torch.Tensor  # bf16 [n_groups, 2, B, CONV_W - 1, R]
    cache: list[LayerKVCache]  # one window cache a group (capacity = window)
    tail_lru_h: torch.Tensor  # f32 [n_tail, B, R]
    tail_conv: torch.Tensor  # bf16 [n_tail, B, CONV_W - 1, R]
    pos: torch.Tensor  # int32 [B] tokens each row has consumed


def _shape(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_groups, n_tail, lru width)."""
    n_groups, n_tail = divmod(cfg.n_layers, 3)
    return n_groups, n_tail, cfg.lru_dim or cfg.d_model


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _rec_block_init(gen, cfg: ArchConfig) -> dict:
    dev = gen.device
    D, F = cfg.d_model, cfg.d_ff
    R = cfg.lru_dim or D
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "ln": torch.ones((D,), dtype=bf16, device=dev),
        "w_in": dense_init(gen, D, R, device=dev),
        "w_gate_branch": dense_init(gen, D, R, device=dev),
        "conv_w": (torch.randn((CONV_W, R), generator=gen, device=dev) * 0.1).to(bf16),
        "lru_wa": dense_init(gen, R, R, f32, dev),
        "lru_wx": dense_init(gen, R, R, f32, dev),
        "lru_lambda": torch.rand((R,), generator=gen, device=dev) * 0.5 + 0.4,
        "w_out": dense_init(gen, R, D, device=dev),
        "mlp_ln": torch.ones((D,), dtype=bf16, device=dev),
        "mlp": _mlp_init(gen, D, F),
    }


def _mlp_init(gen, D: int, F: int) -> dict:
    dev = gen.device
    return {"w_gate": dense_init(gen, D, F, device=dev),
            "w_up": dense_init(gen, D, F, device=dev),
            "w_down": dense_init(gen, F, D, device=dev)}


def _attn_block_init(gen, cfg: ArchConfig) -> dict:
    dev = gen.device
    D, hd = cfg.d_model, cfg.hd
    ones = lambda: torch.ones((D,), dtype=torch.bfloat16, device=dev)
    return {
        "ln": ones(),
        "attn": {"wq": dense_init(gen, D, cfg.n_heads * hd, device=dev),
                 "wk": dense_init(gen, D, cfg.n_kv_heads * hd, device=dev),
                 "wv": dense_init(gen, D, cfg.n_kv_heads * hd, device=dev),
                 "wo": dense_init(gen, cfg.n_heads * hd, D, device=dev)},
        "mlp_ln": ones(),
        "mlp": _mlp_init(gen, D, cfg.d_ff),
    }


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights from ``gen``, on ``gen``'s device, with the
    reference's layout, dtypes and scales (the draws differ)."""
    dev = gen.device
    n_groups, n_tail, _ = _shape(cfg)
    groups = [{"rec": _stack([_rec_block_init(gen, cfg) for _ in range(2)]),
               "attn": _attn_block_init(gen, cfg)} for _ in range(n_groups)]
    tail = [_rec_block_init(gen, cfg) for _ in range(n_tail)]
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev) * 0.02
    return {"groups": _stack(groups), "tail": _stack(tail) if tail else None,
            "embed": embed.to(torch.bfloat16),
            "final_ln": torch.ones((cfg.d_model,), dtype=torch.bfloat16, device=dev),
            "head": dense_init(gen, cfg.d_model, cfg.vocab, device=dev)}


def _index(tree: dict, *idx) -> dict:
    return {k: _index(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# blocks over a sequence
# ---------------------------------------------------------------------------


def _mlp(p: dict, x, rows):
    """SwiGLU over [B, T, D] in slabs of ``rows`` positions."""
    g = _mm(x, p["w_gate"], rows)
    u = _mm(x, p["w_up"], rows)
    return _mm(torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u,
               p["w_down"], rows)


def _causal_conv_seq(w, x, x_hist):
    """Depthwise causal conv by shifted adds. x: [B, T, R]; x_hist:
    [B, CONV_W - 1, R]. Returns (y, the new history)."""
    xp = torch.cat([x_hist, x], dim=1)  # [B, T + 3, R]
    T = x.shape[1]
    y = w[0] * xp[:, 0:T]
    for i in range(1, CONV_W):
        y = y + w[i] * xp[:, i:i + T]
    return y, xp[:, -(CONV_W - 1):]


def _rg_lru_seq(p: dict, x, h0, rows):
    """The gated LRU over x [B, T, R], a sequential scan. Returns
    (y f32 [B, T, R], h_final [B, R])."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(_mm(xf, p["lru_wa"], rows))
    i = torch.sigmoid(_mm(xf, p["lru_wx"], rows))
    a = torch.exp(-LRU_C * torch.nn.functional.softplus(p["lru_lambda"]) * r)
    gx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    ys, h = [], h0
    for t in range(x.shape[1]):
        h = a[:, t] * h + gx[:, t]
        ys.append(h)
    # stacked, not written into a buffer a token at a time: under autograd
    # each such write's backward copies the whole buffer's gradient
    return torch.stack(ys, dim=1), h


def _rec_block_seq(p: dict, h, conv_hist, h0, rows):
    """A whole recurrent residual block over a sequence. Returns (h, the
    conv history, the LRU state)."""
    x = rmsnorm(h, p["ln"])
    y1 = _mm(x, p["w_in"], rows)
    y2 = torch.nn.functional.gelu(_mm(x, p["w_gate_branch"], rows).to(torch.float32),
                                  approximate="tanh").to(h.dtype)
    y1, hist = _causal_conv_seq(p["conv_w"], y1, conv_hist)
    y1, h_fin = _rg_lru_seq(p, y1, h0, rows)
    h = h + _mm(y1.to(h.dtype) * y2, p["w_out"], rows)
    h = h + _mlp(p["mlp"], rmsnorm(h, p["mlp_ln"]), rows)
    return h, hist, h_fin


def _qkv_seq(p: dict, x, cfg: ArchConfig, positions, rows):
    """q [B, H, T, hd], k / v [B, H_kv, T, hd] of x [B, T, D] (RoPE on q, k)."""
    B, T, _ = x.shape
    hd = cfg.hd
    q = _mm(x, p["wq"], rows).reshape(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = _mm(x, p["wk"], rows).reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    v = _mm(x, p["wv"], rows).reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _span_keys(n_ctx: int, Sc: int, S: int) -> int:
    """Keys the queries [n_ctx, n_ctx + Sc) of an S-token prompt attend
    over: their end rounded up to the monolithic pass's kv tile
    (``min(1024, S)``), so every query row sees flash attention's tiling."""
    return min(S, round_up(n_ctx + Sc, min(1024, S)))


def _prefill_attention(q, k, v, window: int):
    """Causal windowed attention of a whole prompt (q [B, H, S, hd], k / v
    [B, H_kv, S, hd]), computed a slab of PREFILL_ROWS queries at a time
    by ``resume_attention`` over the keys ``_span_keys`` gives: per query
    row the operations of ``flash_attention`` (the same kv tiles in the
    same order), with every product shaped as a chunk of chunked admission
    shapes its own."""
    S = q.shape[2]
    out = []
    for s0 in range(0, S, PREFILL_ROWS):
        T = _span_keys(s0, min(PREFILL_ROWS, S - s0), S)
        out.append(resume_attention(q[:, :, s0:s0 + PREFILL_ROWS], k[:, :, :T],
                                    v[:, :, :T], s0, causal=True, window=window))
    return torch.cat(out, dim=2)


def _attn_out(p: dict, h, attn, rows):
    """The attention block's output projection, residual and MLP."""
    B, Hq, T, hd = attn.shape
    attn = attn.transpose(1, 2).reshape(B, T, Hq * hd)
    h = h + _mm(attn.to(h.dtype), p["attn"]["wo"], rows)
    return h + _mlp(p["mlp"], rmsnorm(h, p["mlp_ln"]), rows)


def _zeros_states(cfg: ArchConfig, B: int, device):
    _, _, R = _shape(cfg)
    return (torch.zeros((B, CONV_W - 1, R), dtype=torch.bfloat16, device=device),
            torch.zeros((B, R), dtype=torch.float32, device=device))


def _head(params: dict, h):
    hl = rmsnorm(h[:, -1:], params["final_ln"])
    return (hl @ params["head"])[:, 0].to(torch.float32)


# ---------------------------------------------------------------------------
# train / prefill / decode
# ---------------------------------------------------------------------------


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """Full-sequence forward from zero state -> (logits f32 [B, T, V], a
    zero aux loss): each group (two recurrent blocks, then the local
    attention block through ``flash_attention``) under
    ``torch.utils.checkpoint``, then the tail blocks, as the reference.
    The stacked leaves are unbound once (``utils.tree_unbind``)."""
    tokens = batch["tokens"].to(torch.int64)
    B, T = tokens.shape
    h = params["embed"][tokens]
    positions = torch.arange(T, device=h.device)
    conv0, h0 = _zeros_states(cfg, B, h.device)

    def group(hh, gp):
        for rp in tree_unbind(gp["rec"]):
            hh = _rec_block_seq(rp, hh, conv0, h0, None)[0]
        p = gp["attn"]
        q, k, v = _qkv_seq(p["attn"], rmsnorm(hh, p["ln"]), cfg, positions, None)
        attn = flash_attention(q, k, v, causal=True, window=cfg.window)
        return _attn_out(p, hh, attn, None)

    for gp in tree_unbind(params["groups"]):
        h = checkpoint(group, h, gp, use_reentrant=False)
    if params["tail"] is not None:
        for tp in tree_unbind(params["tail"]):
            h = _rec_block_seq(tp, h, conv0, h0, None)[0]
    logits = (rmsnorm(h, params["final_ln"]) @ params["head"]).to(torch.float32)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def _window_cache(cfg: ArchConfig, pack_cfg: PackKVConfig, B: int, device):
    return alloc_layer_cache(pack_cfg, B, cfg.n_kv_heads, cfg.hd, cfg.window,
                             device=device)


def alloc_state(cfg: ArchConfig, pack_cfg: PackKVConfig, batch: int,
                device="cuda") -> RGState:
    n_groups, n_tail, R = _shape(cfg)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return RGState(
        lru_h=z((n_groups, 2, batch, R), torch.float32),
        conv=z((n_groups, 2, batch, CONV_W - 1, R), torch.bfloat16),
        cache=[_window_cache(cfg, pack_cfg, batch, device) for _ in range(n_groups)],
        tail_lru_h=z((n_tail, batch, R), torch.float32),
        tail_conv=z((n_tail, batch, CONV_W - 1, R), torch.bfloat16),
        pos=z((batch,), torch.int32))


def prefill(params: dict, cfg: ArchConfig, pack_cfg: PackKVConfig, capacity: int,
            batch: dict):
    """Process the prompt (batch["tokens"]: int [B, T]); returns (last-token
    logits f32 [B, V], state). ``capacity`` is ignored: the window is the
    cache's capacity, and each attention layer compresses the prompt's
    last ``min(T, window)`` K/V into it."""
    tokens = batch["tokens"].to(torch.int64)
    B, T = tokens.shape
    dev = tokens.device
    rows = PREFILL_ROWS
    h = params["embed"][tokens]
    positions = torch.arange(T, device=dev)
    conv0, h00 = _zeros_states(cfg, B, dev)
    Wc = min(T, cfg.window)
    state = alloc_state(cfg, pack_cfg, B, dev)
    g = params["groups"]
    for gi in range(len(state.cache)):
        for r in range(2):
            h, hist, hf = _rec_block_seq(_index(g["rec"], gi, r), h, conv0, h00, rows)
            state.conv[gi, r], state.lru_h[gi, r] = hist, hf
        p = _index(g["attn"], gi)
        q, k, v = _qkv_seq(p["attn"], rmsnorm(h, p["ln"]), cfg, positions, rows)
        attn = _prefill_attention(q, k, v, cfg.window)
        h = _attn_out(p, h, attn, rows)
        prefill_cache(state.cache[gi], k[..., T - Wc:, :], v[..., T - Wc:, :])
    for t in range(state.tail_lru_h.shape[0]):
        h, hist, hf = _rec_block_seq(_index(params["tail"], t), h, conv0, h00, rows)
        state.tail_conv[t], state.tail_lru_h[t] = hist, hf
    state.pos.fill_(T)
    return _head(params, h), state


def _rec_block_step(p: dict, h, conv_hist, h0):
    """One token of a recurrent block. h: [B, D]. Returns (h, the conv
    history, the LRU state)."""
    x = rmsnorm(h, p["ln"])
    y1 = x @ p["w_in"]  # [B, R]
    y2 = torch.nn.functional.gelu((x @ p["w_gate_branch"]).to(torch.float32),
                                  approximate="tanh").to(h.dtype)
    xp = torch.cat([conv_hist, y1[:, None]], dim=1)  # [B, CONV_W, R]
    yc = torch.einsum("cr,bcr->br", p["conv_w"], xp)
    xf = yc.to(torch.float32)
    r = torch.sigmoid(xf @ p["lru_wa"])
    i = torch.sigmoid(xf @ p["lru_wx"])
    a = torch.exp(-LRU_C * torch.nn.functional.softplus(p["lru_lambda"]) * r)
    hn = a * h0 + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * (i * xf)
    h = h + (hn.to(h.dtype) * y2) @ p["w_out"]
    h = h + mlp_apply(p["mlp"], rmsnorm(h, p["mlp_ln"]))
    return h, xp[:, 1:], hn


def decode_step(params: dict, cfg: ArchConfig, cache: RGState, token: torch.Tensor,
                *, backend: str = "fused", n_bucket: int | None = None,
                rows: int = 1):
    """One decode token over the window caches. token: int [B, 1] ->
    (logits f32 [B, V], state updated IN PLACE).

    Each attention layer appends the token to its ring (``append_token(
    ring=True)``) and attends over ``min(n_comp, window)`` compressed
    tokens and the residual: K2 under a compressed policy (backend
    ``fused``; the plain oracle under ``ref``), the dense attention under
    'none'. ``n_bucket`` and ``rows`` are accepted for the registry's
    signature: the ring is already bounded by the window, and the family
    has no verify pass whose height a step would have to match."""
    del n_bucket, rows
    state = cache
    B = token.shape[0]
    W = cfg.window
    h = params["embed"][token[:, 0].to(torch.int64)]  # [B, D]
    positions = state.pos[:, None, None]  # per-row RoPE positions
    sm_scale = 1.0 / (cfg.hd ** 0.5)
    g = params["groups"]
    flush = flush_rows(state.cache[0]) if state.cache else []
    for gi, layer in enumerate(state.cache):
        for r in range(2):
            h, hist, hf = _rec_block_step(_index(g["rec"], gi, r), h,
                                          state.conv[gi, r], state.lru_h[gi, r])
            state.conv[gi, r], state.lru_h[gi, r] = hist, hf
        p = _index(g["attn"], gi)
        q, k, v = qkv_proj(p["attn"], rmsnorm(h, p["ln"])[:, None], cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta)
        append_token(layer, k, v, flush, ring=True)
        n_valid = torch.clamp(layer.n_comp, max=W)
        if layer.cfg.policy == "none":
            attn = dense_decode_attention(q[:, :, 0], layer.raw_k, layer.raw_v,
                                          layer.resid_k, layer.resid_v, n_valid,
                                          layer.n_resid, sm_scale)
        else:
            attn = packed_decode_attention(q[:, :, 0], layer.k, layer.v,
                                           layer.resid_k, layer.resid_v, n_valid,
                                           layer.n_resid, sm_scale, backend=backend)
        h = h + attn.reshape(B, cfg.n_heads * cfg.hd).to(h.dtype) @ p["attn"]["wo"]
        h = h + mlp_apply(p["mlp"], rmsnorm(h, p["mlp_ln"]))
    for t in range(state.tail_lru_h.shape[0]):
        h, hist, hf = _rec_block_step(_index(params["tail"], t), h,
                                      state.tail_conv[t], state.tail_lru_h[t])
        state.tail_conv[t], state.tail_lru_h[t] = hist, hf
    state.pos += 1
    logits = rmsnorm(h, params["final_ln"]) @ params["head"]
    return logits.to(torch.float32), state


# ---------------------------------------------------------------------------
# slot ops and chunked admission
# ---------------------------------------------------------------------------
# A slot is one batch row of every state leaf: the window caches go through
# the core helpers (insert_row / reset_slot / mask_free_slots, as the
# transformer's do), the O(1) recurrent leaves are plain row writes.


def insert_state_row(state: RGState, slot: int, row: RGState) -> RGState:
    """Write a B=1 state into row ``slot``, IN PLACE."""
    state.lru_h[:, :, slot] = row.lru_h[:, :, 0]
    state.conv[:, :, slot] = row.conv[:, :, 0]
    for dst, src in zip(state.cache, row.cache):
        insert_row(dst, slot, src)
    state.tail_lru_h[:, slot] = row.tail_lru_h[:, 0]
    state.tail_conv[:, slot] = row.tail_conv[:, 0]
    state.pos[slot] = row.pos[0]
    return state


def prefill_into_slot(params: dict, cfg: ArchConfig, pack_cfg, capacity: int,
                      cache: RGState, slot: int, batch: dict):
    """Admit ONE request into row ``slot`` at its true length (a B=1
    prefill written into the row: no pad token reaches its recurrence or
    its window cache). Returns (logits [1, V], state)."""
    logits, row = prefill(params, cfg, pack_cfg, capacity, batch)
    return logits, insert_state_row(cache, slot, row)


def reset_state_slot(state: RGState, slot: int) -> RGState:
    """Recycle row ``slot``, IN PLACE: the window caches' counters to zero,
    the recurrent leaves zeroed outright (they have no counter that masks
    them)."""
    state.lru_h[:, :, slot] = 0
    state.conv[:, :, slot] = 0
    for layer in state.cache:
        reset_slot(layer, slot)
    state.tail_lru_h[:, slot] = 0
    state.tail_conv[:, slot] = 0
    state.pos[slot] = 0
    return state


def mask_free_rows(state: RGState, active) -> RGState:
    """Zero, IN PLACE, the rows of inactive slots after a ride-along decode
    step (``where``: a NaN in a dead row cannot survive)."""
    act = torch.as_tensor(active, device=state.pos.device).to(torch.bool)

    def m(a, lead):  # ``active`` broadcast at batch axis ``lead``
        am = act.reshape((1,) * lead + (-1,) + (1,) * (a.dim() - lead - 1))
        a.copy_(torch.where(am, a, torch.zeros_like(a)))

    m(state.lru_h, 2)
    m(state.conv, 2)
    for layer in state.cache:
        mask_free_slots(layer, act)
    m(state.tail_lru_h, 1)
    m(state.tail_conv, 1)
    state.pos.copy_(torch.where(act, state.pos, torch.zeros_like(state.pos)))
    return state


def prefill_chunk_init(cfg: ArchConfig, pack_cfg, capacity: int, *,
                       prompt_len: int, device="cuda") -> dict:
    """Chunked-admission scratch: a zero B=1 recurrent state and a raw bf16
    K/V scratch a group sized to the whole prompt (the window cache is
    built once, at insert, from the same bytes the monolithic prefill
    compresses)."""
    n_groups, n_tail, R = _shape(cfg)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    kv = (n_groups, 1, cfg.n_kv_heads, prompt_len, cfg.hd)
    return {"k": z(kv, torch.bfloat16), "v": z(kv, torch.bfloat16),
            "lru_h": z((n_groups, 2, 1, R), torch.float32),
            "conv": z((n_groups, 2, 1, CONV_W - 1, R), torch.bfloat16),
            "tail_lru_h": z((n_tail, 1, R), torch.float32),
            "tail_conv": z((n_tail, 1, CONV_W - 1, R), torch.bfloat16)}


def prefill_chunk(params: dict, cfg: ArchConfig, pack_cfg, scratch: dict,
                  tokens: torch.Tensor, *, n_ctx: int, rows: int | None = None):
    """One chunk of a chunked admission (tokens: int [1, Sc] at positions
    ``n_ctx + arange(Sc)``), the scratch updated IN PLACE. The recurrent
    blocks resume exactly from the carried conv history and LRU state;
    attention resumes over the whole-prompt K/V scratch through
    ``resume_attention`` (keys read to ``n_ctx + Sc`` rounded up to the
    monolithic pass's kv tile, window mask included), so composing chunks
    reproduces the monolithic prefill. ``rows``: the chunk's products run
    over that many positions, a monolithic prefill's slab. Returns
    (last-token logits [1, V], scratch)."""
    tokens = tokens.to(torch.int64)
    B, Sc = tokens.shape
    h = params["embed"][tokens]
    positions = n_ctx + torch.arange(Sc, device=h.device)
    T = _span_keys(n_ctx, Sc, scratch["k"].shape[-2])
    g = params["groups"]
    for gi in range(scratch["k"].shape[0]):
        for r in range(2):
            h, hist, hf = _rec_block_seq(_index(g["rec"], gi, r), h,
                                         scratch["conv"][gi, r],
                                         scratch["lru_h"][gi, r], rows)
            scratch["conv"][gi, r], scratch["lru_h"][gi, r] = hist, hf
        p = _index(g["attn"], gi)
        q, k, v = _qkv_seq(p["attn"], rmsnorm(h, p["ln"]), cfg, positions, rows)
        ks, vs = scratch["k"][gi], scratch["v"][gi]
        ks[:, :, n_ctx:n_ctx + Sc] = k
        vs[:, :, n_ctx:n_ctx + Sc] = v
        attn = resume_attention(q, ks[:, :, :T], vs[:, :, :T], n_ctx, causal=True,
                                window=cfg.window)
        h = _attn_out(p, h, attn, rows)
    for t in range(scratch["tail_lru_h"].shape[0]):
        h, hist, hf = _rec_block_seq(_index(params["tail"], t), h,
                                     scratch["tail_conv"][t],
                                     scratch["tail_lru_h"][t], rows)
        scratch["tail_conv"][t], scratch["tail_lru_h"][t] = hist, hf
    return _head(params, h), scratch


def prefill_chunk_insert(cfg: ArchConfig, pack_cfg, capacity: int, cache: RGState,
                         slot: int, scratch: dict) -> RGState:
    """Finish a chunked admission: compress each group's last ``min(T,
    window)`` scratch tokens into a fresh B=1 window cache (the same
    ``prefill_cache`` call over the same bytes as the monolithic prefill)
    and write the whole row into ``slot``, IN PLACE."""
    T = scratch["k"].shape[3]
    Wc = min(T, cfg.window)
    dev = scratch["k"].device
    row = RGState(
        lru_h=scratch["lru_h"], conv=scratch["conv"],
        cache=[prefill_cache(_window_cache(cfg, pack_cfg, 1, dev),
                             k[..., T - Wc:, :], v[..., T - Wc:, :])
               for k, v in zip(scratch["k"], scratch["v"])],
        tail_lru_h=scratch["tail_lru_h"], tail_conv=scratch["tail_conv"],
        pos=torch.full((1,), T, dtype=torch.int32, device=dev))
    return insert_state_row(cache, slot, row)
