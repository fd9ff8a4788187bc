"""RWKV-6 "Finch" (arXiv:2404.05892): a linear RNN with data-dependent decay.

The torch port of ``repro/models/rwkv6.py``: the training forward
(``forward_train``) and the serving path. PackKV does not apply here: the decode state is O(1) in the context (a per-head
[N, N] matrix), so there is no growing KV cache to compress, and the
family reaches no kernel of ``kernels/``. As in the reference, the r/k/v/g
token-shift coefficients are static and the decay is the Finch LoRA
``w_t = exp(-exp(w0 + tanh(x_w A) B))``.

Recurrence per head (k, v, r in R^N, state S in R^{N x N}):
  y_t = (S_{t-1} + diag(u) k_t^T v_t)^T r_t
  S_t = diag(w_t) S_{t-1} + k_t^T v_t

Parameters are a dict whose per-layer tensors are stacked on a leading
``n_layers`` axis, as the reference's are; the state (``RwkvState``) is
updated IN PLACE and returned.

Prefill runs every matrix product over slabs of ``layers.PREFILL_ROWS``
positions (``layers.mm_slabs``; a chunk of chunked admission is one slab
of the engine's chunk height), so a product has the same shape in a
monolithic prefill and in the chunks of a chunked one. The WKV
runs one CHUNK_C-token chunk at a time with the same shapes in every
chunk, and the sequential tail one token at a time, so a 16-aligned split
composes bitwise.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..utils import tree_unbind
from ..distributed.exchange import gather_along, grad_on_first
from .layers import (
    PREFILL_ROWS,
    dense_init,
    embed_tokens,
    enter,
    leave,
    logits_tp,
    part,
    partial_mm,
    rmsnorm,
    row_parallel,
    shared,
    stream_param,
)
from .layers import mm_slabs as _mm

LORA_RANK = 64
CHUNK_C = 16  # chunked matmul-form WKV chunk length
# per-step decay clamp of the factorized form: C/2 |MIN_LOGW| = 32 keeps
# every factor exponent f32-safe
MIN_LOGW = -4.0
_EXP_CLIP = 40.0  # a second bound on the factor exponents (inert given the clamp)


@dataclasses.dataclass
class RwkvState:
    """Decode state, every leaf stacked over layers."""

    S: torch.Tensor  # f32 [n_layers, B, H, N, N] wkv state
    tm_x: torch.Tensor  # bf16 [n_layers, B, D] last token (time-mix shift)
    cm_x: torch.Tensor  # bf16 [n_layers, B, D] last token (channel-mix shift)
    pos: torch.Tensor  # int32 [B] tokens each row has consumed


def _heads(cfg: ArchConfig) -> tuple[int, int]:
    H = cfg.wkv_heads or cfg.n_heads
    return H, cfg.d_model // H


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights from ``gen``, on ``gen``'s device, with the
    reference's layout, dtypes and scales (the draws differ)."""
    dev = gen.device
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, N = _heads(cfg)
    f32, bf16 = torch.float32, torch.bfloat16
    ones = lambda *s: torch.ones(s, dtype=bf16, device=dev)

    def stack(fn):
        return torch.stack([fn() for _ in range(L)])

    mats = {"wr": (D, D), "wk": (D, D), "wv": (D, D), "wg": (D, D), "wo": (D, D),
            "cm_wk": (D, F), "cm_wv": (F, D), "cm_wr": (D, D)}
    layers = {
        "ln1": ones(L, D), "ln2": ones(L, D), "ln_x": ones(L, D),
        "mu": stack(lambda: (torch.rand((5, D), generator=gen, device=dev) * 0.5
                             + 0.25).to(bf16)),
        "w0": torch.full((L, D), -6.0, dtype=f32, device=dev),  # slow decay
        "wA": stack(lambda: dense_init(gen, D, LORA_RANK, f32, dev)),
        "wB": stack(lambda: torch.randn((LORA_RANK, D), generator=gen, device=dev)
                    * 0.01),
        "u": stack(lambda: torch.randn((H, N), generator=gen, device=dev) * 0.1),
    }
    for name, (d_in, d_out) in mats.items():
        layers[name] = stack(lambda: dense_init(gen, d_in, d_out, device=dev))
    embed = torch.randn((cfg.vocab, D), generator=gen, device=dev) * 0.02
    return {"layers": layers, "embed": embed.to(bf16),
            "final_ln": ones(D), "head": dense_init(gen, D, cfg.vocab, device=dev)}


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# sequence forward
# ---------------------------------------------------------------------------


def _decay(p: dict, xw: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """Data-dependent decay w_t in (0, 1). xw: [..., D] -> f32 [..., D]."""
    if xw.dim() == 2:  # a decode step: one position a row
        lora = torch.tanh(xw.to(torch.float32) @ p["wA"]) @ p["wB"]
    else:
        lora = _mm(torch.tanh(_mm(xw.to(torch.float32), p["wA"], rows)), p["wB"], rows)
    return torch.exp(-torch.exp(p["w0"] + lora))


def _wkv_chunked(r, k, v, w, u, S0):
    """Chunked matmul-form WKV: the exact recurrence
      y_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    evaluated per CHUNK_C-token chunk as three products.

    With lp = cumsum(log w), the cross-token weight exp(lp_{t-1} - lp_s)
    splits as exp(lp_{t-1} - rho) exp(rho - lp_s) around the mid-chunk
    reference rho; clamping log w >= MIN_LOGW bounds both exponents by
    C/2 |MIN_LOGW| (f32-safe).

    r, k, v, w: f32 [B, T, H, N] (w the decay in (0, 1)), T a multiple of
    CHUNK_C; u: [H, N]; S0: [B, H, N, N]. Returns (y [B, T, H, N],
    S_final). Every chunk runs the same shapes, one after another."""
    B, T, H, N = r.shape
    C = CHUNK_C
    if T % C:
        raise ValueError(f"{T} tokens are not whole chunks of {C}")
    lw = torch.clamp(torch.log(torch.clamp(w, min=1e-38)), min=MIN_LOGW)
    mask = torch.tril(torch.ones((C, C), dtype=torch.float32, device=r.device), -1)
    S = S0
    ys = []
    for c0 in range(0, T, C):
        rc, kc, vc = r[:, c0:c0 + C], k[:, c0:c0 + C], v[:, c0:c0 + C]
        lp = torch.cumsum(lw[:, c0:c0 + C], dim=1)  # [B, C, H, N]
        lp_prev = torch.cat([torch.zeros_like(lp[:, :1]), lp[:, :-1]], dim=1)
        rho = lp[:, C // 2:C // 2 + 1]
        W1 = rc * torch.exp(torch.clamp(lp_prev - rho, -_EXP_CLIP, _EXP_CLIP))
        W2 = kc * torch.exp(torch.clamp(rho - lp, -_EXP_CLIP, _EXP_CLIP))
        scores = torch.einsum("bthn,bshn->bhts", W1, W2) * mask
        y_intra = torch.einsum("bhts,bshm->bthm", scores, vc)
        y_S0 = torch.einsum("bthn,bhnm->bthm", rc * torch.exp(lp_prev), S)
        y_diag = torch.sum(rc * u * kc, -1, keepdim=True) * vc
        last = lp[:, -1:]
        S = torch.exp(last[:, 0])[..., None] * S + torch.einsum(
            "bthn,bthm->bhnm", kc * torch.exp(last - lp), vc)
        ys.append(y_S0 + y_intra + y_diag)
    return torch.cat(ys, dim=1), S


def _wkv_step(r_t, k_t, v_t, w_t, u, S):
    """One token of the recurrence. r_t, k_t, v_t, w_t: [B, H, N]; S:
    [B, H, N, N]. Returns (y [B, H, N], S)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", r_t, S + u[None, :, :, None] * kv)
    return y, w_t[..., :, None] * S + kv


def _wkv_seq(r, k, v, w, u, S):
    """The sequential scan over [B, t, H, N], a token at a time."""
    ys = []
    for t in range(r.shape[1]):
        y, S = _wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], u, S)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _time_mix_seq(p: dict, cfg: ArchConfig, x, x_prev, S0, rows, tp=None):
    """Time mix over [B, T, D]; returns (out [B, T, D], S_final, last x).

    The WKV is chunked over the CHUNK_C-aligned bulk and sequential over
    the sub-chunk tail, so running [0, Tb) then [Tb, T) from the carried
    state replays the same chunks (the reference's mixed path).

    Under ``tp`` (training: ``rows`` None, ``x`` the whole sequence) r, k,
    v, g and the decay run column-parallel over this rank's WKV heads
    (every head when the heads do not split over the ranks), ``ln_x``
    normalizes the whole width (the heads' outputs all-gathered) and
    ``wo`` is row-parallel: the output is this rank's partial sum."""
    B, T, D = x.shape
    H, N = _heads(cfg)
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)  # shifted
    mu = shared(p["mu"], tp)
    mix = lambda i: x + mu[i] * (xs - x)
    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    f32 = torch.float32
    hlo, hhi = 0, H
    pw = p
    if tp is not None:
        split = H % tp.size == 0
        if split:
            hlo, hhi = tp.range(H)
        lo, hi = hlo * N, hhi * N
        pw = {name: part(p[name], -1, D, lo, hi, tp) for name in ("wr", "wk", "wv", "wg")}
        pw.update(wA=shared(p["wA"], tp), wB=part(p["wB"], -1, D, lo, hi, tp),
                  w0=part(p["w0"], -1, D, lo, hi, tp), u=part(p["u"], 0, H, hlo, hhi, tp))
    Hl = hhi - hlo
    r = _mm(xr, pw["wr"], rows).reshape(B, T, Hl, N).to(f32)
    k = _mm(xk, pw["wk"], rows).reshape(B, T, Hl, N).to(f32)
    v = _mm(xv, pw["wv"], rows).reshape(B, T, Hl, N).to(f32)
    g = torch.nn.functional.silu(_mm(xg, pw["wg"], rows).to(f32))
    w = _decay(pw, xw, rows).reshape(B, T, Hl, N)
    Tb = (T // CHUNK_C) * CHUNK_C
    parts, S = [], S0
    if Tb:
        y, S = _wkv_chunked(r[:, :Tb], k[:, :Tb], v[:, :Tb], w[:, :Tb], pw["u"], S)
        parts.append(y)
    if Tb < T:
        y, S = _wkv_seq(r[:, Tb:], k[:, Tb:], v[:, Tb:], w[:, Tb:], pw["u"], S)
        parts.append(y)
    y = torch.cat(parts, dim=1).reshape(B, T, Hl * N)
    if tp is None:
        y = rmsnorm(y.to(x.dtype), p["ln_x"]) * g.to(x.dtype)
        return _mm(y, p["wo"], rows), S, x[:, -1]
    y = y.to(x.dtype)
    if Hl < H:
        y = gather_along(y, -1, tp)
    y = rmsnorm(y, shared(p["ln_x"], tp))[..., hlo * N:hhi * N] * g.to(x.dtype)
    return row_parallel(y, hlo * N, p["wo"], D, tp), S, x[:, -1]


def _channel_mix_seq(p: dict, x, x_prev, rows, tp=None, F: int = 0):
    """Channel mix over [B, T, D]. Under ``tp`` (training, ``x`` the whole
    sequence): ``cm_wk`` column-parallel and ``cm_wv`` row-parallel over
    this rank's slice of the ``F`` units, their partial sums put back onto
    the stream (rounded once, as the single-device product); the gate
    ``cm_wr`` reads the whole leaf (gathered) on the stream's positions
    only, and multiplies there, so the output is already the stream (the
    gate's gradient is kept on model rank 0 where the stream is whole on
    every rank)."""
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xk = x + 0.5 * (xs - x)
    xr = x + 0.5 * (xs - x)
    f32 = torch.float32
    wk, wv, wr = p["cm_wk"], p["cm_wv"], p["cm_wr"]
    if tp is not None:
        B, T, D = x.shape
        flo, fhi = tp.range(F)
        wk, wv = part(wk, -1, F, flo, fhi, tp), part(wv, -2, F, flo, fhi, tp)
        wr = part(wr, -1, D, 0, D, tp)
        if tp.seq:
            n = T // tp.size
            xr = xr[:, tp.index * n:(tp.index + 1) * n]
    kk = torch.square(torch.relu(_mm(xk, wk, rows).to(f32))).to(x.dtype)
    gate = torch.sigmoid(_mm(xr, wr, rows).to(f32)).to(x.dtype)
    if tp is None:
        return gate * _mm(kk, wv, rows), x[:, -1]
    if not tp.seq:
        gate = grad_on_first(gate, tp)
    return gate * leave(partial_mm(kk, wv), tp, x.dtype), x[:, -1]


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """Full-sequence forward from zero state -> (logits f32 [B, T, V], a
    zero aux loss): the mixed chunked + sequential WKV of ``_time_mix_seq``
    with one product over all positions (``rows=None``), each layer under
    ``torch.utils.checkpoint``, as the reference. The stacked leaves are
    unbound once (``utils.tree_unbind``). Under a 'model' line of ranks
    (``distributed.sharding.model_lanes``) ``params`` are this rank's
    blocks, the stream is sequence-sharded where the line's size divides
    T, and the logits are this rank's vocab slice (``layers.logits_tp``)."""
    from ..distributed.sharding import model_lanes

    tokens = batch["tokens"].to(torch.int64)
    B, T = tokens.shape
    H, N = _heads(cfg)
    tp = model_lanes(T)
    h = leave(embed_tokens(params["embed"], tokens, cfg.vocab, tp), tp,
              params["embed"].dtype)
    Hl = H if tp is None or H % tp.size else H // tp.size

    def block(hh, p):
        z = torch.zeros((B, cfg.d_model), dtype=hh.dtype, device=hh.device)
        S0 = torch.zeros((B, Hl, N, N), dtype=torch.float32, device=hh.device)
        x = enter(rmsnorm(hh, stream_param(p["ln1"], tp)), tp)
        hh = hh + leave(_time_mix_seq(p, cfg, x, z, S0, None, tp)[0], tp, hh.dtype)
        x = enter(rmsnorm(hh, stream_param(p["ln2"], tp)), tp)
        return hh + _channel_mix_seq(p, x, z, None, tp, cfg.d_ff)[0]

    for p in tree_unbind(params["layers"]):
        h = checkpoint(block, h, p, use_reentrant=False)
    hn = rmsnorm(h, stream_param(params["final_ln"], tp))
    return logits_tp(hn, params["head"], cfg.vocab, tp), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def alloc_state(cfg: ArchConfig, batch: int, device="cuda") -> RwkvState:
    D, L = cfg.d_model, cfg.n_layers
    H, N = _heads(cfg)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return RwkvState(S=z((L, batch, H, N, N), torch.float32),
                     tm_x=z((L, batch, D), torch.bfloat16),
                     cm_x=z((L, batch, D), torch.bfloat16),
                     pos=z((batch,), torch.int32))


def _forward_seq(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 state: RwkvState, rows: int | None):
    """Run a token span through the recurrence, resuming from ``state``
    (updated IN PLACE; a zero state is a cold prefill). The mixed WKV path
    composes exactly at CHUNK_C-aligned splits and the token-shift carries
    are the last token, so prefilling [0, c) then [c, T) from the carried
    state reproduces the one-shot prefill: chunked admission is this
    function called per chunk. Returns (last-token logits f32 [B, V],
    state)."""
    T = tokens.shape[1]
    h = params["embed"][tokens.to(torch.int64)]
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        y, S, tm_x = _time_mix_seq(p, cfg, rmsnorm(h, p["ln1"]), state.tm_x[i],
                                   state.S[i], rows)
        h = h + y
        c, cm_x = _channel_mix_seq(p, rmsnorm(h, p["ln2"]), state.cm_x[i], rows)
        h = h + c
        state.S[i], state.tm_x[i], state.cm_x[i] = S, tm_x, cm_x
    state.pos += T
    hl = rmsnorm(h[:, -1:], params["final_ln"])
    return (hl @ params["head"])[:, 0].to(torch.float32), state


def prefill(params: dict, cfg: ArchConfig, pack_cfg, capacity, batch: dict):
    """Run the prompt (batch["tokens"]: int [B, T]) through the recurrence;
    the state is the 'cache'. ``pack_cfg`` and ``capacity`` are accepted
    for the registry's signature."""
    tokens = batch["tokens"]
    state = alloc_state(cfg, tokens.shape[0], tokens.device)
    return _forward_seq(params, cfg, tokens, state, PREFILL_ROWS)


# ---------------------------------------------------------------------------
# slot ops and chunked admission
# ---------------------------------------------------------------------------
# A slot is one batch row of every state leaf: admission is a B=1 prefill
# written into that row, recycling zeroes it. No pages, no counters.


def insert_state_row(state: RwkvState, slot: int, row: RwkvState) -> RwkvState:
    """Write a B=1 state into row ``slot``, IN PLACE."""
    for name in ("S", "tm_x", "cm_x"):
        getattr(state, name)[:, slot] = getattr(row, name)[:, 0]
    state.pos[slot] = row.pos[0]
    return state


def prefill_into_slot(params: dict, cfg: ArchConfig, pack_cfg, capacity: int,
                      cache: RwkvState, slot: int, batch: dict):
    """Admit ONE request (batch["tokens"]: [1, T], its true length) into
    row ``slot``: a B=1 prefill written into the row, so no pad token ever
    runs through the row's recurrence. Returns (logits [1, V], state)."""
    logits, row = prefill(params, cfg, pack_cfg, capacity, batch)
    return logits, insert_state_row(cache, slot, row)


def reset_state_slot(state: RwkvState, slot: int) -> RwkvState:
    """Zero row ``slot`` of every leaf, IN PLACE."""
    for name in ("S", "tm_x", "cm_x"):
        getattr(state, name)[:, slot] = 0
    state.pos[slot] = 0
    return state


def mask_free_rows(state: RwkvState, active) -> RwkvState:
    """Zero, IN PLACE, the rows of inactive slots (``active``: bool [B])
    after a ride-along decode step; a NaN in a dead row cannot survive."""
    act = torch.as_tensor(active, device=state.pos.device).to(torch.bool)
    for name in ("S", "tm_x", "cm_x"):
        a = getattr(state, name)
        m = act.reshape((1, -1) + (1,) * (a.dim() - 2))
        a.copy_(torch.where(m, a, torch.zeros_like(a)))
    state.pos.copy_(torch.where(act, state.pos, torch.zeros_like(state.pos)))
    return state


def prefill_chunk_init(cfg: ArchConfig, pack_cfg, capacity: int, *,
                       prompt_len: int, device="cuda") -> RwkvState:
    """Chunked-admission scratch: a zero B=1 state (the resume point)."""
    del prompt_len
    return alloc_state(cfg, 1, device)


def prefill_chunk(params: dict, cfg: ArchConfig, pack_cfg, scratch: RwkvState,
                  tokens: torch.Tensor, *, n_ctx: int, rows: int | None = None):
    """One chunk of a chunked admission: advance the B=1 state through
    ``tokens`` ([1, Sc]). ``n_ctx`` is implied by the carried state;
    chunk boundaries must be CHUNK_C-aligned for exact composition (page
    sizes are). ``rows``: the chunk's products run over that many
    positions (zero rows after the chunk's), a monolithic prefill's slab."""
    del n_ctx
    return _forward_seq(params, cfg, tokens, scratch, rows)


def prefill_chunk_insert(cfg: ArchConfig, pack_cfg, capacity: int,
                         cache: RwkvState, slot: int, scratch: RwkvState):
    return insert_state_row(cache, slot, scratch)


def decode_step(params: dict, cfg: ArchConfig, cache: RwkvState,
                token: torch.Tensor, *, backend: str = "fused",
                n_bucket: int | None = None, rows: int = 1):
    """One decode token. token: int [B, 1] -> (logits f32 [B, V], state
    updated IN PLACE). ``backend``, ``n_bucket`` and ``rows`` are accepted
    for the registry's signature: the family has no kernel, no cache to
    bucket and no verify pass whose height a step would have to match."""
    del backend, n_bucket, rows
    state = cache
    B = token.shape[0]
    D = cfg.d_model
    H, N = _heads(cfg)
    f32 = torch.float32
    h = params["embed"][token[:, 0].to(torch.int64)]  # [B, D]
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        xin = rmsnorm(h, p["ln1"])
        tm_x, cm_x = state.tm_x[i], state.cm_x[i]
        mu = p["mu"]
        mix = lambda j: xin + mu[j] * (tm_x - xin)
        xr, xk, xv, xw, xg = (mix(j) for j in range(5))
        r = (xr @ p["wr"]).reshape(B, H, N).to(f32)
        k = (xk @ p["wk"]).reshape(B, H, N).to(f32)
        v = (xv @ p["wv"]).reshape(B, H, N).to(f32)
        g = torch.nn.functional.silu((xg @ p["wg"]).to(f32))
        w = _decay(p, xw).reshape(B, H, N)
        y, S = _wkv_step(r, k, v, w, p["u"], state.S[i])
        y = rmsnorm(y.reshape(B, D).to(h.dtype), p["ln_x"]) * g.to(h.dtype)
        h = h + y @ p["wo"]
        xc = rmsnorm(h, p["ln2"])
        xkc = xc + 0.5 * (cm_x - xc)
        xrc = xc + 0.5 * (cm_x - xc)
        kk = torch.square(torch.relu((xkc @ p["cm_wk"]).to(f32))).to(xc.dtype)
        c = torch.sigmoid((xrc @ p["cm_wr"]).to(f32)).to(xc.dtype) * (kk @ p["cm_wv"])
        h = h + c
        state.S[i], state.tm_x[i], state.cm_x[i] = S, xin, xc
    state.pos += 1
    logits = rmsnorm(h, params["final_ln"]) @ params["head"]
    return logits.to(f32), state
