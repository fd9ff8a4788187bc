"""Dense transformer family (llama-style), serving half.

The torch port of the serving path of ``repro/models/transformer.py``:
prefill with the reference's tiled flash attention, compress-as-you-prefill
into the PackKV cache (dense or paged storage), chunked admission
(``prefill_chunk*``), and per-token decode over the compressed cache
through ``kernels.ops``. Parameters are a dict whose per-layer tensors are
stacked on a leading ``n_layers`` axis, as the reference's are; the cache
is a list of ``LayerKVCache``, one per layer, updated IN PLACE (the
reference donated it).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.cache import (
    LayerKVCache,
    PackKVConfig,
    alloc_layer_cache,
    append_token,
    flush_rows,
    insert_row,
    insert_row_paged,
    mask_free_slots,
    paged_mini_spec,
    prefill_cache,
    reset_slot,
    slice_compressed,
)
from ..kernels import (
    dense_decode_attention,
    packed_decode_attention,
    paged_decode_attention,
)
from ..utils import round_up
from .layers import (
    dense_init,
    flash_attention,
    mlp_apply,
    qkv_proj,
    resume_attention,
    rmsnorm,
)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_LAYER_SHAPES = {  # name -> (d_in, d_out) as functions of the config
    ("attn", "wq"): lambda c: (c.d_model, c.n_heads * c.hd),
    ("attn", "wk"): lambda c: (c.d_model, c.n_kv_heads * c.hd),
    ("attn", "wv"): lambda c: (c.d_model, c.n_kv_heads * c.hd),
    ("attn", "wo"): lambda c: (c.n_heads * c.hd, c.d_model),
    ("mlp", "w_gate"): lambda c: (c.d_model, c.d_ff),
    ("mlp", "w_up"): lambda c: (c.d_model, c.d_ff),
    ("mlp", "w_down"): lambda c: (c.d_ff, c.d_model),
}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random bf16 weights from ``gen``, on ``gen``'s device. Same layout
    and scales as the reference's init (normal / sqrt(d_in) matrices,
    unit norms, 0.02 embedding); the draws differ (another generator)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = gen.device
    L = cfg.n_layers
    layers: dict = {"ln1": torch.ones((L, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev),
                    "ln2": torch.ones((L, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev),
                    "attn": {}, "mlp": {}}
    for (grp, name), shape in _LAYER_SHAPES.items():
        d_in, d_out = shape(cfg)
        w = torch.empty((L, d_in, d_out), dtype=torch.bfloat16, device=dev)
        for i in range(L):
            w[i] = dense_init(gen, d_in, d_out, device=dev)
        layers[grp][name] = w
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=dev) * 0.02
    return {
        "layers": layers,
        "final_ln": torch.ones((cfg.d_model,), dtype=torch.bfloat16, device=dev),
        "head": dense_init(gen, cfg.d_model, cfg.vocab, device=dev),
        "embed": embed.to(torch.bfloat16),
    }


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views into the stacked tensors)."""
    lp = params["layers"]
    return {"ln1": lp["ln1"][i], "ln2": lp["ln2"][i],
            "attn": {k: v[i] for k, v in lp["attn"].items()},
            "mlp": {k: v[i] for k, v in lp["mlp"].items()}}


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Last position's logits: [B, S, D] -> f32 [B, V]."""
    h = rmsnorm(h[:, -1:], params["final_ln"])
    return (h @ params["head"])[:, 0].to(torch.float32)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def alloc_cache(cfg: ArchConfig, pack_cfg: PackKVConfig, batch: int,
                capacity: int, device="cuda") -> list[LayerKVCache]:
    """One dense ``LayerKVCache`` per layer."""
    return [alloc_layer_cache(pack_cfg, batch, cfg.n_kv_heads, cfg.hd,
                              capacity, device=device)
            for _ in range(cfg.n_layers)]


def prefill(params: dict, cfg: ArchConfig, pack_cfg: PackKVConfig,
            capacity: int, batch: dict):
    """Process the prompt; returns (last-token logits f32 [B, V], cache).

    batch["tokens"]: int [B, S]. Every layer's K/V is compressed into its
    cache as soon as the layer is done (compress-as-you-prefill).
    """
    tokens = batch["tokens"].to(torch.int64)
    h = params["embed"][tokens]
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)
    cache = []
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = qkv_proj(p["attn"], rmsnorm(h, p["ln1"]), cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta,
                           cfg.use_rope)
        attn = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
        attn = attn.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + mlp_apply(p["mlp"], rmsnorm(h, p["ln2"]))
        layer = alloc_layer_cache(pack_cfg, B, cfg.n_kv_heads, cfg.hd,
                                  capacity, device=h.device)
        cache.append(prefill_cache(layer, k, v))
    return _head(params, h), cache


def _insert_rows(cache: list[LayerKVCache], slot: int,
                 rows: list[LayerKVCache], n_pages: int | None) -> None:
    """Write each layer's B=1 dense row into row ``slot`` (paged: into
    ``n_pages`` fresh pages), IN PLACE."""
    for dst, src in zip(cache, rows):
        if dst.pages is not None:
            insert_row_paged(dst, slot, src, n_pages)
        else:
            insert_row(dst, slot, src)


def prefill_into_slot(params: dict, cfg: ArchConfig, pack_cfg: PackKVConfig,
                      capacity: int, cache: list[LayerKVCache], slot: int,
                      batch: dict):
    """Admit ONE request (batch["tokens"]: [1, S], true length) into row
    ``slot`` of every layer's cache, IN PLACE; other rows are untouched.
    Returns (last-token logits [1, V], cache).

    A paged cache admits through a DENSE mini-cache sized to the prompt
    (the same compression math, so the same bytes), scattered into freshly
    popped pages: the slot holds ``ceil(prompt_blocks / page_size)``
    pages, not ``capacity`` tokens."""
    n_pages = None
    if pack_cfg.paged:
        pack_cfg, capacity, n_pages = paged_mini_spec(pack_cfg,
                                                      batch["tokens"].shape[-1])
    logits, rows = prefill(params, cfg, pack_cfg, capacity, batch)
    _insert_rows(cache, slot, rows, n_pages)
    return logits, cache


# ---------------------------------------------------------------------------
# chunked admission
# ---------------------------------------------------------------------------


def prefill_chunk_init(cfg: ArchConfig, pack_cfg: PackKVConfig, capacity: int,
                       *, prompt_len: int, device="cuda") -> dict:
    """Scratch of a chunked admission: raw bf16 K/V of the whole prompt,
    ``[n_layers, 1, H_kv, prompt_len, hd]`` each. Chunks write their keys
    in place and attend over it through ``resume_attention``; compression
    waits for ``prefill_chunk_insert``, so calibration sees exactly the
    bytes the monolithic ``prefill`` would."""
    z = lambda: torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, prompt_len, cfg.hd),
                            dtype=torch.bfloat16, device=device)
    return {"k": z(), "v": z()}


def prefill_chunk(params: dict, cfg: ArchConfig, pack_cfg: PackKVConfig,
                  scratch: dict, tokens: torch.Tensor, *, n_ctx: int,
                  rows: int | None = None):
    """One bounded chunk of a chunked admission. tokens: int [1, Sc] at
    positions ``n_ctx + arange(Sc)``. Writes the chunk's K/V into the
    scratch IN PLACE; returns (last-token logits [1, V], scratch). Only the
    final chunk's logits are meaningful.

    Attention reads the scratch's first ``T`` keys, ``T`` rounded up to
    the monolithic pass's kv tile (``min(1024, prompt_len)``), so every
    query row sees the tiling ``flash_attention`` gives it over the whole
    prompt (the reference cut ``T`` to the chunk's end).

    ``rows``: the chunk runs padded with zero rows to this height (its
    keys are not written; the logits are the last real row's), so a short
    final chunk's GEMMs and attention products have the shape of a full
    chunk's. Rows of a matrix product are independent, so this changes no
    value; on the GPU it keeps cuBLAS from picking other kernels (another
    summation order) for a short chunk than for the full ones."""
    tokens = tokens.to(torch.int64)
    h = params["embed"][tokens]
    B, Sc, _ = h.shape
    h = torch.nn.functional.pad(h, (0, 0, 0, max(0, (rows or Sc) - Sc)))
    positions = n_ctx + torch.arange(h.shape[1], device=h.device)
    S = scratch["k"].shape[-2]
    T = min(S, round_up(n_ctx + Sc, min(1024, S)))
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = qkv_proj(p["attn"], rmsnorm(h, p["ln1"]), cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta,
                           cfg.use_rope)
        ks, vs = scratch["k"][i], scratch["v"][i]
        ks[:, :, n_ctx:n_ctx + Sc] = k[:, :, :Sc]
        vs[:, :, n_ctx:n_ctx + Sc] = v[:, :, :Sc]
        attn = resume_attention(q, ks[:, :, :T], vs[:, :, :T], n_ctx,
                                causal=cfg.causal, window=cfg.window)
        attn = attn.transpose(1, 2).reshape(B, h.shape[1], cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + mlp_apply(p["mlp"], rmsnorm(h, p["ln2"]))
    return _head(params, h[:, :Sc]), scratch


def prefill_chunk_insert(cfg: ArchConfig, pack_cfg: PackKVConfig, capacity: int,
                         cache: list[LayerKVCache], slot: int, scratch: dict):
    """Finish a chunked admission: compress the accumulated prompt K/V as
    the monolithic ``prefill`` does (the same ``prefill_cache`` over the
    same bytes) and write the row into ``slot``, IN PLACE; a paged cache
    goes through ``prefill_into_slot``'s mini-cache route."""
    n_pages = None
    if pack_cfg.paged:
        pack_cfg, capacity, n_pages = paged_mini_spec(pack_cfg,
                                                      scratch["k"].shape[-2])
    dev = scratch["k"].device
    rows = [prefill_cache(alloc_layer_cache(pack_cfg, 1, cfg.n_kv_heads, cfg.hd,
                                            capacity, device=dev), k, v)
            for k, v in zip(scratch["k"], scratch["v"])]
    _insert_rows(cache, slot, rows, n_pages)
    return cache


def reset_cache_slot(cache: list[LayerKVCache], slot: int):
    """Free row ``slot`` of every layer (counters to zero; a paged row
    releases its pages), IN PLACE."""
    for layer in cache:
        reset_slot(layer, slot)
    return cache


def mask_free(cache: list[LayerKVCache], active):
    """Zero the counters of inactive rows in every layer, IN PLACE."""
    for layer in cache:
        mask_free_slots(layer, active)
    return cache


def decode_step(params: dict, cfg: ArchConfig, cache: list[LayerKVCache],
                token: torch.Tensor, *, backend: str = "fused",
                n_bucket: int | None = None):
    """One decode token. token: int [B, 1]. Returns (logits f32 [B, V],
    cache updated IN PLACE).

    ``n_bucket``: attention reads only the first ``n_bucket`` tokens of the
    compressed region; it must upper-bound every row's ``n_comp`` after
    this step's append. None reads the full capacity.
    """
    h = params["embed"][token.to(torch.int64)]
    B = h.shape[0]
    # per-row positions; counters are identical in every layer
    pos = cache[0].n_comp + cache[0].n_resid
    positions = pos[:, None, None]
    sm_scale = 1.0 / (cfg.hd ** 0.5)
    rows = flush_rows(cache[0])  # one host read per step, not per layer
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = qkv_proj(p["attn"], rmsnorm(h, p["ln1"]), cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta,
                           cfg.use_rope)
        qd = q[:, :, 0]
        layer = append_token(cache[i], k, v, rows)
        if layer.cfg.policy == "none":
            read = slice_compressed(layer, n_bucket)
            attn = dense_decode_attention(
                qd, read.raw_k, read.raw_v, read.resid_k, read.resid_v,
                read.n_comp, read.n_resid, sm_scale)
        elif layer.pages is not None and backend == "fused":
            # K5: tiles resolve their page in-kernel, no gathered copy
            attn = paged_decode_attention(qd, layer, sm_scale,
                                          n_bucket=n_bucket, backend=backend)
        else:
            # dense: a prefix view; paged + ref: the page-table gather
            read = slice_compressed(layer, n_bucket)
            attn = packed_decode_attention(
                qd, read.k, read.v, read.resid_k, read.resid_v, read.n_comp,
                read.n_resid, sm_scale, backend=backend)
        attn = attn.reshape(B, 1, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + mlp_apply(p["mlp"], rmsnorm(h, p["ln2"]))
    return _head(params, h), cache


def decode_steps(params: dict, cfg: ArchConfig, cache: list[LayerKVCache],
                 token: torch.Tensor, active, n_steps: int, eos_id: int, *,
                 t_max: int, backend: str = "fused",
                 n_bucket: int | None = None):
    """Multi-step greedy decode: up to ``n_steps`` (<= ``t_max``) tokens.

    A Python loop over ``decode_step`` (the reference's in-graph while
    loop) with EOS early exit once every active row has emitted
    ``eos_id`` (-1 disables it). Free rows ride along and have their
    counters re-zeroed after every step. Returns (tokens int32 [t_max, B]
    — rows past the exit step are zeros, n_exec, cache).
    """
    B = token.shape[0]
    act = torch.as_tensor(active, dtype=torch.bool, device=token.device)
    out = torch.zeros((t_max, B), dtype=torch.int32, device=token.device)
    done = ~act
    tok = token
    i = 0
    while i < n_steps:
        # without EOS, ``done`` never changes: one host read suffices
        if (i == 0 or eos_id >= 0) and bool(done.all()):
            break
        logits, cache = decode_step(params, cfg, cache, tok, backend=backend,
                                    n_bucket=n_bucket)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        out[i] = nxt
        done = done | (nxt == eos_id)
        mask_free(cache, act)
        tok = nxt[:, None]
        i += 1
    return out, i, cache
