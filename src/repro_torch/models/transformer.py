"""Transformer family (llama-style): the dense configs, MoE (qwen2-moe,
moonshot: ``models/moe.py`` in place of the SwiGLU), the VLM (internvl2: a
patch-embedding prefix) and the encoder (hubert: frame inputs,
``encode``).

The torch port of ``repro/models/transformer.py``: the training forward
(``forward_train``, a checkpoint per layer), prefill with the reference's
tiled flash attention, compress-as-you-prefill into the PackKV cache
(dense or paged storage), chunked admission (``prefill_chunk*``), and
per-token decode over the compressed cache through ``kernels.ops``. Parameters are a dict whose per-layer tensors are
stacked on a leading ``n_layers`` axis, as the reference's are; the cache
is a list of ``LayerKVCache``, one per layer, updated IN PLACE (the
reference donated it).

An MoE MLP routes only the tokens the reference feeds it: where a call
site pads its hidden state with zero rows (``decode_step``'s and
``prefill_chunk``'s ``rows``), ``_apply_mlp`` passes the real positions
(``moe_apply(n_real=...)``), so the padding takes no expert capacity.
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
    append_window,
    commit_window,
    evacuate_row,
    flush_rows,
    insert_row,
    insert_row_paged,
    mask_free_slots,
    paged_mini_spec,
    prefill_append,
    prefill_cache,
    reset_slot,
    restore_row,
    seed_prefix_from_pages,
    slice_compressed,
)
from ..core.tiered import dequantize_tiered, slice_tiered_prefix
from ..kernels import (
    dense_decode_attention,
    packed_decode_attention,
    paged_decode_attention,
)
from ..utils import div, round_up, tree_unbind
from .layers import (
    attention_norm_init,
    ctx_attention,
    dense_init,
    flash_attention,
    mlp_apply,
    qkv_proj,
    resume_attention,
    rmsnorm,
)
from .moe import moe_apply, moe_init

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_LAYER_SHAPES = {  # name -> (d_in, d_out) as functions of the config
    ("attn", "wq"): lambda c: (c.d_model, c.n_heads * c.hd),
    ("attn", "wk"): lambda c: (c.d_model, c.n_kv_heads * c.hd),
    ("attn", "wv"): lambda c: (c.d_model, c.n_kv_heads * c.hd),
    ("attn", "wo"): lambda c: (c.n_heads * c.hd, c.d_model),
}
_MLP_SHAPES = {  # the SwiGLU of every family but moe
    ("mlp", "w_gate"): lambda c: (c.d_model, c.d_ff),
    ("mlp", "w_up"): lambda c: (c.d_model, c.d_ff),
    ("mlp", "w_down"): lambda c: (c.d_ff, c.d_model),
}
FAMILIES = ("dense", "moe", "vlm", "encoder")  # the families ported so far


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random bf16 weights from ``gen``, on ``gen``'s device. Same layout
    and scales as the reference's init (normal / sqrt(d_in) matrices,
    unit norms, 0.02 embedding; ``q_norm`` / ``k_norm`` ``[L, hd]`` when
    ``cfg.qk_norm``; the MoE MLP of ``moe.moe_init``; no embedding for
    frame inputs); the draws differ (another generator)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = gen.device
    L = cfg.n_layers
    layers: dict = {"ln1": torch.ones((L, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev),
                    "ln2": torch.ones((L, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev),
                    "attn": {}, "mlp": {}}
    shapes = dict(_LAYER_SHAPES)
    if cfg.family == "moe":
        layers["mlp"] = moe_init(gen, cfg, L)
    else:
        shapes.update(_MLP_SHAPES)
    for (grp, name), shape in shapes.items():
        d_in, d_out = shape(cfg)
        w = torch.empty((L, d_in, d_out), dtype=torch.bfloat16, device=dev)
        for i in range(L):
            w[i] = dense_init(gen, d_in, d_out, device=dev)
        layers[grp][name] = w
    if cfg.qk_norm:
        for name, w in attention_norm_init(cfg.hd, dev).items():
            layers["attn"][name] = w.expand(L, cfg.hd).clone()
    params = {
        "layers": layers,
        "final_ln": torch.ones((cfg.d_model,), dtype=torch.bfloat16, device=dev),
        "head": dense_init(gen, cfg.d_model, cfg.vocab, device=dev),
    }
    if cfg.input_mode in ("tokens", "tokens_patches"):
        embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                            dtype=torch.float32, device=dev) * 0.02
        params["embed"] = embed.to(torch.bfloat16)
    return params


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views into the stacked tensors; nested
    dicts, such as an MoE MLP's ``shared``, walked)."""
    return _index(params["layers"], i)


def _apply_mlp(cfg: ArchConfig, p: dict, h: torch.Tensor, site: str,
               n_real: int | None = None):
    """The MLP block's (output, aux loss) for hidden states ``h``
    (normalized by ``ln2`` first): SwiGLU and an aux of 0.0 (a Python
    number, so serving launches nothing for it), or the MoE routing only
    each batch row's first ``n_real`` positions (the rest are padding) and
    its load-balancing loss."""
    x = rmsnorm(h, p["ln2"])
    if cfg.family == "moe":
        return moe_apply(p["mlp"], x, cfg, n_real=n_real, site=site)
    return mlp_apply(p["mlp"], x), 0.0


def _embed_inputs(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Hidden states [B, S, D] of a batch by its input mode: token
    embeddings, the frames themselves (audio stub), or the patch
    embeddings followed by the token embeddings (VLM stub)."""
    if cfg.input_mode == "tokens":
        return params["embed"][batch["tokens"].to(torch.int64)]
    if cfg.input_mode == "frames":
        return batch["frames"].to(torch.bfloat16)
    if cfg.input_mode == "tokens_patches":
        tok = params["embed"][batch["tokens"].to(torch.int64)]
        return torch.cat([batch["patches"].to(tok.dtype), tok], dim=1)
    raise ValueError(cfg.input_mode)


def _qkv(p: dict, h: torch.Tensor, cfg: ArchConfig, positions):
    """One layer's q, k, v of the hidden states ``h`` (``layers.qkv_proj``
    with the config's heads, RoPE and qk-norm)."""
    return qkv_proj(p["attn"], rmsnorm(h, p["ln1"]), cfg.n_heads,
                    cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta,
                    qk_norm=cfg.qk_norm, use_rope=cfg.use_rope)


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Every position's logits: [B, S, D] -> f32 [B, S, V]."""
    return (rmsnorm(h, params["final_ln"]) @ params["head"]).to(torch.float32)


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Last position's logits: [B, S, D] -> f32 [B, V]."""
    return _logits(params, h[:, -1:])[:, 0]


def _block_train(cfg: ArchConfig, p: dict, h: torch.Tensor, positions):
    """One layer of the training forward: (h, the MLP's aux loss)."""
    B, S, _ = h.shape
    q, k, v = _qkv(p, h, cfg, positions)
    attn = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    attn = attn.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    h = h + attn.to(h.dtype) @ p["attn"]["wo"]
    m, aux = _apply_mlp(cfg, p, h, "train")
    return h + m, aux


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """Full-sequence forward -> (logits f32 [B, S, V], aux loss f32 []),
    the MoE aux summed over the layers and divided by ``n_layers``.

    Each layer runs under ``torch.utils.checkpoint`` (the reference's
    per-layer remat): the backward recomputes one layer's activations at a
    time. The stacked leaves are unbound once (``tree_unbind``), so their
    backward is one ``stack`` a leaf; a per-layer ``select`` would zero a
    whole stack's gradient once a layer."""
    h = _embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in tree_unbind(params["layers"]):
        h, a = checkpoint(_block_train, cfg, p, h, positions, use_reentrant=False)
        aux = aux + a
    return _logits(params, h), div(aux, cfg.n_layers)


def encode(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Encoder-only forward to the final hidden states [B, S, D] (hubert's
    'prefill': attention as ``cfg.causal`` says, non-causal for an
    encoder; no KV cache)."""
    h = _embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        attn = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
        attn = attn.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "encode")[0]
    return rmsnorm(h, params["final_ln"])


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

    batch["tokens"]: int [B, S] (a VLM's ``batch["patches"]``: [B, P, D],
    its positions before the tokens'). Every layer's K/V is compressed
    into its cache as soon as the layer is done (compress-as-you-prefill).
    """
    h = _embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)
    cache = []
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        attn = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
        attn = attn.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "prefill")[0]
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
    summation order) for a short chunk than for the full ones. An MoE MLP
    routes the chunk's ``Sc`` tokens alone, as the reference does."""
    tokens = tokens.to(torch.int64)
    h = params["embed"][tokens]
    B, Sc, _ = h.shape
    h = torch.nn.functional.pad(h, (0, 0, 0, max(0, (rows or Sc) - Sc)))
    positions = n_ctx + torch.arange(h.shape[1], device=h.device)
    S = scratch["k"].shape[-2]
    T = min(S, round_up(n_ctx + Sc, min(1024, S)))
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        ks, vs = scratch["k"][i], scratch["v"][i]
        ks[:, :, n_ctx:n_ctx + Sc] = k[:, :, :Sc]
        vs[:, :, n_ctx:n_ctx + Sc] = v[:, :, :Sc]
        attn = resume_attention(q, ks[:, :, :T], vs[:, :, :T], n_ctx,
                                causal=cfg.causal, window=cfg.window)
        attn = attn.transpose(1, 2).reshape(B, h.shape[1], cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "chunk", n_real=Sc)[0]
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


# ---------------------------------------------------------------------------
# prefix-cache admission (paged storage)
# ---------------------------------------------------------------------------


def _prefill_segment(params: dict, cfg: ArchConfig, pack_cfg: PackKVConfig,
                     mini: list[LayerKVCache], tokens: torch.Tensor,
                     n_ctx: int):
    """One segment of a prefix-cache admission: forward ``tokens`` ([1, S])
    at positions ``n_ctx + arange(S)`` with the mini-cache's first
    ``n_ctx`` compressed tokens as read-only context, appending the
    segment's own K/V to the mini-cache IN PLACE.

    The context is DEQUANTIZED for the segment's attention (policy 'none'
    reads its raw tokens), so a segment's output depends only on the
    prompt up to its end: any page boundary is an exact resume point.
    Returns (last-token logits [1, V], mini)."""
    tokens = tokens.to(torch.int64)
    h = params["embed"][tokens]
    B, S, _ = h.shape
    positions = n_ctx + torch.arange(S, device=h.device)
    sm_scale = 1.0 / (cfg.hd ** 0.5)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        layer = mini[i]
        if n_ctx:
            if pack_cfg.policy == "none":
                ck, cv = layer.raw_k[..., :n_ctx, :], layer.raw_v[..., :n_ctx, :]
            else:
                ck = dequantize_tiered(slice_tiered_prefix(layer.k, n_ctx)).transpose(-1, -2)
                cv = dequantize_tiered(slice_tiered_prefix(layer.v, n_ctx)).transpose(-1, -2)
            k_all = torch.cat([ck.to(torch.float32), k.to(torch.float32)], dim=2)
            v_all = torch.cat([cv.to(torch.float32), v.to(torch.float32)], dim=2)
        else:
            k_all, v_all = k, v
        attn = ctx_attention(q, k_all, v_all, n_ctx, sm_scale)
        attn = attn.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "segment")[0]
        prefill_append(layer, k, v, calibrate=n_ctx == 0)
    return _head(params, h), mini


def prefix_chunk_bounds(pack_cfg: PackKVConfig, prompt_len: int,
                        n_prefix: int) -> list[int]:
    """Segment bounds of a prefix-cache admission from ``n_prefix``: one
    page a segment up to the prompt's last full page, then the rest."""
    page = pack_cfg.page_size
    Lb = (prompt_len // pack_cfg.block) * pack_cfg.block
    Lp = (Lb // page) * page
    bounds = list(range(n_prefix, Lp + 1, page))
    if prompt_len > Lp:
        bounds.append(prompt_len)
    return bounds


def prefix_chunk_init(cfg: ArchConfig, pack_cfg: PackKVConfig, capacity: int,
                      cache: list[LayerKVCache], prefix_phys: torch.Tensor,
                      k_perm, v_perm, *, n_prefix: int, prompt_len: int,
                      device="cuda") -> list[LayerKVCache]:
    """The dense B=1 mini-cache of a prefix-cache admission, seeded with
    the matched shared pages ``prefix_phys`` and their donor's channel
    permutations (``k_perm`` / ``v_perm``: [n_layers, H_kv, D], or None
    for policy 'none') when ``n_prefix > 0``."""
    dense_cfg, cap_mini, _ = paged_mini_spec(pack_cfg, prompt_len)
    mini = alloc_cache(cfg, dense_cfg, 1, cap_mini, device)
    if n_prefix:
        for i, (layer, m) in enumerate(zip(cache, mini)):
            seed_prefix_from_pages(layer, m, prefix_phys, n_prefix,
                                   None if k_perm is None else k_perm[i],
                                   None if v_perm is None else v_perm[i])
    return mini


def prefix_chunk(params: dict, cfg: ArchConfig, pack_cfg: PackKVConfig,
                 mini: list[LayerKVCache], tokens: torch.Tensor, *, n_ctx: int):
    """One page-aligned segment of a prefix-cache admission
    (``_prefill_segment``)."""
    return _prefill_segment(params, cfg, pack_cfg, mini, tokens, n_ctx)


def prefix_chunk_insert(pack_cfg: PackKVConfig, cache: list[LayerKVCache],
                        slot: int, mini: list[LayerKVCache],
                        prefix_phys: torch.Tensor, *, n_prefix: int,
                        prompt_len: int):
    """Finish a prefix-cache admission: map the ``n_prefix`` shared tokens'
    pages into row ``slot`` by reference and scatter the rest of the
    mini-cache into fresh pages, IN PLACE."""
    _, _, n_pages = paged_mini_spec(pack_cfg, prompt_len)
    for dst, src in zip(cache, mini):
        insert_row_paged(dst, slot, src, n_pages,
                         n_shared=n_prefix // pack_cfg.page_size,
                         shared_phys=prefix_phys)
    return cache


def prefill_into_slot_prefix(params: dict, cfg: ArchConfig,
                             pack_cfg: PackKVConfig, capacity: int,
                             cache: list[LayerKVCache], slot: int, batch: dict,
                             prefix_phys: torch.Tensor, k_perm, v_perm, *,
                             n_prefix: int):
    """Prefix-cache admission of ONE request into row ``slot``, IN PLACE:
    a chunked prefill, one page a segment, through a dense mini-cache.

    The first segment calibrates the channel permutation; each later one
    attends to the compressed earlier pages. The ``n_prefix`` tokens
    (page-aligned, below the prompt length) whose pool pages
    ``prefix_phys`` the host's prefix index matched are not recomputed:
    their pages are mapped into the slot by reference and the suffix
    compresses under the donor's permutation (``k_perm`` / ``v_perm``), so
    a hit reproduces a cold admission bit for bit. Returns (last-token
    logits [1, V], cache)."""
    if not pack_cfg.paged:
        raise ValueError("prefix-cache admission needs paged storage")
    tokens = batch["tokens"]
    S = tokens.shape[-1]
    page = pack_cfg.page_size
    Lp = (S // pack_cfg.block) * pack_cfg.block // page * page
    if n_prefix % page or n_prefix > Lp or n_prefix >= S:
        raise ValueError(f"matched prefix {n_prefix} must be whole pages "
                         f"within the prompt's {Lp} and below its {S} tokens")
    mini = prefix_chunk_init(cfg, pack_cfg, capacity, cache, prefix_phys,
                             k_perm, v_perm, n_prefix=n_prefix, prompt_len=S,
                             device=tokens.device)
    bounds = prefix_chunk_bounds(pack_cfg, S, n_prefix)
    logits = None
    for s0, s1 in zip(bounds, bounds[1:]):
        logits, mini = _prefill_segment(params, cfg, pack_cfg, mini,
                                        tokens[:, s0:s1], n_ctx=s0)
    prefix_chunk_insert(pack_cfg, cache, slot, mini, prefix_phys,
                        n_prefix=n_prefix, prompt_len=S)
    return logits, cache


def reset_cache_slot(cache: list[LayerKVCache], slot: int):
    """Free row ``slot`` of every layer (counters to zero; a paged row
    releases its pages), IN PLACE."""
    for layer in cache:
        reset_slot(layer, slot)
    return cache


def evacuate_cache_slot(cache: list[LayerKVCache], slot: int, n_pages: int = 0,
                        n_shared: int = 0):
    """Swap row ``slot`` out of every layer (``core.cache.evacuate_row``):
    returns (the cache with the row freed IN PLACE, the per-layer dense
    B=1 minis). ``n_pages`` / ``n_shared``: the scheduler's host mirror
    of the row's live pages and its shared-prefix pages (paged only)."""
    return evacuate_row(cache, slot, n_pages, n_shared)


def restore_cache_slot(cache: list[LayerKVCache], slot: int, mini, shared_phys,
                       n_pages: int = 0, n_shared: int = 0):
    """Stream evacuated minis back into row ``slot`` of every layer, IN
    PLACE (``core.cache.restore_row``): shared-prefix pages mapped by
    reference, the suffix scattered into fresh pages. Pure data movement:
    no forward pass."""
    return restore_row(cache, slot, mini, shared_phys, n_pages, n_shared)


def mask_free(cache: list[LayerKVCache], active):
    """Zero the counters of inactive rows in every layer, IN PLACE."""
    for layer in cache:
        mask_free_slots(layer, active)
    return cache


def _attend(layer: LayerKVCache, q: torch.Tensor, sm_scale: float,
            backend: str, n_bucket: int | None, ahead: int = 0) -> torch.Tensor:
    """Decode attention of one query position q [B, H, hd] over ``layer``
    with ``ahead`` more residual tokens than its counter holds (a verify
    window's position ``ahead`` sees the drafts before it) -> f32
    [B, H, hd]. One launch of K2 (dense), K5 (paged, fused) or the dense
    attention of policy 'none'."""
    n_resid = layer.n_resid + ahead if ahead else layer.n_resid
    if layer.cfg.policy == "none":
        read = slice_compressed(layer, n_bucket)
        return dense_decode_attention(
            q, read.raw_k, read.raw_v, read.resid_k, read.resid_v,
            read.n_comp, n_resid, sm_scale)
    if layer.pages is not None and backend == "fused":
        # K5: tiles resolve their page in-kernel, no gathered copy
        return paged_decode_attention(
            q, dataclasses.replace(layer, n_resid=n_resid), sm_scale,
            n_bucket=n_bucket, backend=backend)
    # dense: a prefix view; paged + ref: the page-table gather
    read = slice_compressed(layer, n_bucket)
    return packed_decode_attention(
        q, read.k, read.v, read.resid_k, read.resid_v, read.n_comp, n_resid,
        sm_scale, backend=backend)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, 1, ...] -> [B, rows, ...], zero rows after the first."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - 1)) if rows > 1 else x


def decode_step(params: dict, cfg: ArchConfig, cache: list[LayerKVCache],
                token: torch.Tensor, *, backend: str = "fused",
                n_bucket: int | None = None, rows: int = 1):
    """One decode token. token: int [B, 1]. Returns (logits f32 [B, V],
    cache updated IN PLACE).

    ``n_bucket``: attention reads only the first ``n_bucket`` tokens of the
    compressed region; it must upper-bound every row's ``n_comp`` after
    this step's append. None reads the full capacity.

    ``rows``: the hidden state runs padded with zero rows to ``rows``
    positions a batch row (only the first is appended and attends), so
    every GEMM, norm and head product has the shape of a ``verify_steps``
    pass over a window of ``rows``. Rows are independent, so this changes
    no value of a product of a given shape; on the GPU cuBLAS sums a row of
    a 4-row product in another order than one of a 20-row product, and
    speculative decode equals plain decode bitwise only when both run the
    same shapes. An MoE MLP routes the first position of each row alone
    (T = B, as in the reference), so the padding takes no capacity.
    """
    h = _pad_rows(params["embed"][token.to(torch.int64)], rows)
    B = h.shape[0]
    # per-row positions; counters are identical in every layer
    pos = cache[0].n_comp + cache[0].n_resid
    positions = pos[:, None, None]
    sm_scale = 1.0 / (cfg.hd ** 0.5)
    flush = flush_rows(cache[0])  # one host read per step, not per layer
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        layer = append_token(cache[i], k[:, :, :1], v[:, :, :1], flush)
        attn = _attend(layer, q[:, :, 0], sm_scale, backend, n_bucket)
        attn = _pad_rows(attn.reshape(B, 1, cfg.n_heads * cfg.hd), rows)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "decode", n_real=1)[0]
    return _logits(params, h)[:, 0], cache


def verify_steps(params: dict, cfg: ArchConfig, cache: list[LayerKVCache],
                 tokens: torch.Tensor, lens: torch.Tensor, active, *,
                 backend: str = "fused", n_bucket: int | None = None):
    """Speculative verify: one forward over a window of w positions, the
    acceptance and the commit on the device.

    tokens: int [B, w], per row the seed (the token ``decode_step`` would
    be fed) then w - 1 drafts, junk-padded; lens: int [B] in [1, w], seed
    + drafts valid per row; active: bool [B], occupied rows (free rows
    ride along and have their counters re-zeroed). Returns (hat int32
    [B, w], n_accept int32 [B], cache committed IN PLACE): ``hat[b, i]``
    is the greedy token ``decode_step`` would emit after position i, and
    ``n_accept[b]`` the length of the draft prefix those tokens confirm
    (draft i is accepted iff it equals ``hat[b, i - 1]``), so the emitted
    ``hat[b, :n_accept + 1]`` is exact for any drafts.

    Bitwise equal to ``decode_step(rows=w)`` run position by position: the
    seed appends through ``append_token`` (flush and page pop included),
    drafts land at the stepwise residual offsets (``append_window``),
    RoPE positions are ``n_comp + n_resid + i`` read before the seed
    append (a flush conserves the sum), and position i attends through
    the same per-token kernel with ``n_resid + i``, the counter stepwise
    step i sees after its own append. The attention is unrolled per
    position, never batched over w: a batched reduction order moves an
    accepted draft's output by an ulp, its K/V bytes in deeper layers, and
    a later token. The GEMMs run over all ``B * w`` rows, the shape
    ``decode_step(rows=w)`` gives its own."""
    h = params["embed"][tokens.to(torch.int64)]
    B, w = tokens.shape
    pos = cache[0].n_comp + cache[0].n_resid  # pre-append totals
    positions = pos[:, None, None] + torch.arange(w, device=h.device)
    sm_scale = 1.0 / (cfg.hd ** 0.5)
    lens = lens.to(torch.int32)
    flush = flush_rows(cache[0])
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        layer = append_window(cache[i], k, v, lens, flush)
        attn = torch.stack([_attend(layer, q[:, :, j], sm_scale, backend,
                                    n_bucket, ahead=j) for j in range(w)], dim=2)
        attn = attn.transpose(1, 2).reshape(B, w, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "verify")[0]
    hat = torch.argmax(_logits(params, h), -1).to(torch.int32)
    # the leading run of drafts the window's argmaxes confirm, within each
    # row's valid drafts (free rows have lens 1: their junk never commits)
    offs = torch.arange(w - 1, device=h.device)
    match = (hat[:, :-1] == tokens[:, 1:].to(torch.int32)) & \
        (offs[None, :] < (lens - 1)[:, None])
    n_accept = torch.cumprod(match.to(torch.int32), dim=1).sum(1).to(torch.int32)
    for layer in cache:
        commit_window(layer, n_accept)
    mask_free(cache, active)
    return hat, n_accept, cache


def decode_steps(params: dict, cfg: ArchConfig, cache: list[LayerKVCache],
                 token: torch.Tensor, active, n_steps: int, eos_id: int, *,
                 t_max: int, backend: str = "fused",
                 n_bucket: int | None = None, rows: int = 1):
    """Multi-step greedy decode: up to ``n_steps`` (<= ``t_max``) tokens.

    A Python loop over ``decode_step`` (the reference's in-graph while
    loop; ``rows`` as there) with EOS early exit once every active row has
    emitted ``eos_id`` (-1 disables it). Free rows ride along and have
    their counters re-zeroed after every step. Returns (tokens int32
    [t_max, B] — rows past the exit step are zeros, n_exec, cache).
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
                                    n_bucket=n_bucket, rows=rows)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        out[i] = nxt
        done = done | (nxt == eos_id)
        mask_free(cache, act)
        tok = nxt[:, None]
        i += 1
    return out, i, cache
