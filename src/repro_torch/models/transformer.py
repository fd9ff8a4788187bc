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

On a serving mesh the cache is a ``kernels.sharded.MeshCache``: every
lane holds its own per-layer caches over its KV-head block. Projections,
norms, the MLP and the head still run once, on the controller, at the
single-device shapes; each lane does the cache writes and the decode
attention of its head block (``lane_lists``), and ``Lane.merge``
assembles the attention output. Every other attention (prefill, chunk,
prefix segment) runs at full heads on the controller, over context
gathered from the lanes, so its shapes are the single-device ones.

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
    merge_partials,
    packed_decode_attention,
    paged_decode_attention,
)
from ..kernels.ops import _residual_partials, compressed_partials
from ..kernels.sharded import (
    SINGLE,
    Lane,
    MeshCache,
    join_layers,
    lane_lists,
    split_layer,
)
from ..utils import div, round_up, tree_unbind
from .layers import (
    attention_norm_init,
    ctx_attention,
    dense_init,
    embed_tokens,
    enter,
    flash_attention,
    head_block,
    leave,
    logits_tp,
    mlp_apply,
    qkv_proj,
    reduce_from,
    resume_attention,
    rmsnorm,
    row_parallel,
    stream_param,
    to_stream,
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
FAMILIES = ("dense", "moe", "vlm", "encoder")  # the families of this module


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
               n_real: int | None = None, tp=None):
    """The MLP block's (output, aux loss) for hidden states ``h``
    (normalized by ``ln2`` first): SwiGLU and an aux of 0.0 (a Python
    number, so serving launches nothing for it), or the MoE routing only
    each batch row's first ``n_real`` positions (the rest are padding) and
    its load-balancing loss. Under ``tp`` (a ``ModelGroup``) the block
    reads the whole sequence and its output goes back onto the stream
    (``layers.enter`` / ``leave``)."""
    x = enter(rmsnorm(h, stream_param(p["ln2"], tp)), tp)
    if cfg.family == "moe":  # under tp every rank's output is whole
        out, aux = moe_apply(p["mlp"], x, cfg, n_real=n_real, site=site, tp=tp)
        return to_stream(out, tp), aux
    return leave(mlp_apply(p["mlp"], x, tp, cfg.d_ff), tp, h.dtype), 0.0


def _seq_len(cfg: ArchConfig, batch: dict) -> int:
    """Positions of a batch's hidden states (patches before tokens)."""
    if cfg.input_mode == "frames":
        return batch["frames"].shape[1]
    n = batch["tokens"].shape[1]
    return n + batch["patches"].shape[1] if cfg.input_mode == "tokens_patches" else n


def _embed_inputs(params: dict, cfg: ArchConfig, batch: dict, tp=None) -> torch.Tensor:
    """Hidden states [B, S, D] of a batch by its input mode: token
    embeddings, the frames themselves (audio stub), or the patch
    embeddings followed by the token embeddings (VLM stub). Under ``tp``
    the stream (``layers.to_stream``), from vocab-parallel embeddings."""
    if cfg.input_mode == "tokens":
        return leave(embed_tokens(params["embed"], batch["tokens"], cfg.vocab, tp), tp,
                     params["embed"].dtype)
    if cfg.input_mode == "frames":
        return to_stream(batch["frames"].to(torch.bfloat16), tp)
    if cfg.input_mode == "tokens_patches":
        tok = embed_tokens(params["embed"], batch["tokens"], cfg.vocab, tp)
        if tp is not None:
            tok = reduce_from(tok, tp)
        return to_stream(torch.cat([batch["patches"].to(tok.dtype), tok], dim=1), tp)
    raise ValueError(cfg.input_mode)


def _qkv(p: dict, h: torch.Tensor, cfg: ArchConfig, positions, tp=None):
    """One layer's q, k, v of the hidden states ``h`` (``layers.qkv_proj``
    with the config's heads, RoPE and qk-norm); under ``tp`` the heads of
    this rank's ``head_block`` over the whole sequence."""
    return qkv_proj(p["attn"], enter(rmsnorm(h, stream_param(p["ln1"], tp)), tp),
                    cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta,
                    qk_norm=cfg.qk_norm, use_rope=cfg.use_rope, tp=tp)


def _logits(params: dict, h: torch.Tensor, cfg: ArchConfig | None = None,
            tp=None) -> torch.Tensor:
    """Every position's logits: [B, S, D] -> f32 [B, S, V]; under ``tp``
    this rank's vocab slice (``layers.logits_tp``)."""
    hn = rmsnorm(h, stream_param(params["final_ln"], tp))
    return logits_tp(hn, params["head"], 0 if cfg is None else cfg.vocab, tp)


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Last position's logits: [B, S, D] -> f32 [B, V]."""
    return _logits(params, h[:, -1:])[:, 0]


def _block_train(cfg: ArchConfig, p: dict, h: torch.Tensor, positions, tp=None):
    """One layer of the training forward: (h, the MLP's aux loss). Under
    ``tp``: column-parallel q, k, v over this rank's heads, attention over
    them, the row-parallel ``wo`` and the MLP, each back onto the stream."""
    q, k, v = _qkv(p, h, cfg, positions, tp)
    attn = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    B, _, S, _ = attn.shape
    attn = attn.transpose(1, 2).reshape(B, S, -1)
    y_lo = 0 if tp is None else head_block(cfg.n_heads, cfg.n_kv_heads, tp)[0] * cfg.hd
    h = h + leave(row_parallel(attn.to(h.dtype), y_lo, p["attn"]["wo"],
                               cfg.n_heads * cfg.hd, tp), tp, h.dtype)
    m, aux = _apply_mlp(cfg, p, h, "train", tp=tp)
    return h + m, aux


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """Full-sequence forward -> (logits f32 [B, S, V], aux loss f32 []),
    the MoE aux summed over the layers and divided by ``n_layers``.

    Each layer runs under ``torch.utils.checkpoint`` (the reference's
    per-layer remat): the backward recomputes one layer's activations at a
    time. The stacked leaves are unbound once (``tree_unbind``), so their
    backward is one ``stack`` a leaf; a per-layer ``select`` would zero a
    whole stack's gradient once a layer.

    Under an active mesh whose 'model' axis is m > 1 (tensor parallelism,
    ``distributed.sharding.model_lanes``) ``params`` are this rank's
    blocks, the residual stream between layers is sharded by sequence
    over the 'model' ranks where m divides S (the reference's pin) and
    whole on every rank where it does not, and the logits are this rank's
    vocab slice [B, S, V_r] (``registry``'s loss reads them so)."""
    from ..distributed.sharding import model_lanes

    tp = model_lanes(_seq_len(cfg, batch))
    h = _embed_inputs(params, cfg, batch, tp)
    positions = torch.arange(_seq_len(cfg, batch), device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in tree_unbind(params["layers"]):
        h, a = checkpoint(_block_train, cfg, p, h, positions, tp, use_reentrant=False)
        aux = aux + a
    return _logits(params, h, cfg, tp), div(aux, cfg.n_layers)


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
                capacity: int, device="cuda", mesh=None):
    """One dense ``LayerKVCache`` per layer; on a ``mesh``, a ``MeshCache``
    whose lanes hold theirs over their head block, on their device."""
    def alloc(h_kv: int, dev):
        return [alloc_layer_cache(pack_cfg, batch, h_kv, cfg.hd, capacity,
                                  device=dev) for _ in range(cfg.n_layers)]

    if mesh is None:
        return alloc(cfg.n_kv_heads, device)
    return MeshCache(mesh, [alloc(lane.heads(cfg.n_kv_heads), lane.device)
                            for lane in mesh.lanes])


def _lane_rows(cfg: ArchConfig, pack_cfg: PackKVConfig, capacity: int,
               lanes: list[Lane]):
    """(rows, store): ``store(k, v)`` compresses one layer's K/V
    ([B, H_kv, S, hd]) into a fresh cache per lane, over the lane's head
    block on its device (``prefill_cache``), and appends it to the lane's
    list in ``rows``."""
    rows = [[] for _ in lanes]

    def store(k: torch.Tensor, v: torch.Tensor) -> None:
        for lane, out in zip(lanes, rows):
            kl, vl = lane.put(k), lane.put(v)
            layer = alloc_layer_cache(pack_cfg, k.shape[0], kl.shape[1], cfg.hd,
                                      capacity, device=kl.device)
            out.append(prefill_cache(layer, kl, vl))

    return rows, store


def _prefill_forward(params: dict, cfg: ArchConfig, batch: dict, store):
    """The prefill forward: every layer's K/V goes to ``store(k, v)`` as
    soon as the layer is done (compress-as-you-prefill). Returns the
    last-token logits f32 [B, V]."""
    h = _embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        attn = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
        attn = attn.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "prefill")[0]
        store(k, v)
    return _head(params, h)


def prefill(params: dict, cfg: ArchConfig, pack_cfg: PackKVConfig,
            capacity: int, batch: dict, mesh=None):
    """Process the prompt; returns (last-token logits f32 [B, V], cache; a
    ``MeshCache`` on a ``mesh``).

    batch["tokens"]: int [B, S] (a VLM's ``batch["patches"]``: [B, P, D],
    its positions before the tokens'). Every layer's K/V is compressed
    into its cache as soon as the layer is done (compress-as-you-prefill).
    """
    rows, store = _lane_rows(cfg, pack_cfg, capacity,
                             [SINGLE] if mesh is None else mesh.lanes)
    logits = _prefill_forward(params, cfg, batch, store)
    return logits, rows[0] if mesh is None else MeshCache(mesh, rows)


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
    sets = lane_lists(cache)
    rows, store = _lane_rows(cfg, pack_cfg, capacity, [lane for lane, _ in sets])
    logits = _prefill_forward(params, cfg, batch, store)
    for (_, layers), r in zip(sets, rows):
        _insert_rows(layers, slot, r, n_pages)
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
    sets = lane_lists(cache)
    rows, store = _lane_rows(cfg, pack_cfg, capacity, [lane for lane, _ in sets])
    for k, v in zip(scratch["k"], scratch["v"]):
        store(k, v)
    for (_, layers), r in zip(sets, rows):
        _insert_rows(layers, slot, r, n_pages)
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
    sets = lane_lists(mini)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        if n_ctx:
            # the context at full heads: dp row 0's head blocks, gathered
            ctx = [_segment_context(layers[i], pack_cfg, n_ctx) if lane.dp == 0
                   else (None, None) for lane, layers in sets]
            merge = lambda j: sets[0][0].merge(
                [None if c[j] is None else c[j].to(h.device) for c in ctx], 1)
            k_all = torch.cat([merge(0).to(torch.float32), k.to(torch.float32)], dim=2)
            v_all = torch.cat([merge(1).to(torch.float32), v.to(torch.float32)], dim=2)
        else:
            k_all, v_all = k, v
        attn = ctx_attention(q, k_all, v_all, n_ctx, sm_scale)
        attn = attn.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
        h = h + attn.to(h.dtype) @ p["attn"]["wo"]
        h = h + _apply_mlp(cfg, p, h, "segment")[0]
        for lane, layers in sets:
            prefill_append(layers[i], lane.put(k), lane.put(v), calibrate=n_ctx == 0)
    return _head(params, h), mini


def _segment_context(layer: LayerKVCache, pack_cfg: PackKVConfig, n_ctx: int):
    """A prefix segment's read-only context, the mini-cache's first
    ``n_ctx`` tokens as (K, V) [B, H_kv, n_ctx, hd]: raw (policy 'none') or
    dequantized."""
    if pack_cfg.policy == "none":
        return layer.raw_k[..., :n_ctx, :], layer.raw_v[..., :n_ctx, :]
    return tuple(dequantize_tiered(slice_tiered_prefix(tc, n_ctx)).transpose(-1, -2)
                 for tc in (layer.k, layer.v))


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
    mesh = cache.mesh if isinstance(cache, MeshCache) else None
    mini = alloc_cache(cfg, dense_cfg, 1, cap_mini, device, mesh)
    if n_prefix:
        for (lane, layers), (_, minis) in zip(lane_lists(cache), lane_lists(mini)):
            phys = prefix_phys.to(minis[0].n_comp.device)
            for i, (layer, m) in enumerate(zip(layers, minis)):
                seed_prefix_from_pages(layer, m, phys, n_prefix,
                                       None if k_perm is None else lane.put(k_perm[i], 0),
                                       None if v_perm is None else lane.put(v_perm[i], 0))
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
    for (_, layers), (_, minis) in zip(lane_lists(cache), lane_lists(mini)):
        phys = prefix_phys.to(layers[0].n_comp.device)
        for dst, src in zip(layers, minis):
            insert_row_paged(dst, slot, src, n_pages,
                             n_shared=n_prefix // pack_cfg.page_size,
                             shared_phys=phys)
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


def reset_cache_slot(cache, slot: int):
    """Free row ``slot`` of every layer (counters to zero; a paged row
    releases its pages), IN PLACE, in every lane."""
    for _, layers in lane_lists(cache):
        for layer in layers:
            reset_slot(layer, slot)
    return cache


def evacuate_cache_slot(cache, slot: int, n_pages: int = 0, n_shared: int = 0):
    """Swap row ``slot`` out of every layer (``core.cache.evacuate_row``):
    returns (the cache with the row freed IN PLACE, the per-layer dense
    B=1 minis). ``n_pages`` / ``n_shared``: the scheduler's host mirror
    of the row's live pages and its shared-prefix pages (paged only). On a
    mesh every lane evacuates its block and the minis are put back
    together at full heads on lane (0, 0)'s device: the single-device
    engine's minis, byte for byte."""
    if not isinstance(cache, MeshCache):
        return evacuate_row(cache, slot, n_pages, n_shared)
    minis = [evacuate_row(layers, slot, n_pages, n_shared)[1]
             for layers in cache.lanes]
    dev = cache.lanes[0][0].n_comp.device
    return cache, [join_layers([m[i] for m in minis[:cache.mesh.n_kv]],
                               cache.mesh, dev) for i in range(len(cache))]


def restore_cache_slot(cache, slot: int, mini, shared_phys,
                       n_pages: int = 0, n_shared: int = 0):
    """Stream evacuated minis back into row ``slot`` of every layer, IN
    PLACE (``core.cache.restore_row``): shared-prefix pages mapped by
    reference, the suffix scattered into fresh pages. Pure data movement:
    no forward pass. On a mesh each lane restores its head block of the
    full-head minis."""
    if not isinstance(cache, MeshCache):
        return restore_row(cache, slot, mini, shared_phys, n_pages, n_shared)
    for lane, layers in lane_lists(cache):
        restore_row(layers, slot, [split_layer(m, lane, cache.mesh) for m in mini],
                    shared_phys.to(lane.device), n_pages, n_shared)
    return cache


def mask_free(cache, active):
    """Zero the counters of inactive rows in every layer, IN PLACE, in
    every lane."""
    for _, layers in lane_lists(cache):
        act = torch.as_tensor(active, device=layers[0].n_comp.device)
        for layer in layers:
            mask_free_slots(layer, act)
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


def _layer_attention(cache, owned, i: int, q, k, v, append, sm_scale: float,
                     backend: str, n_bucket: int | None) -> torch.Tensor:
    """Layer ``i``'s cache write and decode attention over a window of w
    positions (w = 1: a decode step): ``append(layer, k, v)`` in every lane
    with its head block of k / v [B, H_kv, w, hd], then position j attends
    with j more residual tokens than the counter holds (``_attend``).
    q: [B, H, w, hd] -> f32 [B, H, w, hd] on q's device.

    On a mesh, with the kernels (policy packkv, backend fused), each lane
    launches K2 / K5 over its head block, reading only its ``owned`` rows
    (``Lane.mask_read``); the residual buffer's partials and the merge run
    at full heads on q's device over the residual gathered from the lanes,
    since PyTorch's reductions pick their launch layout by shape and would
    sum a head block in another order on the GPU. Without a kernel the
    whole attention runs at full heads over the layer put back together."""
    sets = lane_lists(cache)
    w = q.shape[2]
    layers = [append(ls[i], lane.put(k), lane.put(v)) for lane, ls in sets]
    plain = lambda layer: _stack([_attend(layer, q[:, :, j], sm_scale, backend,
                                          n_bucket, ahead=j) for j in range(w)])
    if len(sets) == 1:
        return plain(layers[0])
    mesh, dev, lane0 = cache.mesh, q.device, sets[0][0]
    row0 = layers[:mesh.n_kv]  # dp row 0: every row of every head block
    if row0[0].cfg.policy == "none" or backend != "fused":
        return plain(join_layers(row0, mesh, dev))
    rk, rv = (lane0.merge([getattr(x, name).to(dev) for x in row0], 1)
              for name in ("resid_k", "resid_v"))
    n_resid = row0[0].n_resid.to(dev)
    out = []
    for j in range(w):
        parts = [[x.to(dev) for x in compressed_partials(
                     lane.put(q[:, :, j]), lane.mask_read(layer, own), sm_scale,
                     n_bucket=n_bucket)]
                 for (lane, _), layer, own in zip(sets, layers, owned)]
        o, m, l = (lane0.merge([p[t] for p in parts], 1, rows=owned[0] is not None)
                   for t in range(3))
        out.append(merge_partials(o, m, l, *_residual_partials(
            q[:, :, j], rk, rv, n_resid + j if j else n_resid, sm_scale)))
    return _stack(out)


def _stack(outs: list[torch.Tensor]) -> torch.Tensor:
    """Per-position outputs [B, H, hd] -> [B, H, w, hd] (a view for w = 1)."""
    return outs[0][:, :, None] if len(outs) == 1 else torch.stack(outs, dim=2)


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
    # per-row positions; counters are identical in every layer and lane
    led = lane_lists(cache)[0][1][0]
    pos = (led.n_comp + led.n_resid).to(h.device)
    positions = pos[:, None, None]
    sm_scale = 1.0 / (cfg.hd ** 0.5)
    flush = flush_rows(led)  # one host read per step, not per layer
    owned = [lane.owned_rows(B) for lane, _ in lane_lists(cache)]
    append = lambda layer, k, v: append_token(layer, k, v, flush)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        attn = _layer_attention(cache, owned, i, q[:, :, :1], k[:, :, :1],
                                v[:, :, :1], append, sm_scale, backend, n_bucket)
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
    sets = lane_lists(cache)
    led = sets[0][1][0]
    pos = (led.n_comp + led.n_resid).to(h.device)  # pre-append totals
    positions = pos[:, None, None] + torch.arange(w, device=h.device)
    sm_scale = 1.0 / (cfg.hd ** 0.5)
    lens = lens.to(torch.int32)
    flush = flush_rows(led)
    owned = [lane.owned_rows(B) for lane, _ in sets]
    append = lambda layer, k, v: append_window(
        layer, k, v, lens.to(layer.n_comp.device), flush)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(p, h, cfg, positions)
        attn = _layer_attention(cache, owned, i, q, k, v, append, sm_scale,
                                backend, n_bucket)
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
    for _, layers in sets:
        acc = n_accept.to(layers[0].n_comp.device)
        for layer in layers:
            commit_window(layer, acc)
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
