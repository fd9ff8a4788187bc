"""Model registry: one functional interface over every family.

The torch port of ``repro/models/registry.py``: the transformer API
trains and serves the dense, moe, vlm and encoder families (an encoder
is run by ``transformer.encode``), ``rwkv6`` and ``rglru`` the two
recurrent ones.
The recurrent families' O(1) state has no pages, no verify pass and no
evacuate / restore ops: their ``decode_multi``, ``decode_verify``, prefix
ops, ``evacuate_slot`` and ``restore_slot`` are None and
``supports_paged`` is False, and the engine refuses the modes that need
them.

ModelApi:
  init(gen, cfg) -> params
  forward_train(params, cfg, batch) -> (logits f32 [B, S, V], aux loss)
  loss_fn(params, cfg, batch) -> scalar loss (mean cross-entropy on the
      labels, over a VLM's text positions only, + AUX_WEIGHT * aux)
  prefill(params, cfg, pack_cfg, capacity, batch) -> (last_logits, cache)
  decode_step(params, cfg, cache, token, backend=..., n_bucket=..., rows=...)
      -> (logits, cache)
  alloc_cache(cfg, pack_cfg, batch, capacity, device) -> cache
  prefill_into_slot(params, cfg, pack_cfg, capacity, cache, slot, batch)
      -> (last_logits [1, V], cache with row ``slot`` replaced)
  reset_slot(cache, slot) / mask_free(cache, active) -> cache
  decode_multi(params, cfg, cache, token, active, n_steps, eos_id,
               t_max=..., backend=..., n_bucket=..., rows=...)
      -> (tokens [t_max, B], n_exec, cache) (None: the engine decodes a
      step a launch)
  decode_verify(params, cfg, cache, tokens, lens, active, backend=...,
                n_bucket=...) -> (hat [B, w], n_accept [B], cache): one
      speculative verify pass over a window of w = tokens.shape[1]
      positions, accepted drafts committed (None: the family has none)
  prefill_chunk_init(cfg, pack_cfg, capacity, prompt_len=..., device=...)
      -> scratch
  prefill_chunk(params, cfg, pack_cfg, scratch, tokens, n_ctx=..., rows=...)
      -> (last_logits [1, V], scratch)
  prefill_chunk_insert(cfg, pack_cfg, capacity, cache, slot, scratch)
      -> cache with row ``slot`` replaced
  prefill_prefix(params, cfg, pack_cfg, capacity, cache, slot, batch,
                 prefix_phys, k_perm, v_perm, n_prefix=...)
      -> (last_logits [1, V], cache): a prefix-cache admission (paged)
  prefix_chunk_bounds(pack_cfg, prompt_len, n_prefix) -> segment bounds
  prefix_chunk_init(cfg, pack_cfg, capacity, cache, prefix_phys, k_perm,
                    v_perm, n_prefix=..., prompt_len=..., device=...) -> mini
  prefix_chunk(params, cfg, pack_cfg, mini, tokens, n_ctx=...)
      -> (last_logits [1, V], mini)
  prefix_chunk_insert(pack_cfg, cache, slot, mini, prefix_phys,
                      n_prefix=..., prompt_len=...) -> cache
  evacuate_slot(cache, slot, n_pages=..., n_shared=...) -> (cache, minis):
      swap a row out to dense B=1 minis, the row freed (preemption, sessions)
  restore_slot(cache, slot, minis, shared_phys, n_pages=..., n_shared=...)
      -> cache: stream evacuated minis back, no forward pass
  supports_paged: the decode state is page-addressable (paged storage)
Caches are updated in place and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ArchConfig
from . import rglru, rwkv6, transformer
from .layers import softmax_xent

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    forward_train: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    alloc_cache: Callable
    prefill_into_slot: Callable
    reset_slot: Callable
    mask_free: Callable
    prefill_chunk_init: Callable
    prefill_chunk: Callable
    prefill_chunk_insert: Callable
    decode_multi: Callable | None = None
    decode_verify: Callable | None = None
    prefill_prefix: Callable | None = None
    prefix_chunk_bounds: Callable | None = None
    prefix_chunk_init: Callable | None = None
    prefix_chunk: Callable | None = None
    prefix_chunk_insert: Callable | None = None
    evacuate_slot: Callable | None = None
    restore_slot: Callable | None = None
    supports_paged: bool = False


def _make_loss(forward_train):
    def loss_fn(params, cfg: ArchConfig, batch):
        logits, aux = forward_train(params, cfg, batch)
        if cfg.input_mode == "tokens_patches":
            logits = logits[:, cfg.n_patches:]  # loss on the text positions
        return softmax_xent(logits, batch["labels"]) + AUX_WEIGHT * aux

    return loss_fn


def _transformer_api() -> ModelApi:
    return ModelApi(
        init=transformer.init_params,
        forward_train=transformer.forward_train,
        loss_fn=_make_loss(transformer.forward_train),
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        alloc_cache=transformer.alloc_cache,
        prefill_into_slot=transformer.prefill_into_slot,
        reset_slot=transformer.reset_cache_slot,
        mask_free=transformer.mask_free,
        decode_multi=transformer.decode_steps,
        decode_verify=transformer.verify_steps,
        prefill_chunk_init=transformer.prefill_chunk_init,
        prefill_chunk=transformer.prefill_chunk,
        prefill_chunk_insert=transformer.prefill_chunk_insert,
        prefill_prefix=transformer.prefill_into_slot_prefix,
        prefix_chunk_bounds=transformer.prefix_chunk_bounds,
        prefix_chunk_init=transformer.prefix_chunk_init,
        prefix_chunk=transformer.prefix_chunk,
        prefix_chunk_insert=transformer.prefix_chunk_insert,
        evacuate_slot=transformer.evacuate_cache_slot,
        restore_slot=transformer.restore_cache_slot,
        supports_paged=True,
    )


def _rwkv_api() -> ModelApi:
    return ModelApi(
        init=rwkv6.init_params,
        forward_train=rwkv6.forward_train,
        loss_fn=_make_loss(rwkv6.forward_train),
        prefill=rwkv6.prefill,
        decode_step=rwkv6.decode_step,
        alloc_cache=lambda cfg, pack_cfg, batch, capacity, device="cuda":
            rwkv6.alloc_state(cfg, batch, device),
        prefill_into_slot=rwkv6.prefill_into_slot,
        reset_slot=rwkv6.reset_state_slot,
        mask_free=rwkv6.mask_free_rows,
        prefill_chunk_init=rwkv6.prefill_chunk_init,
        prefill_chunk=rwkv6.prefill_chunk,
        prefill_chunk_insert=rwkv6.prefill_chunk_insert,
    )


def _rglru_api() -> ModelApi:
    return ModelApi(
        init=rglru.init_params,
        forward_train=rglru.forward_train,
        loss_fn=_make_loss(rglru.forward_train),
        prefill=rglru.prefill,
        decode_step=rglru.decode_step,
        alloc_cache=lambda cfg, pack_cfg, batch, capacity, device="cuda":
            rglru.alloc_state(cfg, pack_cfg, batch, device),
        prefill_into_slot=rglru.prefill_into_slot,
        reset_slot=rglru.reset_state_slot,
        mask_free=rglru.mask_free_rows,
        prefill_chunk_init=rglru.prefill_chunk_init,
        prefill_chunk=rglru.prefill_chunk,
        prefill_chunk_insert=rglru.prefill_chunk_insert,
    )


_FAMILIES = {family: _transformer_api for family in transformer.FAMILIES}
_FAMILIES.update(rwkv6=_rwkv_api, hybrid_rglru=_rglru_api)


def get_model(cfg: ArchConfig) -> ModelApi:
    try:
        return _FAMILIES[cfg.family]()
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}") from None
