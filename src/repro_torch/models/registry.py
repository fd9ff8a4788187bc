"""Model registry: one functional interface over the ported families.

The torch port of ``repro/models/registry.py``: the transformer API
serves the dense, moe, vlm and encoder families (the recurrent families
arrive with their ports). An encoder is run by ``transformer.encode``.

ModelApi:
  init(gen, cfg) -> params
  prefill(params, cfg, pack_cfg, capacity, batch) -> (last_logits, cache)
  decode_step(params, cfg, cache, token, backend=..., n_bucket=..., rows=...)
      -> (logits, cache)
  alloc_cache(cfg, pack_cfg, batch, capacity, device) -> cache
  prefill_into_slot(params, cfg, pack_cfg, capacity, cache, slot, batch)
      -> (last_logits [1, V], cache with row ``slot`` replaced)
  reset_slot(cache, slot) / mask_free(cache, active) -> cache
  decode_multi(params, cfg, cache, token, active, n_steps, eos_id,
               t_max=..., backend=..., n_bucket=..., rows=...)
      -> (tokens [t_max, B], n_exec, cache)
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
from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    prefill: Callable
    decode_step: Callable
    alloc_cache: Callable
    prefill_into_slot: Callable
    reset_slot: Callable
    mask_free: Callable
    decode_multi: Callable
    decode_verify: Callable | None
    prefill_chunk_init: Callable
    prefill_chunk: Callable
    prefill_chunk_insert: Callable
    prefill_prefix: Callable
    prefix_chunk_bounds: Callable
    prefix_chunk_init: Callable
    prefix_chunk: Callable
    prefix_chunk_insert: Callable
    evacuate_slot: Callable | None
    restore_slot: Callable | None
    supports_paged: bool


def _transformer_api() -> ModelApi:
    return ModelApi(
        init=transformer.init_params,
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


_FAMILIES = {family: _transformer_api for family in transformer.FAMILIES}


def get_model(cfg: ArchConfig) -> ModelApi:
    try:
        return _FAMILIES[cfg.family]()
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (see ROADMAP.md)"
        ) from None
