"""Model registry: one functional interface over the ported families.

The torch port of ``repro/models/registry.py``, dense transformer family
only (the others arrive with their ports).

ModelApi:
  init(gen, cfg) -> params
  prefill(params, cfg, pack_cfg, capacity, batch) -> (last_logits, cache)
  decode_step(params, cfg, cache, token, backend=..., n_bucket=...)
      -> (logits, cache)
  alloc_cache(cfg, pack_cfg, batch, capacity, device) -> cache
  prefill_into_slot(params, cfg, pack_cfg, capacity, cache, slot, batch)
      -> (last_logits [1, V], cache with row ``slot`` replaced)
  reset_slot(cache, slot) / mask_free(cache, active) -> cache
  decode_multi(params, cfg, cache, token, active, n_steps, eos_id,
               t_max=..., backend=..., n_bucket=...)
      -> (tokens [t_max, B], n_exec, cache)
  prefill_chunk_init(cfg, pack_cfg, capacity, prompt_len=..., device=...)
      -> scratch
  prefill_chunk(params, cfg, pack_cfg, scratch, tokens, n_ctx=...)
      -> (last_logits [1, V], scratch)
  prefill_chunk_insert(cfg, pack_cfg, capacity, cache, slot, scratch)
      -> cache with row ``slot`` replaced
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
    prefill_chunk_init: Callable
    prefill_chunk: Callable
    prefill_chunk_insert: Callable
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
        prefill_chunk_init=transformer.prefill_chunk_init,
        prefill_chunk=transformer.prefill_chunk,
        prefill_chunk_insert=transformer.prefill_chunk_insert,
        supports_paged=True,
    )


_FAMILIES = {"dense": _transformer_api}


def get_model(cfg: ArchConfig) -> ModelApi:
    try:
        return _FAMILIES[cfg.family]()
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (see ROADMAP.md)"
        ) from None
