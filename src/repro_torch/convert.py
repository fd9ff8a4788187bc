"""Carry weights and cache state between numpy and this package.

Arrays come in as numpy (the reference package's arrays pass through
``np.asarray``), so this module imports neither JAX nor the reference:

  * bfloat16 arrives as ``ml_dtypes.bfloat16`` numpy arrays, which
    ``torch.from_numpy`` rejects; they cross as their uint16 bits;
  * uint32 payload words cross as int32 with the same bits (PyTorch
    cannot shift uint32; see ``core/tiered.py``).

A dense ``LayerKVCache`` is given as a nested dict of arrays::

  {"k": {"tiers": [{"payload", "mins", "shifts"}, ...],
         "chan_perm", "scale", "zero"} or None,
   "v": (same) or None,
   "raw_k", "raw_v" (None unless policy 'none'),
   "resid_k", "resid_v", "n_comp", "n_resid",
   "pages": {"page_table", "free", "n_free", "ref"} or None}

with the K and V ``TierSpec``s as (widths, counts, pack_size) tuples. A
paged cache (``pages`` given, ``cfg.paged``) holds pool-layout leaves.

The storage tier crosses as the reference's objects (``PackedBlock``,
``CompressedKVStream`` and its entries: numpy fields read by name) or as
the dicts ``packed_block_to_numpy`` / ``stream_to_numpy`` give, with the
same field names; payload words go uint32 <-> int32 bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.bitpack import PackedBlock
from .core.block_format import BlockEntry, CompressedKVStream
from .core.cache import LayerKVCache, PackKVConfig, PagePool
from .core.quantization import QuantConfig
from .core.tiered import TierBuffer, TierSpec, TieredCache
from .models.transformer import FAMILIES
from .training.optimizer import OptState


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array -> torch tensor (bf16 via its bits, uint32 as int32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)  # keeps 0-d


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's stacked params dict (numpy leaves) -> this
    package's params dict, same keys, layout and dtypes (``q_norm`` /
    ``k_norm`` ``[L, hd]`` among the attention leaves when
    ``cfg.qk_norm``; an MoE MLP's f32 router and its nested ``shared``
    dict; no embedding for frame inputs; rwkv6's f32 decay LoRA and
    bonus ``u``; a hybrid model's ``groups`` / ``tail`` (None without
    trailing blocks) with the f32 LRU leaves)."""
    if cfg.family not in FAMILIES + ("rwkv6", "hybrid_rglru"):
        raise ValueError(f"unknown family {cfg.family!r}")

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                None if v is None else tensor_from_numpy(v, device)
                for k, v in t.items()}

    out = walk(tree)
    if ("groups" in out) != (cfg.family == "hybrid_rglru") or \
            ("u" in out.get("layers", {})) != (cfg.family == "rwkv6"):
        raise ValueError(f"config {cfg.name} is family {cfg.family!r}, the "
                         "params' layout disagrees")
    if cfg.family == "rwkv6":
        if out["layers"]["wr"].shape[0] != cfg.n_layers:
            raise ValueError(f"params hold {out['layers']['wr'].shape[0]} "
                             f"layers, config {cfg.name} has {cfg.n_layers}")
        return out
    if cfg.family == "hybrid_rglru":
        n_groups, n_tail = divmod(cfg.n_layers, 3)
        tail = out.get("tail")
        got = (out["groups"]["attn"]["ln"].shape[0],
               0 if tail is None else tail["ln"].shape[0])
        if got != (n_groups, n_tail):
            raise ValueError(f"params hold {got} (groups, tail blocks), config "
                             f"{cfg.name} has {(n_groups, n_tail)}")
        return out
    if out["layers"]["ln1"].shape[0] != cfg.n_layers:
        raise ValueError(f"params hold {out['layers']['ln1'].shape[0]} "
                         f"layers, config {cfg.name} has {cfg.n_layers}")
    if ("q_norm" in out["layers"]["attn"]) != cfg.qk_norm:
        raise ValueError(f"config {cfg.name} has qk_norm={cfg.qk_norm}, the "
                         "params' attention leaves disagree")
    if ("router" in out["layers"]["mlp"]) != (cfg.family == "moe"):
        raise ValueError(f"config {cfg.name} is family {cfg.family!r}, the "
                         "params' MLP leaves disagree")
    if ("embed" in out) != (cfg.input_mode != "frames"):
        raise ValueError(f"config {cfg.name} takes input_mode "
                         f"{cfg.input_mode!r}, the params' embedding disagrees")
    return out


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_numpy``: this package's params (or any
    nested dict of tensors, None kept) as numpy, bf16 as
    ``tensor_to_numpy`` gives it."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else
            None if v is None else tensor_to_numpy(v) for k, v in params.items()}


def opt_state_from_numpy(mu: dict, nu: dict, step, cfg: ArchConfig,
                         device="cuda") -> OptState:
    """The reference's ``OptState`` (its ``mu`` and ``nu`` trees and its
    ``step`` as numpy) -> this package's, through ``params_from_numpy``."""
    return OptState(mu=params_from_numpy(mu, cfg, device),
                    nu=params_from_numpy(nu, cfg, device),
                    step=tensor_from_numpy(np.asarray(step, np.int32), device))


def _tiered_from_numpy(d: dict, spec: TierSpec, device) -> TieredCache:
    tiers = tuple(
        TierBuffer(payload=tensor_from_numpy(t["payload"], device),
                   mins=tensor_from_numpy(t["mins"], device),
                   shifts=tensor_from_numpy(t["shifts"], device),
                   width=w, pack_size=spec.pack_size)
        for t, w in zip(d["tiers"], spec.widths)
    )
    return TieredCache(tiers=tiers,
                       chan_perm=tensor_from_numpy(d["chan_perm"], device),
                       scale=tensor_from_numpy(d["scale"], device),
                       zero=tensor_from_numpy(d["zero"], device), spec=spec)


def layer_cache_from_numpy(arrays: dict, cfg: PackKVConfig, k_spec=None,
                           v_spec=None, device="cuda") -> LayerKVCache:
    """A ``LayerKVCache`` from plain arrays (layout in the module
    docstring). ``k_spec``/``v_spec``: (widths, counts, pack_size) tuples,
    required unless the policy is 'none'; they become the config's static
    specs so the cache and its config agree."""
    get = lambda key: None if arrays.get(key) is None else \
        tensor_from_numpy(arrays[key], device)
    k = v = None
    if cfg.policy != "none":
        ks, vs = TierSpec(*map(_tuple, k_spec)), TierSpec(*map(_tuple, v_spec))
        cfg = dataclasses.replace(cfg, k_spec_static=ks, v_spec_static=vs)
        k = _tiered_from_numpy(arrays["k"], ks, device)
        v = _tiered_from_numpy(arrays["v"], vs, device)
    pages = None
    if arrays.get("pages") is not None:
        pages = PagePool(page_size=cfg.page_size, **{
            key: tensor_from_numpy(a, device) for key, a in arrays["pages"].items()})
    return LayerKVCache(k=k, v=v, raw_k=get("raw_k"), raw_v=get("raw_v"),
                        resid_k=get("resid_k"), resid_v=get("resid_v"),
                        n_comp=get("n_comp"), n_resid=get("n_resid"), cfg=cfg,
                        pages=pages)


def _tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy (bf16 as ``ml_dtypes.bfloat16`` when that is
    installed, else its uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()


def layer_cache_to_numpy(cache: LayerKVCache) -> dict:
    """The inverse of ``layer_cache_from_numpy``'s array dict (payload
    words as uint32)."""
    def tiered(tc: TieredCache | None):
        if tc is None:
            return None
        return {"tiers": [{"payload": tensor_to_numpy(t.payload).view(np.uint32),
                           "mins": tensor_to_numpy(t.mins),
                           "shifts": tensor_to_numpy(t.shifts)}
                          for t in tc.tiers],
                "chan_perm": tensor_to_numpy(tc.chan_perm),
                "scale": tensor_to_numpy(tc.scale),
                "zero": tensor_to_numpy(tc.zero)}

    opt = lambda t: None if t is None else tensor_to_numpy(t)
    return {"k": tiered(cache.k), "v": tiered(cache.v),
            "raw_k": opt(cache.raw_k), "raw_v": opt(cache.raw_v),
            "resid_k": tensor_to_numpy(cache.resid_k),
            "resid_v": tensor_to_numpy(cache.resid_v),
            "n_comp": tensor_to_numpy(cache.n_comp),
            "n_resid": tensor_to_numpy(cache.n_resid),
            "pages": None if cache.pages is None else {
                key: tensor_to_numpy(getattr(cache.pages, key))
                for key in ("page_table", "free", "n_free", "ref")}}


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def packed_block_from_numpy(blk, device="cuda") -> PackedBlock:
    """A reference ``PackedBlock`` (or its dict) -> this package's."""
    get = lambda name: tensor_from_numpy(_field(blk, name), device)
    return PackedBlock(payload=get("payload"), widths=get("widths"), mins=get("mins"),
                       pack_size=int(_field(blk, "pack_size")),
                       shape=tuple(int(x) for x in _field(blk, "shape")),
                       payload_bits=int(_field(blk, "payload_bits")))


def packed_block_to_numpy(blk: PackedBlock) -> dict:
    """The reference's ``PackedBlock`` fields as numpy (payload uint32)."""
    return {"payload": tensor_to_numpy(blk.payload).view(np.uint32),
            "widths": tensor_to_numpy(blk.widths), "mins": tensor_to_numpy(blk.mins),
            "pack_size": blk.pack_size, "shape": tuple(blk.shape),
            "payload_bits": blk.payload_bits}


def _quant_config(q) -> QuantConfig:
    return QuantConfig(**{f.name: _field(q, f.name)
                          for f in dataclasses.fields(QuantConfig)})


def stream_from_numpy(s, device="cuda") -> CompressedKVStream:
    """A reference ``CompressedKVStream`` (or its dict) -> this package's."""
    entries = [BlockEntry(
        head=int(_field(e, "head")), token_start=int(_field(e, "token_start")),
        n_tokens=int(_field(e, "n_tokens")),
        perm=tensor_from_numpy(_field(e, "perm"), device),
        k_block=packed_block_from_numpy(_field(e, "k_block"), device),
        v_block=packed_block_from_numpy(_field(e, "v_block"), device),
        k_meta=tensor_from_numpy(_field(e, "k_meta"), device),
        v_meta=tensor_from_numpy(_field(e, "v_meta"), device))
        for e in _field(s, "entries")]
    return CompressedKVStream(pack_size=int(_field(s, "pack_size")),
                              repack_mode=_field(s, "repack_mode"),
                              k_quant=_quant_config(_field(s, "k_quant")),
                              v_quant=_quant_config(_field(s, "v_quant")),
                              entries=entries)


def stream_to_numpy(s: CompressedKVStream) -> dict:
    """The reference's ``CompressedKVStream`` fields as numpy dicts."""
    return {"pack_size": s.pack_size, "repack_mode": s.repack_mode,
            "k_quant": dataclasses.asdict(s.k_quant),
            "v_quant": dataclasses.asdict(s.v_quant),
            "entries": [{"head": e.head, "token_start": e.token_start,
                         "n_tokens": e.n_tokens, "perm": tensor_to_numpy(e.perm),
                         "k_block": packed_block_to_numpy(e.k_block),
                         "v_block": packed_block_to_numpy(e.v_block),
                         "k_meta": tensor_to_numpy(e.k_meta),
                         "v_meta": tensor_to_numpy(e.v_meta)} for e in s.entries]}
