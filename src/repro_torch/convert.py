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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.cache import LayerKVCache, PackKVConfig, PagePool
from .core.tiered import TierBuffer, TierSpec, TieredCache


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array -> torch tensor (bf16 via its bits, uint32 as int32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's stacked params dict (numpy leaves) -> this
    package's params dict, same keys and layout."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else tensor_from_numpy(v, device)
                for k, v in t.items()}

    out = walk(tree)
    if out["layers"]["ln1"].shape[0] != cfg.n_layers:
        raise ValueError(f"params hold {out['layers']['ln1'].shape[0]} "
                         f"layers, config {cfg.name} has {cfg.n_layers}")
    return out


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
