"""Compression-policy registry: ``--policy`` strings -> PackKVConfig presets
(the torch port of ``repro/core/policy.py``)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from .cache import PackKVConfig

_REGISTRY: dict[str, Callable[[], PackKVConfig]] = {
    # uncompressed bf16 cache: the baseline
    "none": lambda: PackKVConfig(policy="none"),
    # integer quantization only (single 4-bit tier, no adaptive widths)
    "kivi": lambda: PackKVConfig(policy="kivi"),
    # full paper pipeline: token-wise quant + V-median repack + tiers
    "packkv": lambda: PackKVConfig(policy="packkv"),
    # near-lossless setting for fidelity-critical serving
    "packkv_tight": lambda: PackKVConfig(policy="packkv", k_rel_scale=0.02,
                                         v_rel_scale=0.02),
    # paper Table II/V turning point (max compression at ~5% drop)
    "packkv_aggressive": lambda: PackKVConfig(policy="packkv", k_rel_scale=0.2,
                                              v_rel_scale=0.3),
}


def get_policy(name: str, **overrides) -> PackKVConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
