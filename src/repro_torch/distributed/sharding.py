"""Sharding rules of the serving mesh: which dim of each cache leaf is
split by KV head.

The torch port of the serving half of ``repro/distributed/sharding.py``
(``spec_with_fallback``, ``cache_leaf_spec``, ``serving_cache_specs``).
A spec is a plain tuple with one entry per dim: a mesh axis name, a
tuple of names, or None (replicated). ``mesh`` is any object with
``.shape`` (axis name -> size) and ``.axis_names``, such as
``kernels.sharded.Mesh``.

The serving rule: compressed payloads, residual buffers and channel
permutations split their KV-head dim over ``kv`` (dim 0 of a pool-major
paged leaf, dim 1 of a dense one: the port keeps one cache a layer, where
the reference stacks a layer dim in front); the page ledger and the
per-row counters stay replicated. Every rule is divisibility-checked: a
dim that does not divide its axis, or an axis of size 1, stays
replicated.
"""
from __future__ import annotations

import math

from ..utils import tree_flatten_with_path


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    n = _axis_size(mesh, axes)
    return n > 1 and dim % n == 0


def spec_with_fallback(shape, want, mesh) -> tuple:
    """want: per-dim desired axes (str | tuple | None). Drops an axis that
    does not divide its dim or that an earlier dim already uses."""
    out = []
    used: set[str] = set()
    for dim, ax in zip(shape, want):
        if ax is None:
            out.append(None)
            continue
        axs = (ax,) if isinstance(ax, str) else tuple(ax)
        if any(a in used for a in axs) or not _fits(dim, mesh, axs):
            out.append(None)
            continue
        used.update(axs)
        out.append(ax if isinstance(ax, str) else axs)
    return tuple(out)


_CTX_LAST = {"payload", "mins", "shifts", "scale", "zero"}  # context dim last
# cache leaves whose dims carry a KV-head axis (serving lanes)
_HEAD_LEAVES = _CTX_LAST | {"raw_k", "raw_v", "resid_k", "resid_v", "chan_perm"}
# leaves stored pool-major when paged: [H_kv, pool_pages, ...] (no batch
# dim: the page table maps rows to pages)
_POOL_LEAVES = _CTX_LAST | {"raw_k", "raw_v"}
# the replicated page ledger and per-row counters: the host scheduler's
# one source of truth, identical in every lane by construction
_LEDGER = {"n_comp", "n_resid", "pos", "step", "page_table", "free",
           "n_free", "ref"}


def _head_dim(names, nd: int, n_lead: int, paged: bool) -> int | None:
    """The dim a cache leaf would split by KV head, before divisibility."""
    leaf_name = names[-1]
    if leaf_name in _LEDGER or leaf_name not in _HEAD_LEAVES:
        return None
    lead = min(n_lead, nd - 1)
    hd_dim = lead if paged and leaf_name in _POOL_LEAVES else lead + 1
    return hd_dim if hd_dim < nd else None


def cache_leaf_spec(names, shape, mesh, *, n_lead: int = 0,
                    head_axis: str | None = None, paged: bool = False) -> tuple:
    """One cache leaf's spec from its path ``names`` (ending in the leaf's
    field name) and ``shape``: the KV-head dim -> ``head_axis``, the ledger
    replicated. n_lead: stacked dims before the batch dim (0 for the port's
    per-layer caches); paged: the cache stores ``_POOL_LEAVES`` pool-major.
    """
    want: list = [None] * len(shape)
    d = _head_dim(names, len(shape), n_lead, paged)
    if head_axis is not None and d is not None:
        want[d] = head_axis
    return spec_with_fallback(shape, want, mesh)


def serving_cache_specs(cache, mesh, head_axis: str = "kv") -> dict:
    """Every leaf of one layer's ``LayerKVCache`` -> its serving spec, as
    {path: spec} in ``utils.tree_flatten`` order (a path is the tuple of
    field names and tier indices down to the leaf)."""
    n_lead = cache.n_comp.ndim - 1
    paged = cache.pages is not None
    return {path: cache_leaf_spec(path, leaf.shape, mesh, n_lead=n_lead,
                                  head_axis=head_axis, paged=paged)
            for path, leaf in tree_flatten_with_path(cache)[0]}


def head_dims(cache, mesh, head_axis: str = "kv", *,
              local: bool = False) -> list[int | None]:
    """The dim of each leaf (``utils.tree_flatten`` order) that
    ``head_axis`` splits, or None for a replicated leaf: the dims of
    ``serving_cache_specs``. ``local``: ``cache`` is one lane's head block,
    whose head dims are the full ones divided by the axis size."""
    n = _axis_size(mesh, head_axis)
    out = []
    for path, leaf in tree_flatten_with_path(cache)[0]:
        d = _head_dim(path, leaf.ndim, cache.n_comp.ndim - 1, cache.pages is not None)
        full = None if d is None else leaf.shape[d] * (n if local else 1)
        out.append(d if d is not None and _fits(full, mesh, head_axis) else None)
    return out
