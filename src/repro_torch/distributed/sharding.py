"""Sharding rules: logical dims -> mesh axes, divisibility-checked (the
torch port of ``repro/distributed/sharding.py``).

A spec is a plain tuple with one entry per dim: a mesh axis name, a
tuple of names, or None (replicated). ``mesh`` is any object with
``.shape`` (axis name -> size) and ``.axis_names``: ``launch.mesh.TrainMesh``,
``kernels.sharded.Mesh`` or a duck-typed stand-in. The rules read only
shapes, so a leaf is anything with ``.shape`` and ``.ndim``.

Training (``param_specs``, ``opt_state_specs``, ``batch_specs``,
``cache_specs``):

  * batch -> ('pod', 'data'): data parallelism; a batch that does not
    divide is replicated;
  * heads / d_ff / vocab / experts / LRU width -> 'model' (tensor and
    expert parallelism; qwen2-moe's 60 experts fall back to the Fe dim);
  * a cache's compressed-context dim -> 'model' (context parallelism);
  * optimizer moments -> additionally 'data' on the first free dim that
    divides (ZeRO-1).

Serving (``serving_cache_specs``, ``head_dims``): compressed payloads,
residual buffers and channel permutations split their KV-head dim over
``kv`` (dim 0 of a pool-major paged leaf, dim 1 of a dense one: the port
keeps one cache a layer, where the reference stacks a layer dim in
front); the page ledger and the per-row counters stay replicated.

Every rule is divisibility-checked: a dim that does not divide its axis,
or an axis of size 1, stays replicated, so every (config, mesh) pair has
specs. The port runs every axis for real, one ``torch.distributed`` rank
a device (``training/train.py``). The reference's ``to_named`` (an XLA
``NamedSharding``) has no counterpart: a rank's tensors are its local
blocks. ``shard_tree`` cuts a full tree to this rank's blocks by a spec
tree and ``gather_tree`` makes the blocks whole again (checkpoints hold
full arrays). A rank stores a leaf by ``storage_specs``: the rule's spec,
except that MoE experts the rule splits by expert (E over 'model') are
stored split by their Fe dim instead, at the same bytes a rank, because
the expert FFN computes over Fe slices (``models/moe.py::moe_apply``).
"""
from __future__ import annotations

import math
import re

import torch

from ..utils import TreeDef, tree_flatten, tree_flatten_with_path

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


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
    does not divide its dim or that an earlier dim already uses. A tuple
    of one axis comes out as its name, as a ``PartitionSpec`` holds it."""
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
        out.append(axs[0] if len(axs) == 1 else axs)
    return tuple(out)


def spec_leaves(specs, treedef: TreeDef) -> list:
    """The specs of a spec tree (shaped as the tree ``treedef`` describes,
    a spec tuple at each leaf) in ``utils.tree_flatten`` leaf order. A
    spec is a tuple, so a spec tree cannot be flattened on its own."""
    out: list = []

    def walk(node, x):
        kind = node[0]
        if kind == "*":
            out.append(x)
        elif kind in ("list", "tuple"):
            for c, v in zip(node[1], x):
                walk(c, v)
        elif kind == "dict":
            for k, c in zip(node[1], node[2]):
                walk(c, x[k])
        elif kind != "None":
            for name, c in node[3]:
                walk(c, getattr(x, name))

    walk(treedef.node, specs)
    return out


# ---------------------------------------------------------------------------
# parameter rules (matched on the last path component's name)
# ---------------------------------------------------------------------------

# each entry: per-dim preferred axes of the leaf's TRAILING dims; leading
# (stacked-layer) dims are padded with None
_PARAM_RULES: list[tuple[str, tuple | None]] = [
    (r"^embed$", ("model", None)),
    (r"^head$", (None, "model")),
    (r"^(wq|wk|wv|wg|wr|w_in|w_gate_branch)$", (None, "model")),
    (r"^(wo|w_out)$", ("model", None)),
    (r"^(w_gate|w_up)$", (None, "model")),       # dense mlp [D, F]
    (r"^(w_down)$", ("model", None)),            # dense mlp [F, D]
    (r"^cm_wk$", (None, "model")),
    (r"^cm_wv$", ("model", None)),
    (r"^cm_wr$", (None, "model")),
    (r"^(lru_wa|lru_wx)$", (None, "model")),
    (r"^conv_w$", (None, "model")),
    (r"^router$", (None, None)),
    (r"^(wA|wB|mu|u|w0|lru_lambda)$", None),     # small / odd leaves replicated
    (r"(ln|norm)", None),                        # every norm replicated
]

# MoE expert tensors are [E, D, Fe] / [E, Fe, D]: the experts axis first,
# the Fe axis when E does not divide (qwen2-moe's E = 60). The reference
# keeps these rules beside _PARAM_RULES; its _match_param reaches the
# expert layout through the stacked-dim test below.
_MOE_RULES: list[tuple[str, tuple]] = [
    (r"^(w_gate|w_up)$", ("model", None, ("model",))),
    (r"^w_down$", ("model", ("model",), None)),
]


def _match_param(names: list[str], ndim: int, mesh, shape) -> tuple:
    leaf = names[-1]
    for pat, want in _PARAM_RULES:
        if re.search(pat, leaf):
            if want is None:
                return (None,) * ndim
            if len(want) < ndim:
                full = (None,) * (ndim - len(want)) + tuple(want)
            else:
                full = tuple(want[-ndim:])
            # experts are [E, D, Fe] unstacked (ndim 3, not under a stacked
            # 'layers') or [L, E, D, Fe] stacked; a stacked dense mlp is
            # [L, D, F] under 'layers', whose layer dim must stay whole
            is_expert = ndim >= 4 or (ndim == 3 and "layers" not in names)
            if (leaf in ("w_gate", "w_up", "w_down") and is_expert
                    and len(want) == 2 and _fits(shape[-3], mesh, "model")
                    and not any(isinstance(a, str) for a in full[:-2])):
                # the expert dim takes 'model'; the trailing dims drop it
                full = ((None,) * (ndim - 3) + ("model",)
                        + tuple(None if a == "model" else a for a in want))
            return spec_with_fallback(shape, full, mesh)
    return (None,) * ndim


def param_specs(params, mesh):
    """A tree of specs shaped as ``params``."""
    leaves, treedef = tree_flatten_with_path(params)
    return treedef.unflatten([_match_param(list(path), leaf.ndim, mesh, leaf.shape)
                              for path, leaf in leaves])


def opt_state_specs(params, mesh):
    """ZeRO-1: a moment takes its parameter's spec plus 'data' on the
    first free dim that divides it. Returns an ``OptState`` of specs."""
    from ..training.optimizer import OptState

    leaves, treedef = tree_flatten(params)
    moments = []
    for leaf, spec in zip(leaves, spec_leaves(param_specs(params, mesh), treedef)):
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        if "data" in mesh.axis_names:
            for i, (dim, ax) in enumerate(zip(leaf.shape, parts)):
                if ax is None and _fits(dim, mesh, "data"):
                    parts[i] = "data"
                    break
        moments.append(tuple(parts))
    moments = treedef.unflatten(moments)
    return OptState(mu=moments, nu=moments, step=())


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def batch_specs(batch: dict, mesh) -> dict:
    """Every leaf's rows -> the data-parallel axes (replicated when the
    batch does not divide them)."""
    dp = dp_axes(mesh)
    return {k: spec_with_fallback(v.shape, [dp] + [None] * (v.ndim - 1), mesh)
            for k, v in batch.items()}


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


def _lead(names, nd: int, n_lead: int) -> int:
    """Stacked dims before a cache leaf's batch dim: ``n_lead``, one more
    under a recurrent block ('rec' / 'tail'), one for the hybrid's tail
    state."""
    if names[-1] in ("tail_lru_h", "tail_conv"):
        return 1
    return min(n_lead + (1 if "rec" in names or "tail" in names else 0), nd - 1)


def _head_dim(names, nd: int, n_lead: int, paged: bool) -> int | None:
    """The dim a cache leaf would split by KV head, before divisibility."""
    leaf_name = names[-1]
    if leaf_name in _LEDGER or leaf_name not in _HEAD_LEAVES:
        return None
    lead = _lead(names, nd, n_lead)
    hd_dim = lead if paged and leaf_name in _POOL_LEAVES else lead + 1
    return hd_dim if hd_dim < nd else None


def cache_leaf_spec(names, shape, mesh, *, n_lead: int = 0, dp=(),
                    ctx_axis: str | None = None, head_axis: str | None = None,
                    paged: bool = False) -> tuple:
    """One cache leaf's spec from its path ``names`` (ending in the leaf's
    field name) and ``shape``, shared by training (``cache_specs``: batch
    -> ``dp``, compressed context -> ``ctx_axis``) and serving
    (``serving_cache_specs``: KV head -> ``head_axis``); the ledger stays
    replicated. n_lead: stacked dims before the batch dim (0 for the
    port's per-layer caches); paged: the cache stores ``_POOL_LEAVES``
    pool-major."""
    leaf_name = names[-1]
    nd = len(shape)
    want: list = [None] * nd
    if leaf_name in _LEDGER:
        return tuple(want)
    lead = _lead(names, nd, n_lead)
    pool = paged and leaf_name in _POOL_LEAVES
    if dp and nd > lead and not pool:
        want[lead] = dp  # batch dim
    d = _head_dim(names, nd, n_lead, paged)
    if head_axis is not None and d is not None:
        want[d] = head_axis
    if ctx_axis is not None:
        if leaf_name in _CTX_LAST and nd >= lead + 2:
            want[-1] = ctx_axis
        elif leaf_name in ("raw_k", "raw_v") and nd >= lead + 3:
            want[-2] = ctx_axis
        elif leaf_name == "S" and nd >= lead + 3:
            want[lead + 1] = ctx_axis  # rwkv heads
        elif leaf_name == "lru_h" and nd >= lead + 2:
            want[-1] = ctx_axis  # lru width
        elif leaf_name == "conv" and nd >= lead + 3:
            want[-1] = ctx_axis
    return spec_with_fallback(shape, want, mesh)


def cache_specs(cache, mesh, n_lead: int = 0) -> dict:
    """Decode-cache specs (training): the batch dim -> the data-parallel
    axes, the compressed-context dim -> 'model' (context parallelism); the
    residual and raw context stay local. {path: spec} in
    ``utils.tree_flatten`` order; n_lead: stacked dims before the batch
    dim (the port's caches are one a layer: 0)."""
    dp = dp_axes(mesh)
    return {path: cache_leaf_spec(path, leaf.shape, mesh, n_lead=n_lead, dp=dp,
                                  ctx_axis="model")
            for path, leaf in tree_flatten_with_path(cache)[0]}


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


# ---------------------------------------------------------------------------
# the active mesh and in-graph constraints
# ---------------------------------------------------------------------------

_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    """Make ``mesh`` the one the training step and ``constrain`` read
    (None: single device). A launcher resets it when it is done."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


def constrain(x, *axes):
    """The reference pins activations by axis names ('batch' -> the
    data-parallel axes) through ``with_sharding_constraint``. Here the
    spec is computed (divisibility-checked, so a bad name still raises)
    and ``x`` itself is returned, under a 'model' axis too: a rank's
    tensors are already its local block, and the sequence pin of the
    residual stream is made explicit in the layers, by the exchanges of
    ``distributed.exchange`` (``model_lanes`` gives the forwards their
    'model' line and says whether the stream is sequence-sharded)."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    dp = dp_axes(mesh)
    spec_with_fallback(x.shape, [dp if a == "batch" else a for a in axes], mesh)
    return x


def model_lanes(seq_len: int):
    """The active mesh's 'model' line of ranks for a forward over
    ``seq_len`` positions (an ``exchange.ModelGroup``), or None when no
    mesh is active or its 'model' axis is 1. A 'model' axis above 1 needs
    a mesh of ranks (``launch.mesh.TrainMesh``)."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    if not hasattr(mesh, "model_lanes"):
        raise TypeError("a 'model' axis above 1 is tensor parallelism over ranks: "
                        "activate a launch.mesh.TrainMesh, not a mesh of axis sizes")
    return mesh.model_lanes(seq_len)


# ---------------------------------------------------------------------------
# a rank's blocks of a tree
# ---------------------------------------------------------------------------

_EXPERT_FE = {"w_gate": -1, "w_up": -1, "w_down": -2}  # the Fe dim of an expert leaf


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _storage_spec(names, spec: tuple) -> tuple:
    """An expert leaf ([.., E, D, Fe] / [.., E, Fe, D], outside the shared
    experts) whose spec puts 'model' on E is stored split by Fe; 'data'
    (a ZeRO-1 moment's) stays where it was, inside 'model' on a shared
    dim."""
    fe = _EXPERT_FE.get(names[-1])
    if fe is None or "shared" in names or len(spec) < 3 or "model" not in _axes(spec[-3]):
        return spec
    out = list(spec)
    e_axes = tuple(a for a in _axes(out[-3]) if a != "model")
    out[-3] = (e_axes[0] if len(e_axes) == 1 else e_axes) or None
    fe_axes = ("model",) + _axes(out[fe])
    out[fe] = fe_axes[0] if len(fe_axes) == 1 else fe_axes
    return tuple(out)


def storage_specs(tree, mesh, specs=None):
    """How a rank stores each leaf of ``tree`` (a parameter tree, or a
    moment tree shaped as one): ``specs`` (default ``param_specs(tree,
    mesh)``; for moments, ``opt_state_specs(...).mu``) with the experts'
    Fe override (module docstring)."""
    leaves, treedef = tree_flatten_with_path(tree)
    specs = param_specs(tree, mesh) if specs is None else specs
    flat = spec_leaves(specs, tree_flatten(tree)[1])
    return treedef.unflatten([_storage_spec(path, spec)
                              for (path, _), spec in zip(leaves, flat)])


def _index(mesh, axes) -> tuple[int, int]:
    """(this rank's block index, the block count) over ``axes``,
    row-major."""
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
    return idx, n


def shard_tree(tree, specs, mesh):
    """Every leaf cut to this rank's block by its spec (``specs`` shaped
    as ``tree``): contiguous copies; a replicated leaf is returned as it
    is."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for x, spec in zip(leaves, spec_leaves(specs, treedef)):
        for d, entry in enumerate(spec):
            i, n = _index(mesh, _axes(entry))
            if n > 1:
                if x.shape[d] % n:
                    raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                                     f"over {n} ranks ({entry})")
                x = x.narrow(d, i * (x.shape[d] // n), x.shape[d] // n).contiguous()
        out.append(x)
    return treedef.unflatten(out)


def _group_of(mesh, axis: str):
    if axis == "model":
        return mesh.model_group, mesh.model_size
    if axis == "data":
        return mesh.data_group, mesh.data_size
    raise ValueError(f"no gather over axis {axis!r}")


def gather_tree(tree, specs, mesh):
    """``shard_tree``'s inverse: every rank's blocks of each leaf gathered
    whole (every rank of the mesh takes part, in the same leaf order)."""
    from .exchange import all_gather

    leaves, treedef = tree_flatten(tree)
    out = []
    for x, spec in zip(leaves, spec_leaves(specs, treedef)):
        for d, entry in enumerate(spec):
            for a in reversed(_axes(entry)):  # the inner axis first
                group, n = _group_of(mesh, a)
                if n > 1:
                    x = torch.cat(all_gather(x, group, n), dim=d)
        out.append(x)
    return treedef.unflatten(out)


def train_state_specs(params, mesh, zero: bool = True):
    """How a rank stores the training state (params, ``OptState``) of the
    full ``params``: the parameters by ``storage_specs``, the moments by
    the ZeRO-1 specs of ``opt_state_specs`` (``zero``) or as the
    parameters. ``shard_tree`` / ``gather_tree`` of the state read it."""
    from ..training.optimizer import OptState

    store = storage_specs(params, mesh)
    mom = storage_specs(params, mesh, opt_state_specs(params, mesh).mu) if zero else store
    return (store, OptState(mu=mom, nu=mom, step=()))
