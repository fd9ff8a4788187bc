"""Train step: loss and gradients, microbatch accumulation, AdamW, and
data parallelism over ``torch.distributed`` ranks (the torch port of
``repro/training/train.py``).

``make_train_step(api, cfg, opt_cfg, grad_accum)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.
A batch carries the global batch dim; at ``grad_accum`` > 1 it is split
into that many contiguous row blocks (``_split_micro``), run one after
another, their gradients added in order into an f32 accumulator and their
losses summed, then both divided by ``grad_accum`` (activation memory /
grad_accum, the same math). The update is in place (``adamw_update``).

Under an active mesh (``distributed.sharding.set_active_mesh``, a
``launch.mesh.TrainMesh``) whose 'pod' x 'data' axes hold n > 1 ranks,
each rank runs the step on its contiguous row block of the global batch
(``batch_specs``; rank order is row-major over the axes), summing its
``grad_accum`` microbatches undivided. The ranks' sums and losses are
then gathered in slices of ``CHUNK`` values and added in rank order into
f32 buffers that start at zero, and divided once by n * grad_accum:
exactly the single process's accumulator at grad_accum = n, so a
``data = n`` step equals the ``grad_accum = n`` step bitwise. (An
all-reduce would add in an order of the backend's choosing.) A batch
that does not divide the axes is replicated: every rank runs all of it
and nothing is exchanged.

``accum_pspecs`` (the ZeRO-1 moment specs of ``opt_state_specs``): each
rank holds only its 'data' slice of ``mu`` / ``nu`` (the moments of
``sharding.train_state_specs``, cut by ``shard_tree`` and made whole again
by ``gather_tree``), updates that slice of the parameters with the global
norm of the full reduced gradients, and gathers the parameters. The
update is elementwise, so this equals the replicated update bitwise.

Tensor parallelism: under a mesh whose 'model' axis is m > 1, ``params``
are this rank's blocks (``sharding.train_state_specs``: each leaf the
rule splits over 'model' is held as 1/m of it) and the forwards split their
work over the rank's 'model' line (``models/layers.py``), so a rank's
gradients are its blocks' gradients: holding them is the reference's
``param_pspecs`` pin, which is accepted. The ranks that share a 'model'
coordinate add their gradients as above; the global norm adds each
sharded leaf's sum of squares over the 'model' line in rank order and
counts a replicated leaf once (``optimizer.global_norm``); under ZeRO-1
the moments are the 'data' slices of the 'model' blocks.

On the GPU, ranks that share one card exchange through gloo, which gets
host copies (``distributed.exchange``): an f32 add gives the same bits
on either device, so the gradients' bits do not change.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..distributed import sharding
from ..distributed.exchange import all_gather, sum_in_rank_order
from ..models.registry import ModelApi
from ..utils import MetaGenerator, div, tree_flatten
from .optimizer import (
    F32,
    OptConfig,
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
)


def _split_micro(batch: dict, accum: int) -> dict:
    """Every leaf [B, ...] -> [accum, B // accum, ...] (row blocks)."""
    def sp(x):
        B = x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of grad_accum {accum}")
        return x.reshape(accum, B // accum, *x.shape[1:])

    return {k: sp(v) for k, v in batch.items()}


def _value_and_grad(api: ModelApi, cfg: ArchConfig, leaves: list, treedef,
                    batch: dict):
    """(loss, gradient of every leaf) of ``api.loss_fn`` at the params
    ``treedef.unflatten(leaves)``; a leaf the loss does not reach gets a
    zero gradient, as under ``jax.grad``."""
    ps = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = api.loss_fn(treedef.unflatten(ps), cfg, batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, grads)]


def _accumulate(api, cfg, leaves, treedef, batch: dict, grad_accum: int):
    """(loss, gradients) of ``batch``: one pass at grad_accum 1, else the
    sums (undivided, f32) over its ``grad_accum`` row blocks in order."""
    if grad_accum == 1:
        return _value_and_grad(api, cfg, leaves, treedef, batch)
    micros = _split_micro(batch, grad_accum)
    loss = torch.zeros((), dtype=F32, device=leaves[0].device)
    grads = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in leaves]
    for i in range(grad_accum):
        micro = {k: v[i] for k, v in micros.items()}
        l, g = _value_and_grad(api, cfg, leaves, treedef, micro)
        loss = loss + l
        for acc, gi in zip(grads, g):
            acc.add_(gi)
        del g
    return loss, grads


# ---------------------------------------------------------------------------
# a rank's block of the batch
# ---------------------------------------------------------------------------


def _row_block(batch: dict, mesh):
    """This rank's contiguous rows of every leaf, or None when the batch
    is replicated (the fallback of ``batch_specs``)."""
    specs = sharding.batch_specs(batch, mesh)
    split = {k: s[0] is not None for k, s in specs.items()}
    if not any(split.values()):
        return None
    if not all(split.values()):
        raise ValueError(f"batch leaves split unevenly over the data axes: {specs}")
    n, r = mesh.dp_size, mesh.dp_index
    return {k: v[r * (v.shape[0] // n):(r + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# ZeRO-1 moments
# ---------------------------------------------------------------------------


def _moment_specs(accum_pspecs, params) -> list:
    specs = accum_pspecs.mu if isinstance(accum_pspecs, OptState) else accum_pspecs
    return sharding.spec_leaves(specs, tree_flatten(params)[1])


def _data_dim(spec) -> int | None:
    return next((i for i, a in enumerate(spec) if "data" in sharding._axes(a)), None)


def _local(x: torch.Tensor, d: int | None, mesh) -> torch.Tensor:
    """This rank's 'data' slice of ``x`` along dim ``d`` (a view)."""
    if d is None:
        return x
    n = x.shape[d] // mesh.data_size
    return x.narrow(d, mesh.data_index * n, n)


def _gather_dim(x: torch.Tensor, d: int | None, mesh) -> torch.Tensor:
    if d is None or mesh.data_size == 1:
        return x
    return torch.cat(all_gather(x, mesh.data_group, mesh.data_size), dim=d)


def _zero1_update(grads: list, opt_state: OptState, params, opt_cfg, dims, mesh,
                  gnorm):
    """AdamW on this rank's 'data' slices, the clip from the full
    gradients' norm ``gnorm``; then every sliced parameter gathered
    whole."""
    leaves, treedef = tree_flatten(params)
    p_loc = [_local(p, d, mesh).contiguous() if d is not None else p
             for p, d in zip(leaves, dims)]
    g_loc = [_local(g, d, mesh).contiguous() if d is not None else g
             for g, d in zip(grads, dims)]
    mu, nu = tree_flatten(opt_state.mu)[0], tree_flatten(opt_state.nu)[0]
    _, st, _ = adamw_update(g_loc, OptState(mu=mu, nu=nu, step=opt_state.step),
                            p_loc, opt_cfg, gnorm=gnorm)
    del g_loc
    for p, pl, d in zip(leaves, p_loc, dims):
        if d is not None:
            p.copy_(_gather_dim(pl, d, mesh))
    return params, OptState(mu=opt_state.mu, nu=opt_state.nu, step=st.step), gnorm


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _sharded_flags(api: ModelApi, cfg: ArchConfig, mesh, param_pspecs) -> list[bool]:
    """Whether each parameter leaf (leaf order) is split over 'model': by
    ``param_pspecs``, else by the rule over the config's full shapes (an
    init on the meta device: nothing is allocated)."""
    full = api.init(MetaGenerator(), cfg)
    specs = sharding.param_specs(full, mesh) if param_pspecs is None else param_pspecs
    return [any("model" in sharding._axes(a) for a in spec)
            for spec in sharding.spec_leaves(specs, tree_flatten(full)[1])]


def make_train_step(api: ModelApi, cfg: ArchConfig, opt_cfg: OptConfig,
                    grad_accum: int = 1, param_pspecs=None, accum_pspecs=None):
    """param_pspecs: the parameters' specs (``param_specs``), the
    reference's gradient pins: under a 'model' axis a rank's gradients
    are its blocks, so holding them is the pin; the specs also tell the
    global norm which leaves are split. accum_pspecs: the ZeRO-1 moment
    specs (``opt_state_specs``, or their ``mu`` tree): under an active
    data-parallel mesh the optimizer state holds each rank's slices
    (``sharding.train_state_specs``)."""
    split: dict = {}  # the mesh the flags were made for, and the flags

    def train_step(params, opt_state: OptState, batch: dict):
        mesh = sharding.active_mesh()
        if mesh is not None and mesh.size == 1:
            mesh = None
        tp = None
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            tp = sharding.model_lanes(0)
            if split.get("mesh") is not mesh:
                split.update(mesh=mesh, flags=_sharded_flags(api, cfg, mesh, param_pspecs))
        leaves, treedef = tree_flatten(params)
        # None: no mesh, or a replicated batch that every rank runs whole
        rows = None if mesh is None else _row_block(batch, mesh)
        loss, grads = _accumulate(api, cfg, leaves, treedef,
                                  batch if rows is None else rows, grad_accum)
        total = grad_accum
        if rows is not None:
            n = mesh.dp_size
            loss = sum_in_rank_order(loss, mesh.dp_group, n)
            for i, g in enumerate(grads):  # each local sum freed once reduced
                grads[i] = sum_in_rank_order(g, mesh.dp_group, n)
            del g
            total *= n
        if total > 1:
            loss = div(loss, total)
            grads = [div(g, total) for g in grads]
        gnorm = global_norm(grads, split.get("flags"), tp)
        dims = ([_data_dim(s) for s in _moment_specs(accum_pspecs, params)]
                if mesh is not None and accum_pspecs is not None else [])
        if any(d is not None for d in dims):
            params, opt_state, gnorm = _zero1_update(grads, opt_state, params,
                                                     opt_cfg, dims, mesh, gnorm)
        else:
            params, opt_state, gnorm = adamw_update(treedef.unflatten(grads),
                                                    opt_state, params, opt_cfg,
                                                    gnorm=gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": opt_state.step}

    return train_step


def init_training(api: ModelApi, cfg: ArchConfig, gen: torch.Generator) -> tuple:
    """(params, zero optimizer state) of a fresh model on ``gen``'s device."""
    params = api.init(gen, cfg)
    return params, init_opt_state(params)
