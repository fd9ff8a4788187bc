"""Train step: loss and gradients, microbatch accumulation, AdamW (the
torch port of ``repro/training/train.py``).

``make_train_step(api, cfg, opt_cfg, grad_accum)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.
A batch carries the global batch dim; at ``grad_accum`` > 1 it is split
into that many contiguous row blocks (``_split_micro``), run one after
another, their gradients added in order into an f32 accumulator and their
losses summed, then both divided by ``grad_accum`` (activation memory /
grad_accum, the same math). The update is in place (``adamw_update``).

The reference's ``param_pspecs`` / ``accum_pspecs`` pin gradients to a
device mesh; they belong to the multi-device port and are not taken here.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.registry import ModelApi
from ..utils import div, tree_flatten
from .optimizer import OptConfig, OptState, adamw_update, init_opt_state


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


def make_train_step(api: ModelApi, cfg: ArchConfig, opt_cfg: OptConfig,
                    grad_accum: int = 1):
    def train_step(params, opt_state: OptState, batch: dict):
        leaves, treedef = tree_flatten(params)
        if grad_accum == 1:
            loss, grads = _value_and_grad(api, cfg, leaves, treedef, batch)
        else:
            micros = _split_micro(batch, grad_accum)
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            for i in range(grad_accum):
                micro = {k: v[i] for k, v in micros.items()}
                l, g = _value_and_grad(api, cfg, leaves, treedef, micro)
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            loss = div(loss, grad_accum)
            grads = [div(g, grad_accum) for g in grads]
        params, opt_state, gnorm = adamw_update(treedef.unflatten(grads),
                                                opt_state, params, opt_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt_state.step}
        return params, opt_state, metrics

    return train_step


def init_training(api: ModelApi, cfg: ArchConfig, gen: torch.Generator) -> tuple:
    """(params, zero optimizer state) of a fresh model on ``gen``'s device."""
    params = api.init(gen, cfg)
    return params, init_opt_state(params)
