"""AdamW with global-norm clipping, and the cosine, WSD and constant
learning-rate schedules (the torch port of ``repro/training/optimizer.py``).

WSD (warmup-stable-decay) is MiniCPM's schedule (arXiv:2404.06395), the
minicpm-2b config's ``TRAIN_SCHEDULE``.

The written math runs in f32 on the parameters' device: the step is an
int32 tensor, and the schedule, the bias corrections ``b ** step``, the
clip factor and the learning rate are f32 tensors, never Python floats
(a constant a CUDA kernel takes as a Python number would be rounded, or
divided by, otherwise than the reference's f32 arithmetic). The update
runs leaf by leaf in the trees' leaf order, in slices of ``CHUNK``
elements (elementwise: the slicing changes no value), and IN PLACE: each
parameter is overwritten in its own dtype, the moments (f32) are updated
where they lie, and the input trees are returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..utils import tree_flatten, tree_map

F32 = torch.float32
CHUNK = 1 << 25  # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"  # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1  # WSD: fraction of steps in the final decay


@dataclasses.dataclass
class OptState:
    """AdamW state; the fields in the reference's order (its leaf order)."""

    mu: object  # first moment: f32, shaped as the params
    nu: object  # second moment
    step: torch.Tensor  # int32 []


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=like.device)


def make_schedule(cfg: OptConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> the learning rate at that step (f32 tensor)."""
    w, T = cfg.warmup_steps, cfg.total_steps

    def ratio(num: torch.Tensor, den: int) -> torch.Tensor:
        # an integer over an integer, as f32 / f32 (both exact here)
        return num.to(F32) / _f32(den, num)

    def clip01(x):
        return torch.clamp(x, 0.0, 1.0)

    def cosine(step):
        warm = ratio(step, max(w, 1))
        prog = clip01(ratio(step - w, max(T - w, 1)))
        tail = 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < w, warm, tail)

    def wsd(step):
        decay_start = int(T * (1 - cfg.decay_frac))
        warm = ratio(step, max(w, 1))
        dec = 1.0 - clip01(ratio(step - decay_start, max(T - decay_start, 1)))
        stable = torch.where(step < decay_start, _f32(1.0, step), dec)
        return cfg.lr * torch.where(step < w, warm, stable)

    def constant(step):
        return _f32(cfg.lr, step)

    return {"cosine": cosine, "wsd": wsd, "constant": constant}[cfg.schedule]


def init_opt_state(params) -> OptState:
    """Zero f32 moments shaped as ``params``, step 0, on the params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    leaves = tree_flatten(params)[0]
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device))


def global_norm(tree, sharded: list | None = None, tp=None) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in leaf order, of each leaf's f32 sum
    of squares. Under tensor parallelism (``tp`` a
    ``distributed.exchange.ModelGroup``; ``tree`` this rank's blocks,
    ``sharded`` a flag a leaf) a sharded leaf's sum is its blocks' sums
    added over the 'model' ranks in rank order, and a replicated leaf is
    counted once: every rank gets the same norm."""
    squares = [torch.sum(torch.square(x.to(F32))) for x in tree_flatten(tree)[0]]
    if tp is not None:
        from ..distributed.exchange import all_gather

        ranks = all_gather(torch.stack(squares), tp.group, tp.size)
        for i, split in enumerate(sharded):
            if split:
                sq = torch.zeros((), dtype=F32, device=squares[i].device)
                for r in ranks:
                    sq = sq + r[i]
                squares[i] = sq
    total = None
    for sq in squares:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: OptState, params, cfg: OptConfig, gnorm=None):
    """One AdamW step with global-norm clipping, IN PLACE on ``params``
    and ``state``'s moments; returns (params, state, grad norm).
    ``gnorm``: the clip's norm when ``grads`` are slices of the gradients
    (a ZeRO-1 rank's), else the norm of ``grads``."""
    step = state.step + 1
    lr = make_schedule(cfg)(step)
    b1, b2 = cfg.betas
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.minimum(_f32(1.0, gnorm),
                         _f32(cfg.grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9))
    s = step.to(F32)
    bc1 = 1 - torch.pow(_f32(b1, s), s)
    bc2 = 1 - torch.pow(_f32(b2, s), s)
    neg_lr = (-lr).to(torch.float64)
    leaves = lambda t: tree_flatten(t)[0]
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        flat = [x.view(-1) for x in (p, g, m, v)]
        for a in range(0, p.numel(), CHUNK):  # bounds the f32 temporaries
            pc, gc, mc, vc = (x[a:a + CHUNK] for x in flat)
            gc = gc.to(F32) * clip
            mc.mul_(b1).add_((1 - b1) * gc)
            vc.mul_(b2).add_((1 - b2) * gc * gc)
            del gc
            p32 = pc.to(F32)
            delta = (mc / bc1).div_(torch.sqrt(vc / bc2).add_(cfg.eps))
            delta.add_(cfg.weight_decay * p32)
            # p - lr * delta rounded once, as one fused multiply-add (the
            # reference's compiled update contracts it so): the f64 product
            # of two f32 values is exact
            out = delta.to(torch.float64).mul_(neg_lr).add_(p32.to(torch.float64))
            pc.copy_(out.to(F32))
    return params, OptState(mu=state.mu, nu=state.nu, step=step), gnorm
