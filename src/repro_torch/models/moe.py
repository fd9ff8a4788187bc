"""Mixture-of-Experts MLP (qwen2-moe, moonshot): shared + routed top-k.

The torch port of ``repro/models/moe.py``: capacity-bounded
scatter/gather dispatch (a token's slot in its expert from a token-major
[T·k, E] cumsum), the experts as one batched SwiGLU over the [E, C, D]
buffer (``torch.bmm``), the shared experts as a plain SwiGLU, and the
Switch load-balancing aux loss.

Under a mesh of ranks (training) ``moe_apply`` runs one block of the
reference's ``shard_map`` dispatch: a rank's x is its data block, whole
over the sequence (the tensor-parallel stream is gathered before the
MLP: the capacity counts the block's tokens, as the reference's
``x_spec`` (dp, None, None) does), routed alone; under a 'model' line
(``tp``) each rank computes its slice of the expert FFN's Fe units (the
stored Fe slice, ``sharding.storage_specs``) and of the shared experts'
units, and the slices' partial sums are added in model order (the
reference's ``psum``): the down product's before the gates, so each
output rounds where the single-device one does. The routing's gradient
(through the gates and the aux loss, which every rank computes whole) is
taken on model rank 0 only, and the router's is summed over the ranks.
``_moe_sharded`` is the same dispatch with one controller over a global
x and a mesh of axis sizes (the tests hold it against the reference).

The routing is a function of the tokens the reference feeds the MLP.
The serving path pads its hidden states with zero rows (a decode step to
the verify window's height, a short final prefill chunk to a full
chunk's), and a pad row must take no capacity: C follows T, a zero row
routes to tied experts, and the cumsum would give it a slot before later
real tokens. So ``moe_apply(n_real=...)`` routes only each batch row's
first ``n_real`` positions; every dense product (the router, the shared
experts) still runs over all rows, so its shape, and on the GPU its
summation order, is the same at every height.

Top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks
them (a stable descending sort; ``torch.topk`` promises no order).
"""
from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager

import torch

from ..configs.base import ArchConfig
from ..utils import div, round_up
from ..distributed.exchange import grad_on_first, reduce_from
from .layers import dense_init, part, shared, swiglu

CAPACITY_FACTOR = 1.25


def moe_init(gen: torch.Generator, cfg: ArchConfig, n_layers: int) -> dict:
    """``n_layers`` MoE MLPs stacked on a leading axis, on ``gen``'s device:
    router f32 [L, D, E], experts bf16 [L, E, D, Fe] (gate, up) and
    [L, E, Fe, D] (down), shared experts bf16 [L, D, Fs] / [L, Fs, D]
    with Fs = n_shared_experts * Fe. Scales as the reference's (normal /
    sqrt(d_in)); drawn an expert at a time, so no f32 copy of a layer's
    experts is ever whole."""
    dev = gen.device
    L, E, D, Fe = n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    router = torch.empty((L, D, E), dtype=torch.float32, device=dev)
    w = {name: torch.empty((L, E, *shape), dtype=torch.bfloat16, device=dev)
         for name, shape in (("w_gate", (D, Fe)), ("w_up", (D, Fe)),
                             ("w_down", (Fe, D)))}
    for i in range(L):
        router[i] = dense_init(gen, D, E, torch.float32, dev)
        for name, t in w.items():
            for e in range(E):
                t[i, e] = dense_init(gen, *t.shape[2:], device=dev)
    p = {"router": router, **w}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        p["shared"] = {}
        for name, (d_in, d_out) in (("w_gate", (D, Fs)), ("w_up", (D, Fs)),
                                    ("w_down", (Fs, D))):
            t = torch.empty((L, d_in, d_out), dtype=torch.bfloat16, device=dev)
            for i in range(L):
                t[i] = dense_init(gen, d_in, d_out, device=dev)
            p["shared"][name] = t
    return p


@dataclasses.dataclass
class Routing:
    """One routed call's decisions. idx / gate: [T, k] (choices in
    descending probability, ties to the lower expert); pos: [T·k] a
    choice's place in its expert, token-major; keep: [T·k] pos < C;
    slot: [T·k] row of the [E·C] buffer (pos clipped to C - 1)."""
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    C: int
    aux: torch.Tensor
    gap: torch.Tensor  # [T] k-th minus (k+1)-th probability (inf if k == E)


def capacity(T: int, E: int, k: int,
             capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Tokens an expert takes: the reference's float expression, in its
    order."""
    return round_up(max(int(T * k / E * capacity_factor), 8), 8)


def route(logits: torch.Tensor, E: int, k: int,
          capacity_factor: float = CAPACITY_FACTOR) -> Routing:
    """Top-k routing and capacity positions of f32 router logits [T, E]."""
    T = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)
    ordered, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = ordered[:, :k], order[:, :k]
    gap = (ordered[:, k - 1] - ordered[:, k] if k < E
           else torch.full((T,), math.inf, device=logits.device))
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss
    me = probs.mean(dim=0)
    ce = torch.bincount(idx.reshape(-1), minlength=E).to(torch.float32) / (T * k)
    aux = E * torch.sum(me * ce)
    C = capacity(T, E, k, capacity_factor)
    fid = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(fid, E).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = pos < C
    slot = fid * C + torch.clamp(pos, max=C - 1)
    return Routing(idx, gate, pos, keep, slot, C, aux, gap)


def _dispatch_compute(x2: torch.Tensor, logits: torch.Tensor, wg, wu, wd,
                      E: int, k: int, capacity_factor: float, tp=None,
                      slices: int = 1):
    """Routed-expert output of tokens x2 [T, D] (bf16) given their router
    logits [T, E]: (out [T, D], aux, routing); ``tp`` / ``slices`` as
    ``_expert_out``'s."""
    r = route(logits, E, k, capacity_factor)
    return _expert_out(x2, r, wg, wu, wd, E, k, tp, slices), r.aux, r


def _hidden(buf: torch.Tensor, wg, wu) -> torch.Tensor:
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    return torch.nn.functional.silu(g.to(torch.float32)).to(buf.dtype) * u


def _expert_out(x2: torch.Tensor, r: Routing, wg, wu, wd, E: int, k: int,
                tp=None, slices: int = 1):
    """The experts' output [T, D] of tokens x2 under routing ``r``. Split
    over Fe (``tp``: the weights are this rank's Fe slice; ``slices``: one
    controller walks that many Fe slices of whole weights) the down
    product's f32 partial sums are added in slice (model rank) order and
    rounded once, as the single-device product rounds, before the gates:
    every rank gets the whole output."""
    T, D = x2.shape
    C = r.C
    # kept choices write their token into their slot; dropped ones go to a
    # spare row past the buffer (the reference adds them there as zeros)
    buf = torch.zeros((E * C + 1, D), dtype=x2.dtype, device=x2.device)
    dst = torch.where(r.keep, r.slot, E * C)
    buf.index_copy_(0, dst, x2.repeat_interleave(k, dim=0))
    buf = buf[:E * C].view(E, C, D)
    if tp is None and slices == 1:
        y = torch.bmm(_hidden(buf, wg, wu), wd)
    else:
        f = wg.shape[-1] // slices
        y = None
        for j in range(slices):
            fs = slice(j * f, (j + 1) * f)
            h = _hidden(buf, wg[..., fs], wu[..., fs])
            piece = torch.bmm(h.to(torch.float32), wd[:, fs].to(torch.float32))
            y = piece if y is None else y + piece
        if tp is not None:
            y = reduce_from(y, tp)
        y = y.to(x2.dtype)
    y = y.reshape(E * C, D)
    valid = r.keep[:, None].to(x2.dtype)
    out = y[r.slot] * valid * r.gate.reshape(-1, 1).to(x2.dtype)
    return out.reshape(T, k, D).sum(dim=1)


def _moe_sharded(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 capacity_factor: float, mesh):
    """The reference's ``shard_map`` dispatch with one controller, over a
    global x [B, S, D] and a mesh of axis sizes (the tests hold it against
    the reference; ranks run one block each through ``moe_apply``, with
    the same math): each block of rows of the data-parallel axes (by
    ``spec_with_fallback``; one block when B does not divide them) is
    routed alone, with the capacity of its own token count; under a
    'model' axis that divides Fe the expert FFN runs one Fe slice at a
    time, and the slices' f32 down products are added in model order
    before the gates (``_expert_out``), where the reference's ``psum``
    adds bf16 outputs after them: the two differ by that rounding. The
    aux loss is the mean of the blocks' in block order. Returns (routed
    output [B, S, D], aux)."""
    from ..distributed.sharding import _axis_size, dp_axes, spec_with_fallback

    dp = dp_axes(mesh)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_topk
    Fe = p["w_gate"].shape[-1]
    m = mesh.shape["model"] if "model" in mesh.axis_names else 1
    slices = m if m > 1 and Fe % m == 0 else 1
    x_spec = spec_with_fallback(x.shape, [dp, None, None], mesh)
    n_blk = _axis_size(mesh, dp) if x_spec[0] is not None else 1
    Bl = B // n_blk
    x2 = x.reshape(B * S, D)
    outs, auxes = [], []
    for b in range(n_blk):
        xb = x2[b * Bl * S:(b + 1) * Bl * S] if n_blk > 1 else x2
        out, aux, _ = _dispatch_compute(xb, xb.to(torch.float32) @ p["router"],
                                        p["w_gate"], p["w_up"], p["w_down"],
                                        E, k, capacity_factor, slices=slices)
        outs.append(out.view(Bl, S, D))
        auxes.append(aux)
    aux = auxes[0]
    if n_blk > 1:
        for a in auxes[1:]:
            aux = aux + a
        aux = div(aux, n_blk)
    return torch.cat(outs, 0) if n_blk > 1 else outs[0], aux


# -- opt-in routing log (tests and chip_smoke read it; off costs nothing) ----

_LOG: list | None = None
_KEEP = False


@dataclasses.dataclass
class RoutedCall:
    """One routed call: where it ran (``site``), its T and C, and on the
    device (no host read while serving) the dropped choices per token
    [T] and the smallest top-k probability gap; ``routing`` and
    ``logits`` when the log keeps tensors."""
    site: str
    T: int
    C: int
    dropped: torch.Tensor  # int32 [T]: dropped choices of each token
    min_gap: torch.Tensor
    routing: Routing | None = None
    logits: torch.Tensor | None = None


@contextmanager
def routing_log(keep_tensors: bool = False):
    """Record every routed call made inside the block into the yielded
    list (``RoutedCall``s, in call order)."""
    global _LOG, _KEEP
    prev = (_LOG, _KEEP)
    _LOG, _KEEP = [], keep_tensors
    try:
        yield _LOG
    finally:
        _LOG, _KEEP = prev


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
              capacity_factor: float = CAPACITY_FACTOR, *,
              n_real: int | None = None, site: str = "", tp=None):
    """x: [B, S, D] -> (out [B, S, D], aux loss).

    ``n_real``: only each batch row's first ``n_real`` positions are
    tokens (the rest are the caller's zero padding): they alone are
    routed, token-major over [B, n_real], and the padding's routed output
    is zero. The router and the shared experts run over every row.
    ``site`` labels the call in the routing log. Under a mesh of ranks
    (training) a rank's x is its data block, routed alone; under ``tp``
    every rank routes the whole block, computes its Fe slice of the
    experts and gets the whole output (module docstring)."""
    B, S, D = x.shape
    E, k, Fe = cfg.n_experts, cfg.moe_topk, cfg.d_ff_expert
    x2 = x.reshape(B * S, D)
    n = S if n_real is None else n_real
    logits = x2.to(torch.float32) @ shared(p["router"], tp)  # [B·S, E], every row
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if tp is not None:  # every rank routes the whole block: its Fe slice
        logits = grad_on_first(logits, tp)
        lo, hi = tp.range(Fe)
        wg, wu = part(wg, -1, Fe, lo, hi, tp), part(wu, -1, Fe, lo, hi, tp)
        wd = part(wd, -2, Fe, lo, hi, tp)
    if n < S:
        xr = x[:, :n].reshape(B * n, D)
        lr = logits.view(B, S, E)[:, :n].reshape(B * n, E)
    else:
        xr, lr = x2, logits
    routed, aux, r = _dispatch_compute(xr, lr, wg, wu, wd, E, k, capacity_factor, tp)
    if _LOG is not None:
        _LOG.append(RoutedCall(
            site, B * n, r.C, (~r.keep).view(-1, k).sum(1, dtype=torch.int32),
            r.gap.min(), r if _KEEP else None, lr if _KEEP else None))
    if n < S:
        out = torch.zeros_like(x)
        out[:, :n] = routed.view(B, n, D)
    else:
        out = routed.view(B, S, D)
    if cfg.n_shared_experts:  # shared experts: a plain SwiGLU over every row
        sp = p["shared"]
        Fs = cfg.n_shared_experts * cfg.d_ff_expert
        y = swiglu(x2, sp["w_gate"], sp["w_up"], sp["w_down"], tp, Fs)
        if tp is not None:  # the F slices' f32 partial sums, added and rounded once
            y = reduce_from(y, tp).to(x.dtype)
        out = out + y.view(B, S, D)
    return out, aux
