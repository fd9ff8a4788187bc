"""Exchanges between ``torch.distributed`` ranks in a fixed order.

The data-parallel train step and ``compressed_psum_mean`` gather every
rank's values and add them themselves, in rank order, so a sum's bits do
not depend on the backend's reduction order: an all-reduce may add in any
order. Values cross bit for bit, as their bytes; with gloo, a
CUDA tensor crosses as a host copy (ranks that share one card cannot use
NCCL), which changes no bit.

Tensor parallelism over a 'model' line of ranks (``ModelGroup``) builds on
the same exchanges: ``reduce_scatter`` (each rank's chunk of the rank-order
sum, through one all-to-all) and ``all_gather``, and the autograd
functions that place them in a forward and its backward:

  * ``copy_to``: identity forward, rank-order sum backward (a replicated
    tensor entering work the ranks split: its gradient is the sum of the
    ranks' parts);
  * ``reduce_from``: rank-order sum forward, identity backward (after a
    row-parallel product);
  * ``gather_along``: all-gather along a dim forward, reduce-scatter
    backward (a sequence-sharded stream entering split work; a leaf's
    slice gathered whole);
  * ``scatter_along``: reduce-scatter forward, all-gather backward (a
    row-parallel product's partial sums back onto the sharded stream);
  * ``split_along``: this rank's chunk forward, all-gather backward (a
    replicated tensor onto the sharded stream);
  * ``grad_on_first``: identity forward, the gradient kept on model rank 0
    only (a value every rank computes whole, such as the MoE aux loss,
    whose inputs take their gradient as a sum over the ranks).

Every sum runs in f32 into a buffer that starts at zero and is rounded
once to the tensor's dtype: no all-reduce of values anywhere, so a run's
bits do not depend on the backend.

``traffic()`` records, while it is open, each group's exchanges: calls,
bytes received and host seconds (under gloo a CUDA tensor's host copy
waits for the card, so the seconds cover the exchange; off, it costs
nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

CHUNK = 1 << 24  # values of a leaf gathered at a time (n copies of a slice)
_TRAFFIC: dict | None = None


@contextlib.contextmanager
def traffic():
    """Yield {id(group): [calls, bytes received, seconds]} of the exchanges
    made inside the block (``id(None)``: the default group)."""
    global _TRAFFIC
    prev, _TRAFFIC = _TRAFFIC, {}
    try:
        yield _TRAFFIC
    finally:
        _TRAFFIC = prev


def _record(group, nbytes: int, t0: float) -> None:
    if _TRAFFIC is not None:
        row = _TRAFFIC.setdefault(id(group), [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += time.perf_counter() - t0


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s bytes, flat; a host copy of a CUDA tensor under gloo."""
    import torch.distributed as dist

    wire = x.contiguous().reshape(-1).view(torch.uint8)
    if wire.is_cuda and dist.get_backend(group) == "gloo":
        wire = wire.cpu()
    return wire


def all_gather(x: torch.Tensor, group, n: int) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on each), in rank order,
    on ``x``'s device. Values travel as their bytes (gloo takes no bf16
    or int16); gloo gets host copies of a CUDA tensor."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    wire = _wire(x, group)
    out = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(out, wire, group=group)
    out = [o.to(x.device).view(x.dtype).view(x.shape) for o in out]
    _record(group, n * wire.numel(), t0)
    return out


def sum_in_rank_order(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The f32 sum over the group's ranks of ``x``, added in rank order
    into a buffer that starts at zero, gathered ``CHUNK`` values at a
    time (n copies of a slice, never of the whole leaf)."""
    flat = x.reshape(-1)
    out = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
    for a in range(0, flat.numel(), CHUNK):
        acc = out[a:a + CHUNK]
        for part in all_gather(flat[a:a + CHUNK], group, n):
            acc.add_(part)
    return out.view(x.shape)


def reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` (of n equal chunks) of the sum over
    the group's ranks of ``x``: one all-to-all hands every rank the
    others' copies of its chunk, which it adds in rank order into an f32
    buffer that starts at zero; rounded once to ``x``'s dtype."""
    import torch.distributed as dist

    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    t0 = time.perf_counter()
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    wire = _wire(torch.stack(chunks), group)
    got = torch.empty_like(wire)
    dist.all_to_all_single(got, wire, group=group)
    parts = got.to(x.device).view(x.dtype).view(n, *chunks[0].shape)
    _record(group, got.numel(), t0)
    out = torch.zeros(chunks[0].shape, dtype=torch.float32, device=x.device)
    for p in parts:
        out.add_(p)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# a 'model' line of ranks and the autograd functions over it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ranks of one 'model' line: its process ``group`` (None: the
    default group), its ``size`` and this rank's ``index``; ``seq``: the
    residual stream is sharded over the line by sequence (the stream's
    length divides ``size``), else every rank holds it whole."""

    group: object
    size: int
    index: int
    seq: bool = False

    def range(self, total: int) -> tuple[int, int]:
        """This rank's [lo, hi) of ``total`` items split in rank order
        (uneven when ``size`` does not divide ``total``)."""
        return self.index * total // self.size, (self.index + 1) * total // self.size


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return sum_in_rank_order(g, tp.group, tp.size).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return sum_in_rank_order(x, tp.group, tp.size).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return torch.cat(all_gather(x, tp.group, tp.size), dim=dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return reduce_scatter(g, ctx.dim, tp.group, tp.size), None, None


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return reduce_scatter(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return torch.cat(all_gather(g, tp.group, tp.size), dim=ctx.dim), None, None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return torch.cat(all_gather(g, tp.group, tp.size), dim=ctx.dim), None, None


class _GradOnFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.first = tp.index == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def copy_to(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    return _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    return _ReduceFrom.apply(x, tp)


def gather_along(x: torch.Tensor, dim: int, tp: ModelGroup) -> torch.Tensor:
    return _GatherAlong.apply(x, dim % x.dim(), tp)


def scatter_along(x: torch.Tensor, dim: int, tp: ModelGroup) -> torch.Tensor:
    return _ScatterAlong.apply(x, dim % x.dim(), tp)


def split_along(x: torch.Tensor, dim: int, tp: ModelGroup) -> torch.Tensor:
    return _SplitAlong.apply(x, dim % x.dim(), tp)


def grad_on_first(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    return _GradOnFirst.apply(x, tp)
