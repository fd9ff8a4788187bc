"""Exchanges between ``torch.distributed`` ranks in a fixed order.

The data-parallel train step and ``compressed_psum_mean`` gather every
rank's values and add them themselves, in rank order, so a sum's bits do
not depend on the backend's reduction order: an all-reduce may add in any
order. Values cross bit for bit, as their bytes; with gloo, a
CUDA tensor crosses as a host copy (ranks that share one card cannot use
NCCL), which changes no bit.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 24  # values of a leaf gathered at a time (n copies of a slice)


def all_gather(x: torch.Tensor, group, n: int) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on each), in rank order,
    on ``x``'s device. Values travel as their bytes (gloo takes no bf16
    or int16); gloo gets host copies of a CUDA tensor."""
    import torch.distributed as dist

    wire = x.contiguous().reshape(-1).view(torch.uint8)
    if wire.is_cuda and dist.get_backend(group) == "gloo":
        wire = wire.cpu()
    out = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(out, wire, group=group)
    return [o.to(x.device).view(x.dtype).view(x.shape) for o in out]


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
