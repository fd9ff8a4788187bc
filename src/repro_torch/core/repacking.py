"""Encode-aware repacking (paper section III-B3, Algorithm 1), the torch
port of ``repro/core/repacking.py``.

Reorders token rows inside a block so that each bit-packing pack holds
similar rows, shrinking per-pack ranges and so the encoded widths. Decode
attention is invariant under a joint permutation of K and V rows, so the
permutation never needs undoing at decode time.

* ``greedy_repack``: Algorithm 1. Seed each pack with the row closest to
  the centroid of the remaining rows, then grow it by least bit cost.
* ``median_repack``: sort rows by the median of their (quantized) V row;
  the runtime cache's in-graph repacker.
* ``identity_repack``: the baseline (mode "none").

Every repacker takes one block ``[N, D]`` or a batch ``[..., N, D]`` and
returns ``perm`` int64 ``[..., N]``: row i of the repacked block is row
``perm[i]`` of the input. Each runs as tensor ops on its input's device.
"""
from __future__ import annotations

import torch

from ..utils import div
from .bitpack import bits_required

# elements of one [blocks, N, D] working tensor of greedy_repack (int64:
# 1 GiB); the batch is cut into chunks of at most this many
GREEDY_CHUNK_ELEMS = 1 << 27


def identity_repack(q: torch.Tensor, pack_size: int) -> torch.Tensor:
    q = torch.as_tensor(q)
    n = q.shape[-2]
    return torch.arange(n, device=q.device).expand(*q.shape[:-2], n)


def median_repack(qv: torch.Tensor, pack_size: int | None = None) -> torch.Tensor:
    """Stable argsort of token rows by the median of their V row.

    qv: int [..., N, D] -> perm int64 [..., N]. ``pack_size`` is unused
    (the reference's host signature). The median of an even-length row is
    the MEAN of its two middle values (``torch.median`` would return the
    lower one), matching the reference's ``jnp.median`` and ``np.median``
    (exact in float32 for integers below 2**24).
    """
    qv = torch.as_tensor(qv)
    D = qv.shape[-1]
    s = torch.sort(qv.to(torch.float32), dim=-1).values
    if D % 2:
        med = s[..., D // 2]
    else:
        med = (s[..., D // 2 - 1] + s[..., D // 2]) * 0.5
    return torch.argsort(med, dim=-1, stable=True)


def pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's pairwise order (``ndarray.sum``
    of a contiguous row), one eager add at a time, so float64 results
    equal numpy's bit for bit: below 8 terms a running sum from 0; up to
    128, eight strided accumulators combined as ((r0+r1)+(r2+r3)) +
    ((r4+r5)+(r6+r7)), then the tail; above 128, the two halves split at
    a multiple of 8."""
    n = a.shape[-1]
    if n < 8:
        res = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = a[..., :8]
        for i in range(8, m, 8):
            r = r + a[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            res = res + a[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(a[..., :n2]) + pairwise_sum(a[..., n2:])


def _greedy_chunk(q: torch.Tensor, pack_size: int) -> torch.Tensor:
    """Algorithm 1 over a batch of blocks q int64 [B, N, D], all in
    lockstep. A taken-mask over the original rows stands for the
    reference's ``np.delete``, which keeps the original order, so the
    first minimal row among the remaining ones is the first in original
    order, as ``argmin`` picks it."""
    B, n, d = q.shape
    dev = q.device
    rows = torch.arange(B, device=dev)
    taken = torch.zeros((B, n), dtype=torch.bool, device=dev)
    order = torch.empty((B, n), dtype=torch.int64, device=dev)
    never = torch.iinfo(torch.int64).max
    qf = q.to(torch.float64)
    for t in range(n):
        if t % pack_size == 0:
            # seed: the remaining row closest to their centroid; the
            # integer sum is exact in float64, the squared distances are
            # summed in numpy's order (ties are common on coarse blocks)
            left = ~taken
            total = torch.where(left.unsqueeze(-1), q, 0).sum(dim=1)
            centroid = div(total.to(torch.float64), n - t)
            diff = qf - centroid.unsqueeze(1)
            dist = pairwise_sum(diff * diff).masked_fill(taken, float("inf"))
            j = torch.argmin(dist, dim=1)
            cur_min = cur_max = q[rows, j]
        else:
            cand_min = torch.minimum(cur_min.unsqueeze(1), q)  # [B, N, D]
            cand_max = torch.maximum(cur_max.unsqueeze(1), q)
            cost = bits_required(cand_max - cand_min).sum(dim=-1)
            j = torch.argmin(cost.masked_fill(taken, never), dim=1)
            cur_min, cur_max = cand_min[rows, j], cand_max[rows, j]
        taken[rows, j] = True
        order[:, t] = j
    return order


def greedy_repack(q: torch.Tensor, pack_size: int) -> torch.Tensor:
    """Algorithm 1: greedy repacking for bit-packing, byte-exact against
    the reference's host loop.

    q: [..., N, D] quantized integers (K, V, or [K|V] for joint
    optimization). Returns perm int64 [..., N], the concatenation of the
    emitted packs. The batch runs in chunks of at most
    ``GREEDY_CHUNK_ELEMS`` elements a working tensor.
    """
    q = torch.as_tensor(q).to(torch.int64)
    *lead, n, d = q.shape
    if n % pack_size:
        raise ValueError(f"block of {n} rows is not a multiple of pack {pack_size}")
    flat = q.reshape(-1, n, d)
    step = max(1, GREEDY_CHUNK_ELEMS // max(1, n * d))
    out = [_greedy_chunk(flat[i:i + step], pack_size)
           for i in range(0, flat.shape[0], step)]
    perm = torch.cat(out) if out else torch.empty((0, n), dtype=torch.int64,
                                                  device=q.device)
    return perm.reshape(*lead, n)


REPACKERS = {
    "none": lambda qk, qv, pack_size: identity_repack(qk, pack_size),
    "greedy_k": lambda qk, qv, pack_size: greedy_repack(qk, pack_size),
    "greedy_v": lambda qk, qv, pack_size: greedy_repack(qv, pack_size),
    "greedy_joint": lambda qk, qv, pack_size: greedy_repack(
        torch.cat([torch.as_tensor(qk), torch.as_tensor(qv)], dim=-1), pack_size),
    "median_v": lambda qk, qv, pack_size: median_repack(qv, pack_size),
}


def repack(qk: torch.Tensor, qv: torch.Tensor, pack_size: int, mode: str) -> torch.Tensor:
    """The joint K/V row permutation for ``mode``, [..., N]."""
    try:
        fn = REPACKERS[mode]
    except KeyError:
        raise ValueError(f"unknown repacking mode {mode!r}; one of {list(REPACKERS)}")
    return fn(qk, qv, pack_size)
