"""Encode-aware repacking (paper section III-B3): V-median token order.

Only the in-graph repacker of the runtime cache is ported here; the host
storage-tier repackers arrive with the storage format.
"""
from __future__ import annotations

import torch


def median_repack(qv: torch.Tensor) -> torch.Tensor:
    """Stable argsort of token rows by the median of their V vector.

    qv: int [..., N, D] -> perm int64 [..., N]; row i of the repacked block
    is row ``perm[i]`` of the input. The median of an even-length row is
    the MEAN of its two middle values (``torch.median`` would return the
    lower one), matching the reference's ``jnp.median``.
    """
    D = qv.shape[-1]
    s = torch.sort(qv.to(torch.float32), dim=-1).values
    if D % 2:
        med = s[..., D // 2]
    else:
        med = (s[..., D // 2 - 1] + s[..., D // 2]) * 0.5
    return torch.argsort(med, dim=-1, stable=True)
