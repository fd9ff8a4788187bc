"""Small shared utilities (the torch counterpart of ``repro/utils.py``)."""
from __future__ import annotations

import math

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def bits_required(rng: torch.Tensor) -> torch.Tensor:
    """ceil(log2(r+1)) for non-negative integer ranges; 0 when r == 0.

    Goes through a float32 logarithm as the reference does. The
    reference's ``log2`` evaluates as ``ln(x) * (1/ln 2)`` in float32,
    which gives 12.999999 at 8192 and 14.999999 at 32768; the same
    formula here keeps every width equal to the reference's (checked over
    [0, 2^16)), where ``torch.log2`` would not.
    """
    r = rng.to(torch.float32)
    log2 = torch.log(torch.clamp(r, min=1.0)) * (1.0 / math.log(2.0))
    bits = torch.floor(log2) + 1.0
    return torch.where(rng > 0, bits, torch.zeros_like(bits)).to(torch.int32)


def tree_bytes(obj) -> int:
    """Bytes held by every tensor reachable through dataclasses, lists,
    tuples and dicts (each tensor counted once)."""
    import dataclasses

    seen: set[int] = set()

    def walk(x) -> int:
        if isinstance(x, torch.Tensor):
            if id(x) in seen:
                return 0
            seen.add(id(x))
            return x.numel() * x.element_size()
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return sum(walk(getattr(x, f.name)) for f in dataclasses.fields(x))
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        return 0

    return walk(obj)
