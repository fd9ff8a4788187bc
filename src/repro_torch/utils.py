"""Small shared utilities (the torch counterpart of ``repro/utils.py``)."""
from __future__ import annotations

import math

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with one rounding on every device. PyTorch's CUDA division of
    a tensor by a Python number multiplies by the number's reciprocal (two
    roundings), which differs from the CPU's and numpy's quotient in the
    last bit; dividing by a tensor divides."""
    return x / torch.full_like(x, d)


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
    """Bytes held by every tensor of a tree (``tree_flatten``), each
    tensor counted once."""
    tensors = {id(x): x for x in tree_flatten(obj)[0] if isinstance(x, torch.Tensor)}
    return sum(leaf_nbytes(x) for x in tensors.values())


# ---------------------------------------------------------------------------
# Trees: nested dataclasses, lists, tuples and dicts of tensors (the torch
# counterpart of ``jax.tree_util`` for this package's caches)
# ---------------------------------------------------------------------------


def _is_static(x) -> bool:
    """A dataclass field value carried in the structure, not as a leaf:
    anything but None, a tensor, an array, a container or a mutable
    dataclass (frozen dataclasses such as configs and specs are static)."""
    import dataclasses

    import numpy as np

    if x is None or isinstance(x, (torch.Tensor, np.ndarray, list, tuple, dict)):
        return False
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return x.__dataclass_params__.frozen
    return True


class TreeDef:
    """The structure of a flattened tree: ``unflatten(leaves)`` rebuilds
    it, ``str`` is a deterministic fingerprint of it (class names, field
    names and static values; no shapes)."""

    def __init__(self, node):
        self.node = node

    def __repr__(self) -> str:
        return f"TreeDef({self._text(self.node)})"

    @classmethod
    def _text(cls, node) -> str:
        kind = node[0]
        if kind in ("*", "None"):
            return kind
        if kind in ("list", "tuple"):
            return f"{kind}[{', '.join(cls._text(c) for c in node[1])}]"
        if kind == "dict":
            return "dict{" + ", ".join(f"{k!r}: {cls._text(c)}"
                                       for k, c in zip(node[1], node[2])) + "}"
        _, typ, static, kids = node
        parts = [f"{k}={v!r}" for k, v in static.items()]
        parts += [f"{k}: {cls._text(c)}" for k, c in kids]
        return f"{typ.__qualname__}({', '.join(parts)})"

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(self.node, it)
        if next(it, None) is not None:
            raise ValueError("more leaves than the structure holds")
        return out

    @classmethod
    def _build(cls, node, it):
        kind = node[0]
        if kind == "*":
            return next(it)
        if kind == "None":
            return None
        if kind in ("list", "tuple"):
            seq = [cls._build(c, it) for c in node[1]]
            return seq if kind == "list" else tuple(seq)
        if kind == "dict":
            return {k: cls._build(c, it) for k, c in zip(node[1], node[2])}
        _, typ, static, kids = node
        return typ(**static, **{k: cls._build(c, it) for k, c in kids})


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """(leaves in a fixed order, structure). Leaves are tensors, arrays and
    the scalars of lists, tuples and dicts; None holds no leaf; dict keys
    go in sorted order."""
    leaves, treedef = tree_flatten_with_path(tree)
    return [x for _, x in leaves], treedef


def tree_flatten_with_path(tree) -> tuple[list, TreeDef]:
    """``tree_flatten`` with each leaf's path: ([(path, leaf)], structure),
    a path being the tuple of field names, sequence indices (as strings)
    and dict keys from the root to the leaf."""
    import dataclasses

    leaves: list = []

    def walk(x, path):
        if x is None:
            return ("None",)
        if isinstance(x, (list, tuple)):
            return ("list" if isinstance(x, list) else "tuple",
                    [walk(v, path + (str(i),)) for i, v in enumerate(x)])
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [walk(x[k], path + (str(k),)) for k in keys])
        if dataclasses.is_dataclass(x) and not isinstance(x, type) \
                and not x.__dataclass_params__.frozen:
            static, kids = {}, []
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if _is_static(v):
                    static[f.name] = v
                else:
                    kids.append((f.name, walk(v, path + (f.name,))))
            return ("dataclass", type(x), static, kids)
        leaves.append((path, x))
        return ("*",)

    return leaves, TreeDef(walk(tree, ()))


def tree_unbind(tree) -> list:
    """A tree of tensors stacked on a leading axis -> one tree a slice
    (``torch.unbind`` of every leaf: views, whose backward is one
    ``stack`` a leaf)."""
    leaves, treedef = tree_flatten(tree)
    slices = [torch.unbind(x) for x in leaves]
    return [treedef.unflatten([s[i] for s in slices])
            for i in range(len(slices[0]))]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([fn(x) for x in leaves])


def leaf_nbytes(x) -> int:
    """Bytes of one leaf (a tensor, an array or a scalar)."""
    import numpy as np

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def to_host(tree):
    """A host copy of every tensor and array of ``tree`` (a copy even when
    a tensor already lies on the CPU: the caller's buffers may be reused)."""
    import numpy as np

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    return tree_map(copy, tree)


def to_device(tree, device):
    """Every tensor of ``tree`` on ``device`` (no copy where it is already)."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)
