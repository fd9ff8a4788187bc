"""Atomic single-entry serializers for evacuated mini-caches (the torch
port of ``save_mini`` / ``load_mini`` in ``repro/checkpoint/sharded.py``;
its step checkpoints and ``AsyncCheckpointer`` wait for the training port).

The on-disk grammar is the reference's: one directory per entry holding

  arrays.npz      the flat leaves, keyed ``leaf_<i>``, as savable views
                  (bfloat16 as its uint16 bits)
  manifest.json   a structure fingerprint, the leaf count, each leaf's
                  dtype, caller metadata
  COMMIT          written LAST; ``load_mini`` refuses a directory without it

written into ``.tmp-<name>`` beside the target and renamed into place.
Leaves that were torch tensors load back as CPU tensors, arrays and
scalars as numpy arrays.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from ..utils import TreeDef, tree_flatten

COMMIT = "COMMIT"

_TORCH = {"bfloat16": torch.bfloat16}


def _to_savable(x) -> tuple[np.ndarray, str, bool]:
    """(array npz can store, the leaf's dtype name, whether it was a torch
    tensor): bfloat16 is stored as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16", True
        a = x.numpy()
        return a, str(a.dtype), True
    a = np.asarray(x)
    dt = str(a.dtype)
    if dt == "bfloat16":
        return a.view(np.uint16), dt, False
    return a, dt, False


def _from_savable(a: np.ndarray, dt: str, is_torch: bool):
    if is_torch:
        if dt == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a, order="C"))
    if dt == "bfloat16":
        import ml_dtypes

        return a.view(np.dtype(ml_dtypes.bfloat16))
    return a


def _tree_hash(treedef: TreeDef) -> str:
    return hashlib.sha256(str(treedef).encode()).hexdigest()[:16]


def save_mini(path: str, tree, extra: dict | None = None) -> str:
    """Atomically save ``tree`` (an evacuated mini-cache, or any small
    tree of tensors) into directory ``path``; ``extra`` must be
    JSON-serializable. Returns ``path``."""
    leaves, treedef = tree_flatten(tree)
    parent = os.path.dirname(path) or "."
    tmp = os.path.join(parent, f".tmp-{os.path.basename(path)}")
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes, kinds = {}, [], []
    for i, x in enumerate(leaves):
        a, dt, is_torch = _to_savable(x)
        arrays[f"leaf_{i}"] = a
        dtypes.append(dt)
        kinds.append(is_torch)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"tree_hash": _tree_hash(treedef), "n_leaves": len(leaves),
                "dtypes": dtypes, "torch": kinds, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def load_mini(path: str, treedef: TreeDef | None = None):
    """Inverse of ``save_mini``: ``(tree, extra)``. With ``treedef`` (e.g.
    cached by a ``SessionStore`` from its first park) the leaves are
    rebuilt into that structure after its fingerprint is checked; with
    None the flat leaf list is returned. Raises FileNotFoundError for a
    directory without ``COMMIT`` and ValueError for another structure."""
    if not os.path.exists(os.path.join(path, COMMIT)):
        raise FileNotFoundError(f"no committed mini-cache at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        n = manifest["n_leaves"]
        kinds = manifest.get("torch", [False] * n)
        leaves = [_from_savable(data[f"leaf_{i}"], manifest["dtypes"][i], kinds[i])
                  for i in range(n)]
    if treedef is None:
        return leaves, manifest["extra"]
    if manifest.get("tree_hash") not in (None, _tree_hash(treedef)):
        raise ValueError("mini-cache structure mismatch (different engine?)")
    return treedef.unflatten(leaves), manifest["extra"]
