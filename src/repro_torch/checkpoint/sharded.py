"""Atomic on-disk checkpoints: the training loop's step checkpoints
(``save`` / ``restore`` / ``latest_step`` / ``gc_old`` and the
``AsyncCheckpointer``) and the single-entry serializers of evacuated
mini-caches (``save_mini`` / ``load_mini``); the torch port of
``repro/checkpoint/sharded.py``.

The on-disk grammar is the reference's: one directory per entry
(``step_%08d`` for a step checkpoint) holding

  arrays.npz      the flat leaves, keyed ``leaf_<i>``, as savable views
                  (bfloat16 as its uint16 bits)
  manifest.json   a structure fingerprint, the leaf count, each leaf's
                  dtype, caller metadata (a step checkpoint: its step)
  COMMIT          written LAST; an entry without it does not exist

written into ``.tmp-<name>`` beside the target and renamed into place, so
the leaves of a tree the reference saves and of the same tree saved here
are the same bytes. ``restore`` puts each leaf where the caller's
``like_tree`` says (a tensor on ``device``); ``load_mini`` gives back
tensors for the leaves that were tensors. No path that loads a tensor
needs ``ml_dtypes``.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from ..utils import TreeDef, to_host, tree_flatten

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
    """A stored leaf back as a CPU tensor (``is_torch``) or an array. Only
    a bfloat16 leaf that was an array needs ``ml_dtypes``."""
    if is_torch:
        if dt == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a, order="C"))
    if dt == "bfloat16":
        try:
            import ml_dtypes
        except ImportError as e:
            raise ImportError("a bfloat16 leaf saved as an array loads back as an "
                              "ml_dtypes array, and ml_dtypes is not installed; "
                              "save such a leaf as a torch tensor") from e
        return a.view(np.dtype(ml_dtypes.bfloat16))
    return a


def _tree_hash(treedef: TreeDef) -> str:
    return hashlib.sha256(str(treedef).encode()).hexdigest()[:16]


def _write(tmp: str, final: str, tree, head: dict, extra: dict | None) -> str:
    """Write ``tree`` into ``tmp`` (arrays, manifest ``head`` + the leaf
    table + ``extra``, COMMIT last) and rename it to ``final``."""
    leaves, treedef = tree_flatten(tree)
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes, kinds = {}, [], []
    for i, x in enumerate(leaves):
        a, dt, is_torch = _to_savable(x)
        arrays[f"leaf_{i}"] = a
        dtypes.append(dt)
        kinds.append(is_torch)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {**head, "tree_hash": _tree_hash(treedef), "n_leaves": len(leaves),
                "dtypes": dtypes, "torch": kinds, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _read(d: str):
    """(manifest, the stored leaves as (array, dtype name, was a tensor))."""
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n = manifest["n_leaves"]
    dtypes = manifest.get("dtypes") or [None] * n
    kinds = manifest.get("torch", [False] * n)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        stored = [(data[f"leaf_{i}"], dtypes[i], kinds[i]) for i in range(n)]
    return manifest, stored


# ---------------------------------------------------------------------------
# step checkpoints
# ---------------------------------------------------------------------------


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save(path: str, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous atomic save of ``tree`` (tensors, anywhere) as step
    ``step`` under ``path``; ``extra`` must be JSON-serializable. Returns
    the checkpoint's directory."""
    return _write(os.path.join(path, f".tmp-{step}"), _step_dir(path, step),
                  tree, {"step": step}, extra)


def latest_step(path: str) -> int | None:
    """The newest committed step under ``path`` (None: there is none)."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and os.path.exists(os.path.join(path, d, COMMIT))]
    return max(steps) if steps else None


def restore(path: str, step: int, like_tree, device="cuda"):
    """Load step ``step`` into the structure of ``like_tree``: (tree,
    extra). A leaf that is a tensor in ``like_tree`` comes back as a
    tensor on ``device``, any other leaf as an array. Raises ValueError
    when the stored structure is another one."""
    d = _step_dir(path, step)
    if not os.path.exists(os.path.join(d, COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    manifest, stored = _read(d)
    like, treedef = tree_flatten(like_tree)
    if manifest.get("tree_hash") not in (None, _tree_hash(treedef)) \
            or len(like) != len(stored):
        raise ValueError("checkpoint structure mismatch (different model?)")
    leaves = []
    for x, (a, dt, _) in zip(like, stored):
        is_torch = isinstance(x, torch.Tensor)
        leaf = _from_savable(a, dt, is_torch)
        leaves.append(leaf.to(device) if is_torch else leaf)
    return treedef.unflatten(leaves), manifest["extra"]


def gc_old(path: str, keep: int) -> None:
    """Delete all but the newest ``keep`` committed steps."""
    if not os.path.isdir(path):
        return
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and os.path.exists(os.path.join(path, d, COMMIT)))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d))


class AsyncCheckpointer:
    """Saves on one worker thread behind a queue of one (a second submit
    waits for the first save: back-pressure, not unbounded host memory).
    ``submit`` copies every leaf to the host before it returns, so the
    caller may update its tensors in place at once; a save's error is
    raised by the next ``submit`` or by ``close``."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self.q: queue.Queue = queue.Queue(maxsize=1)
        self.errors: list[Exception] = []
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                save(self.path, step, tree, extra)
                gc_old(self.path, self.keep)
            except Exception as e:  # surfaced on the next submit / close
                self.errors.append(e)
            finally:
                self.q.task_done()

    def submit(self, step: int, tree, extra: dict | None = None) -> None:
        if self.errors:
            raise self.errors[0]
        self.q.put((step, to_host(tree), extra))

    def close(self) -> None:
        self.q.join()
        self.q.put(None)
        self._t.join()
        if self.errors:
            raise self.errors[0]


# ---------------------------------------------------------------------------
# mini-caches
# ---------------------------------------------------------------------------


def save_mini(path: str, tree, extra: dict | None = None) -> str:
    """Atomically save ``tree`` (an evacuated mini-cache, or any small
    tree of tensors) into directory ``path``; ``extra`` must be
    JSON-serializable. Returns ``path``."""
    parent = os.path.dirname(path) or "."
    return _write(os.path.join(parent, f".tmp-{os.path.basename(path)}"), path,
                  tree, {}, extra)


def load_mini(path: str, treedef: TreeDef | None = None):
    """Inverse of ``save_mini``: ``(tree, extra)``. With ``treedef`` (e.g.
    cached by a ``SessionStore`` from its first park) the leaves are
    rebuilt into that structure after its fingerprint is checked; with
    None the flat leaf list is returned. Raises FileNotFoundError for a
    directory without ``COMMIT`` and ValueError for another structure."""
    if not os.path.exists(os.path.join(path, COMMIT)):
        raise FileNotFoundError(f"no committed mini-cache at {path}")
    manifest, stored = _read(path)
    leaves = [_from_savable(*leaf) for leaf in stored]
    if treedef is None:
        return leaves, manifest["extra"]
    if manifest.get("tree_hash") not in (None, _tree_hash(treedef)):
        raise ValueError("mini-cache structure mismatch (different engine?)")
    return treedef.unflatten(leaves), manifest["extra"]
