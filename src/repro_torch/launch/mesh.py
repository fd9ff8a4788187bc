"""Training meshes over ``torch.distributed`` ranks (the torch port of
``repro/launch/mesh.py``).

A mesh is a grid of ranks, one process a device, laid out row-major over
its axes ``("data", "model")`` or ``("pod", "data", "model")``. A
function, not a module constant: importing this module touches no
process group. Without a process group the world is one rank on the
caller's device.

Each rank's ``TrainMesh`` knows its coordinates and the process groups
of the ranks it exchanges with: ``dp_group`` (its 'pod' x 'data' slice:
gradients), ``data_group`` (its 'data' line: ZeRO-1 moments) and
``model_group`` (its 'model' line: tensor parallelism). Every rank creates
every group, in the same order, as ``dist.new_group`` requires.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class SpecMesh:
    """Axis sizes only: what the sharding rules read."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(self.shape.values())


class TrainMesh(SpecMesh):
    """This rank's view of a mesh of ranks.

    ``shape`` (axis -> size), ``axis_names``, ``size`` and ``devices`` (the
    ranks as an array of the mesh's shape, for ``downscale_plan``) as a
    JAX mesh has them; ``rank``, ``coords`` (axis -> this rank's index),
    ``device``, ``dp_size`` / ``dp_index`` (row-major over 'pod' x
    'data': this rank's block of the global batch), ``data_size`` /
    ``data_index``, ``model_size`` / ``model_index``, and the groups
    ``dp_group`` / ``data_group`` / ``model_group`` (None is the default
    group, or no group at all in a world of one)."""

    def __init__(self, shape: dict, rank: int, device):
        super().__init__(shape)
        dims = tuple(self.shape.values())
        self.devices = np.arange(self.size).reshape(dims)
        self.rank = rank
        idx = np.unravel_index(rank, dims)
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self.device = torch.device(device)
        dp = [a for a in ("pod", "data") if a in self.shape]
        self.dp_size = math.prod(self.shape[a] for a in dp)
        self.dp_index = int(np.ravel_multi_index(
            [self.coords[a] for a in dp], [self.shape[a] for a in dp])) if dp else 0
        self.data_size = self.shape.get("data", 1)
        self.data_index = self.coords.get("data", 0)
        self.model_size = self.shape.get("model", 1)
        self.model_index = self.coords.get("model", 0)
        self.dp_group = self._group(dp)
        self.data_group = self._group(["data"] if "data" in self.shape else [])
        self.model_group = self._group(["model"] if "model" in self.shape else [])

    def model_lanes(self, seq_len: int):
        """This rank's 'model' line as an ``exchange.ModelGroup`` for a
        forward over ``seq_len`` positions (the stream is sequence-sharded
        when the line's size divides it), or None for a line of one."""
        if self.model_size == 1:
            return None
        from ..distributed.exchange import ModelGroup

        return ModelGroup(self.model_group, self.model_size, self.model_index,
                          seq=seq_len % self.model_size == 0)

    def _group(self, axes: list):
        """The group of ranks that differ from this one only along
        ``axes``; every rank builds every such group, in one order."""
        if self.size == 1 or math.prod(self.shape[a] for a in axes) == self.size:
            return None  # the whole world (or no group at all)
        import torch.distributed as dist

        names = self.axis_names
        keep = [i for i, a in enumerate(names) if a not in axes]
        classes: dict = {}
        for r in range(self.size):
            key = tuple(np.unravel_index(r, self.devices.shape)[i] for i in keep)
            classes.setdefault(key, []).append(r)
        mine = None
        for key in sorted(classes):
            g = dist.new_group(classes[key])
            if self.rank in classes[key]:
                mine = g
        return mine


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make(shape: tuple, axes: tuple, device) -> TrainMesh:
    world, rank = _world()
    size = math.prod(shape)
    if world < size:
        raise ValueError(f"Number of devices {world} must be >= the product "
                         f"of mesh_shape {shape}")
    if world > size:
        raise ValueError(f"Number of devices {world} must be == the product "
                         f"of mesh_shape {shape}: every rank is a device of "
                         "the mesh")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return TrainMesh(dict(zip(axes, shape)), rank, device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> TrainMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device)


def make_debug_mesh(data: int = 1, model: int = 1, device=None) -> TrainMesh:
    """A small mesh over the ranks that exist (tests on the CPU)."""
    return _make((data, model), ("data", "model"), device)
