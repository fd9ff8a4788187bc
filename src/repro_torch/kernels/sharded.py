"""KV-head lanes of the multi-device serving engine.

The torch port of ``repro/kernels/sharded.py``. One controller (one
Python process, one ``SlotServer``) drives a ``(dp, kv)`` grid of torch
devices, which may repeat a device: ``("cpu",) * n`` on the CPU,
``("cuda:0",) * n`` on one card, ``cuda:0 .. n-1`` on several. The
compressed pool payloads, residual buffers and channel permutations are
split by whole KV heads over ``kv``: each lane keeps its own per-layer
caches over its contiguous head block, on its own device. The page
ledger and the per-row counters are replicated in every lane, so the host
scheduler reads one source of truth (lane (0, 0)'s).

The model code runs every projection, norm, MLP and head once, on the
controller, at the single-device shapes. Each lane does its cache writes
(compress, append, commit) and its decode-attention launch over its head
block; GQA query heads group contiguously by KV head, so one slice serves
q, k and v. Every per-head computation is head-independent, so a lane's
bytes and outputs are the single-device run's head block, and ``merge``
assembles the full tensor by concatenating blocks and selecting rows:
no float is added, and mesh == single-device holds bitwise.

Data-parallel rows compose over ``dp``: cache state stays replicated
across ``dp`` (every lane runs the same appends), and only the attention
read is partitioned. A lane reads through ``mask_read`` (rows it does not
own span zero tokens) and ``merge`` takes each row from its owner. A batch
that does not divide ``dp`` is computed by every dp lane, still exact.

There is no module-global lane: the mesh travels with the cache
(``MeshCache``), so no state outlives a call.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.cache import LayerKVCache
from ..distributed.sharding import head_dims
from ..utils import tree_flatten

KV_AXIS = "kv"
DP_AXIS = "dp"


@dataclasses.dataclass(frozen=True)
class Lane:
    """One lane's coordinates in the ``(dp, kv)`` grid and its device (None
    for the single-device lane: the caller's tensors stay where they are)."""

    n_kv: int = 1
    n_dp: int = 1
    kv: int = 0
    dp: int = 0
    device: torch.device | None = None

    # -- head axis (kv) -----------------------------------------------------
    def heads(self, h: int) -> int:
        """Local head count for an ``h``-head global axis."""
        if h % self.n_kv:
            raise ValueError(f"{h} heads do not split over {self.n_kv} kv lanes")
        return h // self.n_kv

    def split(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This lane's contiguous head block along ``axis`` (a view). Works
        for query heads too (H = G * H_kv, grouped contiguously by KV head)."""
        loc = self.heads(x.shape[axis])
        return x if loc == x.shape[axis] else x.narrow(axis, self.kv * loc, loc)

    def put(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """The head block along ``axis`` on this lane's device."""
        x = self.split(x, axis)
        return x if self.device is None else x.to(self.device)

    def merge(self, blocks, axis: int, rows: bool = False) -> torch.Tensor:
        """The full tensor from every lane's block, in lane order (dp-major;
        entries the merge does not read may be None): the kv lanes' head
        blocks concatenated along ``axis``, and, when ``rows`` (the dp
        lanes partitioned the rows, ``owned_rows``), each dp lane's own
        rows (the row dim is 0). Concatenation and slicing only: every
        cell is the value its lane computed."""
        def heads(d: int, sel=slice(None)):
            parts = [b[sel] for b in blocks[d * self.n_kv:(d + 1) * self.n_kv]]
            return parts[0] if len(parts) == 1 else torch.cat(parts, axis)

        if not rows:
            return heads(0)
        per = blocks[0].shape[0] // self.n_dp
        return torch.cat([heads(d, slice(d * per, (d + 1) * per))
                          for d in range(self.n_dp)], 0)

    # -- row axis (dp) ------------------------------------------------------
    def owned_rows(self, n_rows: int) -> torch.Tensor | None:
        """Bool [n_rows] mask of the rows this dp lane computes, or None
        when rows are not partitioned (``n_dp == 1``, or ``n_rows`` not
        divisible: every dp lane then computes every row)."""
        if self.n_dp == 1 or n_rows % self.n_dp:
            return None
        per = n_rows // self.n_dp
        return torch.arange(n_rows, device=self.device) // per == self.dp

    def mask_read(self, layer: LayerKVCache, owned) -> LayerKVCache:
        """A read view of ``layer`` whose rows this lane does not own span
        no tokens. Only the read is masked: appends and commits use the
        real counters, so the replicated state stays the same in every
        lane."""
        if owned is None:
            return layer
        zero = lambda n: torch.where(owned, n, torch.zeros_like(n))
        return dataclasses.replace(layer, n_comp=zero(layer.n_comp),
                                   n_resid=zero(layer.n_resid))


SINGLE = Lane()  # the single-device engine's one lane


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, kv)`` grid of devices: lane (d, j) runs on
    ``devices[d * n_kv + j]``. ``shape`` and ``axis_names`` are the
    reference mesh's, so the sharding rules take it."""

    n_dp: int
    n_kv: int
    devices: tuple

    def __post_init__(self):
        if len(self.devices) != self.n_dp * self.n_kv:
            raise ValueError(f"mesh {self.n_dp}x{self.n_kv} takes "
                             f"{self.n_dp * self.n_kv} devices, got {len(self.devices)}")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.n_dp, KV_AXIS: self.n_kv}

    @property
    def axis_names(self) -> tuple:
        return (DP_AXIS, KV_AXIS)

    @property
    def lanes(self) -> list[Lane]:
        return [Lane(self.n_kv, self.n_dp, i % self.n_kv, i // self.n_kv, dev)
                for i, dev in enumerate(self.devices)]


# ---------------------------------------------------------------------------
# Caches cut into lanes and put back together
# ---------------------------------------------------------------------------


def _copy(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, copy=True, memory_format=torch.contiguous_format)


def split_layer(layer: LayerKVCache, lane: Lane, mesh: Mesh) -> LayerKVCache:
    """A copy of ``lane``'s head block of one layer's cache, on the lane's
    device; the ledger and counters are copied whole. Byte-exact."""
    leaves, treedef = tree_flatten(layer)
    return treedef.unflatten([
        _copy(x if d is None else lane.split(x, d), lane.device)
        for x, d in zip(leaves, head_dims(layer, mesh))])


def join_layers(blocks: list[LayerKVCache], mesh: Mesh, device) -> LayerKVCache:
    """One layer's full-head cache on ``device`` from the ``n_kv`` head
    blocks of one dp row (the inverse of ``split_layer``); the ledger and
    counters are the first block's. Byte-exact."""
    flat = [tree_flatten(b)[0] for b in blocks]
    treedef = tree_flatten(blocks[0])[1]
    dims = head_dims(blocks[0], mesh, local=True)
    return treedef.unflatten([
        _copy(xs[0], device) if d is None
        else torch.cat([x.to(device) for x in xs], d)
        for d, xs in zip(dims, zip(*flat))])


@dataclasses.dataclass(frozen=True)
class PermView:
    """A layer's full-head channel permutation ``chan_perm`` [B, H_kv, D]."""

    chan_perm: torch.Tensor


class MeshCache:
    """A mesh engine's decode cache: ``lanes[l]`` is lane ``l``'s list of
    per-layer caches over its head block, on its device (lane order as
    ``Mesh.lanes``). Indexing gives what the host scheduler reads of a
    layer (``LedgerView``)."""

    def __init__(self, mesh: Mesh, lanes: list[list[LayerKVCache]]):
        self.mesh = mesh
        self.lanes = lanes

    def __len__(self) -> int:
        return len(self.lanes[0])

    def __getitem__(self, i: int) -> LedgerView:
        return LedgerView(self, i)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class LedgerView:
    """Layer ``i`` of a ``MeshCache`` as the host scheduler reads it: lane
    (0, 0)'s replicated page ledger and counters, and the channel
    permutations over every head (``k`` / ``v``: a ``PermView``)."""

    def __init__(self, cache: MeshCache, i: int):
        self._mesh = cache.mesh
        self._layers = [layers[i] for layers in cache.lanes]
        first = self._layers[0]
        self.pages, self.n_comp, self.n_resid = first.pages, first.n_comp, first.n_resid

    def _perms(self, name: str) -> PermView | None:
        if getattr(self._layers[0], name) is None:
            return None
        dev = self._layers[0].n_comp.device
        return PermView(self._mesh.lanes[0].merge(
            [getattr(x, name).chan_perm.to(dev) for x in self._layers], 1))

    @property
    def k(self) -> PermView | None:
        return self._perms("k")

    @property
    def v(self) -> PermView | None:
        return self._perms("v")


def lane_lists(cache) -> list[tuple[Lane, list[LayerKVCache]]]:
    """(lane, its per-layer caches) of every lane of ``cache``: a
    ``MeshCache``'s lanes, or the single-device list as one lane."""
    if isinstance(cache, MeshCache):
        return list(zip(cache.mesh.lanes, cache.lanes))
    return [(SINGLE, cache)]


def split_cache(cache: list[LayerKVCache], mesh: Mesh) -> MeshCache:
    """A single-device cache cut into the mesh's lanes (copies)."""
    return MeshCache(mesh, [[split_layer(layer, lane, mesh) for layer in cache]
                            for lane in mesh.lanes])


def join_cache(cache: MeshCache, device) -> list[LayerKVCache]:
    """A mesh cache put back together as the single-device cache (dp row
    0's lanes; copies on ``device``)."""
    rows = cache.lanes[:cache.mesh.n_kv]
    return [join_layers([lane[i] for lane in rows], cache.mesh, device)
            for i in range(len(cache))]


def ledgers_agree(cache: MeshCache) -> bool:
    """Every lane's page ledger and counters equal lane (0, 0)'s (a device
    read: debug checks only); dp lanes of one kv block hold equal bytes."""
    def ledger(layer):
        out = [layer.n_comp, layer.n_resid]
        if layer.pages is not None:
            p = layer.pages
            out += [p.page_table, p.free[:int(p.n_free)], p.n_free, p.ref]
        return out

    same = lambda xs, ys: all(torch.equal(a, b.to(a.device)) for a, b in zip(xs, ys))
    n_kv = cache.mesh.n_kv
    for i in range(len(cache)):
        first = ledger(cache.lanes[0][i])
        for l, layers in enumerate(cache.lanes):
            if not (same(first, ledger(layers[i])) and same(
                    tree_flatten(cache.lanes[l % n_kv][i])[0],
                    tree_flatten(layers[i])[0])):
                return False
    return True
