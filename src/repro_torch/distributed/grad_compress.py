"""Gradient compression for data-parallel all-reduce: the paper's own
machinery (token-wise quantization) applied to gradients, with
error-feedback residuals; the torch port of
``repro/distributed/grad_compress.py``.

Each row of ``row`` values of a flattened gradient gets its own (scale,
zero); the integers are range-reduced exactly like the KV pipeline's.
``roundtrip_grads`` models the wire codec (compress then decompress, per
replica); ``wire_bits`` is the analytic on-wire size.
``compressed_psum_mean`` is the compressed exchange itself over a
``torch.distributed`` group: an all-gather of the quantized payload and
its per-row metadata (the bytes on the wire are the compressed bytes),
then a local dequantize and mean. No training path calls it, as in the
reference: the train step's exchange is uncompressed.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import div, tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    bits: int = 4  # integer width on the wire
    row: int = 1024  # quantization row length
    error_feedback: bool = True


def _quant_rows(g: torch.Tensor, cfg: GradCompressConfig):
    """g: f32 [R, row] -> (q uint8, scale [R, 1], zero [R, 1])."""
    lo = g.amin(dim=1, keepdim=True)
    hi = g.amax(dim=1, keepdim=True)
    maxq = 2 ** cfg.bits - 1
    scale = torch.where(hi > lo, div(hi - lo, maxq), torch.ones_like(lo))
    q = torch.clamp(torch.round((g - lo) / scale), 0, maxq)
    return q.to(torch.uint8), scale, lo


def _dequant_rows(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor):
    return q.to(torch.float32) * scale + zero


def compress_leaf(g: torch.Tensor, cfg: GradCompressConfig,
                  resid: torch.Tensor | None):
    """Quantize one gradient leaf (plus its error-feedback residual).
    Returns (q, scale, zero, the new residual or None)."""
    flat = g.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % cfg.row))
    if resid is not None:
        flat = flat + resid
    rows = flat.reshape(-1, cfg.row)
    q, s, z = _quant_rows(rows, cfg)
    new_resid = None
    if cfg.error_feedback:
        new_resid = (rows - _dequant_rows(q, s, z)).reshape(-1)
    return q, s, z, new_resid


def decompress_leaf(q, s, z, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return _dequant_rows(q, s, z).reshape(-1)[:n].reshape(shape)


def roundtrip_grads(grads, cfg: GradCompressConfig, resids):
    """Per-replica compress -> decompress of every leaf (the wire codec;
    averaging across replicas then runs on the dequantized values, as a
    compressed all-gather and a local reduce would). Returns (grads,
    residuals); a leaf without error feedback gets an empty residual."""
    flat, treedef = tree_flatten(grads)
    r_flat = tree_flatten(resids)[0] if resids is not None else [None] * len(flat)
    out, new_r = [], []
    for g, r in zip(flat, r_flat):
        q, s, z, nr = compress_leaf(g, cfg, r)
        out.append(decompress_leaf(q, s, z, g.shape).to(g.dtype))
        new_r.append(nr if nr is not None else
                     torch.zeros(0, dtype=torch.float32, device=g.device))
    return treedef.unflatten(out), treedef.unflatten(new_r)


def init_residuals(params, cfg: GradCompressConfig):
    """Zero f32 residuals, each leaf's size padded to whole rows."""
    return tree_map(lambda p: torch.zeros(p.numel() + (-p.numel()) % cfg.row,
                                          dtype=torch.float32, device=p.device),
                    params)


def wire_bits(params, cfg: GradCompressConfig) -> int:
    """Analytic on-wire bits of one compressed gradient exchange."""
    total = 0
    for p in tree_flatten(params)[0]:
        n = p.numel()
        total += n * cfg.bits + -(-n // cfg.row) * 64  # f32 scale + zero a row
    return total


def compression_ratio(params, cfg: GradCompressConfig) -> float:
    raw = sum(p.numel() for p in tree_flatten(params)[0]) * 32
    return raw / wire_bits(params, cfg)


def compressed_psum_mean(grads, cfg: GradCompressConfig, group=None):
    """Each replica quantizes its local leaves; the group all-gathers only
    the integers and the per-row (scale, zero); every replica then
    dequantizes each replica's rows and takes their mean, adding in rank
    order from zero and dividing once. ``group``: a process group
    (``torch.distributed.group.WORLD`` for every rank); None is the
    one-replica case, with nothing exchanged. Error feedback is the
    caller's (``roundtrip_grads``' residuals), as in the reference."""
    from .exchange import all_gather

    if group is None:
        n, gather = 1, lambda x: [x]
    else:
        import torch.distributed as dist

        n = dist.get_world_size(group)
        gather = lambda x: all_gather(x, group, n)

    def leaf(g):
        q, s, z, _ = compress_leaf(g, cfg, None)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=g.device)
        for qi, si, zi in zip(gather(q), gather(s), gather(z)):
            acc.add_(_dequant_rows(qi, si, zi))
        mean = div(acc, n).reshape(-1)
        return mean[:g.numel()].reshape(g.shape).to(g.dtype)

    return tree_map(leaf, grads)
