"""Block-independent compressed storage with seamless appending (paper
section III-B4), the torch port of ``repro/core/block_format.py``.

Each 64-token block of each kv head is compressed on its own (quantize ->
repack -> bit-pack) and serialized as a self-describing chunk; chunks
append to a flat stream without touching earlier ones. A directory of
(head, token_start, offset) entries makes any block addressable on its
own. This is the storage / offload tier (the paper's exact format); the
compute tier is ``tiered.py``.

``append`` compresses one block as the reference does. ``extend`` runs
every block of ``[H, L, D]`` tensors through the same steps at once, on
the tensors' device, and fills the same entries.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import div
from .bitpack import (
    DEFAULT_SIZE_MODEL,
    PackedBlock,
    PackedBlocks,
    SizeModel,
    pack_block,
    unpack_block,
)
from .quantization import QuantConfig
from .repacking import repack

BLOCK = 64  # tokens a block of ``extend`` (the paper's block)
# blocks a step of ``extend``: quantize, repack and pack this many at once
EXTEND_CHUNK_BLOCKS = 4096


@dataclasses.dataclass
class BlockEntry:
    head: int
    token_start: int
    n_tokens: int
    perm: torch.Tensor  # int64 [n_tokens]: the joint K/V row permutation
    k_block: PackedBlock
    v_block: PackedBlock
    k_meta: torch.Tensor  # f32 [n_tokens, 2]: (scale, zero) per token
    v_meta: torch.Tensor


def quant_tokenwise(x: torch.Tensor, cfg: QuantConfig):
    """The storage tier's token-wise quantizer, in float32 over the last
    axis: x [..., N, D] -> (q int64 [..., N, D], safe scale f32 [..., N],
    lo f32 [..., N])."""
    x = x.to(torch.float32)
    lo = x.amin(dim=-1, keepdim=True)
    rng = x.amax(dim=-1, keepdim=True) - lo
    scale = div(rng, cfg.max_q) if cfg.bits is not None else cfg.rel_scale * rng
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((x - lo) / safe), 0, cfg.max_q).to(torch.int64)
    return q, safe[..., 0], lo[..., 0]


@dataclasses.dataclass
class EncodedBlocks:
    """``encode_blocks`` of a batch [B, N, D] of K and V blocks."""

    perm: torch.Tensor  # int64 [B, N]
    k: PackedBlocks
    v: PackedBlocks
    k_meta: torch.Tensor  # f32 [B, N, 2]
    v_meta: torch.Tensor


def _meta(scale: torch.Tensor, lo: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return torch.stack([scale.gather(-1, perm), lo.gather(-1, perm)], dim=-1)


def encode_blocks(k: torch.Tensor, v: torch.Tensor, pack_size: int, repack_mode: str,
                  k_quant: QuantConfig, v_quant: QuantConfig) -> EncodedBlocks:
    """Quantize, repack and bit-pack a batch of blocks k, v [B, N, D] at
    once, each block on its own as ``CompressedKVStream.append`` does."""
    qk, sk, zk = quant_tokenwise(k, k_quant)
    qv, sv, zv = quant_tokenwise(v, v_quant)
    perm = repack(qk, qv, pack_size, repack_mode)
    rows = perm.unsqueeze(-1)
    return EncodedBlocks(
        perm=perm,
        k=pack_block(qk.gather(-2, rows.expand_as(qk)), pack_size),
        v=pack_block(qv.gather(-2, rows.expand_as(qv)), pack_size),
        k_meta=_meta(sk, zk, perm), v_meta=_meta(sv, zv, perm))


@dataclasses.dataclass
class CompressedKVStream:
    """Appendable stream of independently compressed KV blocks."""

    pack_size: int = 8
    repack_mode: str = "greedy_joint"
    k_quant: QuantConfig = dataclasses.field(
        default_factory=lambda: QuantConfig(rel_scale=0.1, granularity="token"))
    v_quant: QuantConfig = dataclasses.field(
        default_factory=lambda: QuantConfig(rel_scale=0.2, granularity="token"))
    entries: list[BlockEntry] = dataclasses.field(default_factory=list)

    # -- encode ------------------------------------------------------------
    def append(self, k: torch.Tensor, v: torch.Tensor, head: int, token_start: int):
        """Compress one block. k, v: [n_tokens, D] float."""
        enc = encode_blocks(k[None], v[None], self.pack_size, self.repack_mode,
                            self.k_quant, self.v_quant)
        entry = BlockEntry(head=head, token_start=token_start, n_tokens=k.shape[0],
                           perm=enc.perm[0], k_block=enc.k.blocks()[0],
                           v_block=enc.v.blocks()[0], k_meta=enc.k_meta[0],
                           v_meta=enc.v_meta[0])
        self.entries.append(entry)
        return entry

    def extend(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Compress every ``BLOCK``-token block of k, v [H, L, D] (L a
        multiple of ``BLOCK``) at once, in chunks of ``EXTEND_CHUNK_BLOCKS``
        blocks. The entries are those of ``append`` over heads, then
        blocks: head h, token_start b * BLOCK."""
        H, L, D = k.shape
        if L % BLOCK:
            raise ValueError(f"context {L} is not a multiple of block {BLOCK}")
        nb = L // BLOCK
        kb = k.reshape(H * nb, BLOCK, D)
        vb = v.reshape(H * nb, BLOCK, v.shape[-1])
        for s in range(0, H * nb, EXTEND_CHUNK_BLOCKS):
            enc = encode_blocks(kb[s:s + EXTEND_CHUNK_BLOCKS],
                                vb[s:s + EXTEND_CHUNK_BLOCKS], self.pack_size,
                                self.repack_mode, self.k_quant, self.v_quant)
            for i, (kp, vp) in enumerate(zip(enc.k.blocks(), enc.v.blocks())):
                h, b = divmod(s + i, nb)
                self.entries.append(BlockEntry(
                    head=h, token_start=b * BLOCK, n_tokens=BLOCK, perm=enc.perm[i],
                    k_block=kp, v_block=vp, k_meta=enc.k_meta[i],
                    v_meta=enc.v_meta[i]))

    # -- decode ------------------------------------------------------------
    def decode_block(self, idx: int, restore_order: bool = False):
        """(k, v) float64 [n_tokens, D], as the reference computes them
        (int64 x float32 promotes to float64): one rounded product, then
        one rounded add, never fused."""
        e = self.entries[idx]
        k = _dequant(unpack_block(e.k_block), e.k_meta)
        v = _dequant(unpack_block(e.v_block), e.v_meta)
        if restore_order:
            inv = torch.argsort(e.perm)
            k, v = k[inv], v[inv]
        return k, v

    def decode_head(self, head: int, restore_order: bool = False):
        ks, vs = [], []
        for i, e in enumerate(self.entries):
            if e.head == head:
                k, v = self.decode_block(i, restore_order)
                ks.append(k)
                vs.append(v)
        return torch.cat(ks, dim=0), torch.cat(vs, dim=0)

    # -- accounting ---------------------------------------------------------
    def total_bits(self, size_model: SizeModel = DEFAULT_SIZE_MODEL) -> int:
        bits = 0
        for e in self.entries:
            bits += e.k_block.total_bits(size_model) + e.v_block.total_bits(size_model)
            bits += 2 * e.n_tokens * size_model.token_meta_bits
        return bits

    def raw_bits(self, size_model: SizeModel = DEFAULT_SIZE_MODEL) -> int:
        vals = sum(e.n_tokens * (e.k_block.shape[1] + e.v_block.shape[1])
                   for e in self.entries)
        return vals * size_model.raw_bits

    def compression_ratio(self, size_model: SizeModel = DEFAULT_SIZE_MODEL) -> float:
        return self.raw_bits(size_model) / max(self.total_bits(size_model), 1)

    # -- serialization (flat stream: proves the append-only layout) ---------
    def serialize(self) -> tuple[torch.Tensor, list[dict]]:
        """(flat int32 words (uint32 bits), directory)."""
        words: list[torch.Tensor] = []
        directory: list[dict] = []
        off = 0
        for e in self.entries:
            k_words, v_words = len(e.k_block.payload), len(e.v_block.payload)
            directory.append({"head": e.head, "token_start": e.token_start,
                              "offset_words": off, "k_words": k_words,
                              "v_words": v_words})
            words += [e.k_block.payload, e.v_block.payload]
            off += k_words + v_words
        device = self.entries[0].perm.device if self.entries else "cpu"
        flat = torch.cat(words) if words else torch.zeros(0, dtype=torch.int32,
                                                          device=device)
        return flat, directory


def _dequant(q: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    meta = meta.to(torch.float64)
    return torch.add(torch.mul(q.to(torch.float64), meta[:, :1]), meta[:, 1:])
