"""Per-pack adaptive bit-packing: the paper's STORAGE format (section
III-B3), the torch port of ``repro/core/bitpack.py``.

A *pack* is ``pack_size`` consecutive quantized integers along the context
direction. Per pack the format stores its minimum (subtracted before
encoding), its width ``ceil(log2(range + 1))`` (0 for a constant pack) and
``pack_size * width`` payload bits. Sizes are reported in bits and include
all metadata, so compression ratios follow the paper's accounting (KIVI
2-bit / 64-group gives 6.4x, 3-bit 4.57x with the same formulas).

The bitstream is column-major: every pack of column 0 first, then column
1, ...; values go LSB-first into 32-bit words and a value that straddles a
word boundary is split across the two words. Words are held as int32 with
the uint32 bits (PyTorch cannot shift uint32; see ``core/tiered.py``).

``pack_block`` / ``unpack_block`` take one block ``[N, D]`` or a batch
``[..., N, D]`` of them and run as tensor ops on the blocks' device: each
value's bit offset comes from an exclusive cumsum of ``width * pack_size``
over (column, pack), and its low part and its spill are added to their
words. The bit fields are disjoint, so the integer adds give the same
words in any order.
"""
from __future__ import annotations

import dataclasses

import torch

# ---------------------------------------------------------------------------
# Size model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SizeModel:
    """Metadata field widths used in CR accounting.

    width_field_bits: per-pack encoded-length field (widths 0..15).
    min_field_bits:   per-pack minimum field.
    token_meta_bits:  per-(token, head) quantization metadata: fp16 scale +
      fp16 zero, as in KIVI's accounting.
    raw_bits:         uncompressed element width (fp16).
    """

    width_field_bits: int = 4
    min_field_bits: int = 8
    token_meta_bits: int = 32
    raw_bits: int = 16


DEFAULT_SIZE_MODEL = SizeModel()


def bits_required(rng) -> torch.Tensor:
    """ceil(log2(range + 1)), 0 for a constant pack: the exact bit length of
    each non-negative integer (int64), as the reference's float64 ``log2``
    gives it (14 bits at 8192, 16 at 32768). The compute tier's widths come
    from ``utils.bits_required`` instead, which reproduces XLA's float32
    logarithm."""
    r = torch.as_tensor(rng)
    # frexp: r = m * 2**e with m in [0.5, 1), so e is r's bit length
    # (frexp(0) has e = 0); float64 holds every integer below 2**53
    return torch.frexp(r.to(torch.float64)).exponent.to(torch.int64)


def _packs(q: torch.Tensor, pack_size: int, axis: int) -> torch.Tensor:
    """q with ``axis`` moved first and split into packs: [P, pack_size, ...]."""
    q = torch.movedim(torch.as_tensor(q), axis, 0)
    n = q.shape[0]
    if n % pack_size:
        raise ValueError(f"{n} % {pack_size} != 0")
    return q.reshape(n // pack_size, pack_size, *q.shape[1:])


def packed_payload_bits(q, pack_size: int, axis: int = 0) -> int:
    """Analytic payload size (no metadata) of per-pack adaptive packing."""
    qp = _packs(q, pack_size, axis)
    rng = qp.amax(dim=1).to(torch.int64) - qp.amin(dim=1).to(torch.int64)
    return int(bits_required(rng).sum()) * pack_size


def packed_total_bits(q, pack_size: int, axis: int = 0,
                      size_model: SizeModel = DEFAULT_SIZE_MODEL,
                      n_token_meta: int | None = None) -> int:
    """Payload + per-pack metadata + per-token quantization metadata.

    n_token_meta: number of (token, head) quantization units covered by q;
      defaults to q.shape[axis] (token-wise quantization of one head's block).
    """
    q = torch.as_tensor(q)
    n = q.shape[axis]
    n_packs = (n // pack_size) * (q.numel() // n)
    payload = packed_payload_bits(q, pack_size, axis)
    meta = n_packs * (size_model.width_field_bits + size_model.min_field_bits)
    if n_token_meta is None:
        n_token_meta = n
    return payload + meta + n_token_meta * size_model.token_meta_bits


def compression_ratio(q, pack_size: int, axis: int = 0,
                      size_model: SizeModel = DEFAULT_SIZE_MODEL,
                      n_token_meta: int | None = None) -> float:
    raw = torch.as_tensor(q).numel() * size_model.raw_bits
    return raw / packed_total_bits(q, pack_size, axis, size_model, n_token_meta)


# ---------------------------------------------------------------------------
# Actual bitstream (round-trip exact)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedBlock:
    """One bit-packed 2D block (the storage unit of ``block_format.py``).

    Packing runs along axis 0 of ``shape`` (the context direction); each of
    the ``shape[1]`` columns is split into ``shape[0] / pack_size`` packs.
    """

    payload: torch.Tensor  # int32 [n_words] (uint32 bits)
    widths: torch.Tensor  # uint8 [n_cols, n_packs]
    mins: torch.Tensor  # int32 [n_cols, n_packs]
    pack_size: int
    shape: tuple[int, int]
    payload_bits: int

    def total_bits(self, size_model: SizeModel = DEFAULT_SIZE_MODEL) -> int:
        n_packs = self.widths.numel()
        return self.payload_bits + n_packs * (
            size_model.width_field_bits + size_model.min_field_bits)


@dataclasses.dataclass
class PackedBlocks:
    """A batch of bit-packed blocks of one shape, ``pack_block`` of
    ``[..., N, D]``: block ``i``'s words are ``payload[i, :n_words[i]]``,
    the rest of its row is zero."""

    payload: torch.Tensor  # int32 [..., max n_words]
    n_words: torch.Tensor  # int64 [...]
    widths: torch.Tensor  # uint8 [..., n_cols, n_packs]
    mins: torch.Tensor  # int32 [..., n_cols, n_packs]
    pack_size: int
    shape: tuple[int, int]
    payload_bits: torch.Tensor  # int64 [...]

    def total_bits(self, size_model: SizeModel = DEFAULT_SIZE_MODEL) -> torch.Tensor:
        """Each block's ``PackedBlock.total_bits``, int64 [...]."""
        n_packs = self.widths.shape[-1] * self.widths.shape[-2]
        return self.payload_bits + n_packs * (
            size_model.width_field_bits + size_model.min_field_bits)

    def blocks(self) -> list[PackedBlock]:
        """The batch as ``PackedBlock``s in row-major order of its leading
        dims (views of this batch's tensors)."""
        payload = self.payload.reshape(-1, self.payload.shape[-1])
        widths = self.widths.reshape(-1, *self.widths.shape[-2:])
        mins = self.mins.reshape(-1, *self.mins.shape[-2:])
        n_words = self.n_words.reshape(-1).tolist()
        bits = self.payload_bits.reshape(-1).tolist()
        return [PackedBlock(payload[i, :n_words[i]], widths[i], mins[i],
                            self.pack_size, self.shape, bits[i])
                for i in range(len(bits))]


def _bit_positions(widths: torch.Tensor, pack_size: int):
    """Bit offsets of every value of a batch of blocks.

    widths: int64 [B, D, P] (column-major pack order). Returns (pos int64
    [B, D, P, pack_size], width int64 [B, D, P, 1], payload bits int64 [B]).
    """
    B = widths.shape[0]
    bits = (widths * pack_size).reshape(B, -1)
    start = (torch.cumsum(bits, dim=1) - bits).reshape(widths.shape)
    step = torch.arange(pack_size, device=widths.device, dtype=torch.int64)
    w = widths.unsqueeze(-1)
    return start.unsqueeze(-1) + step * w, w, bits.sum(dim=1)


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_block(q, pack_size: int):
    """Bit-pack integer blocks along their context axis.

    q: [N, D] -> ``PackedBlock``; [..., N, D] -> ``PackedBlocks``. Values
    are relative to their pack's minimum, so any integer block packs."""
    q = torch.as_tensor(q).to(torch.int64)
    *lead, n, d = q.shape
    if n % pack_size:
        raise ValueError(f"block of {n} tokens is not a multiple of pack {pack_size}")
    n_packs = n // pack_size
    qb = q.reshape(-1, n_packs, pack_size, d)  # [B, P, ps, D]
    mins = qb.amin(dim=2)  # [B, P, D]
    widths = bits_required(qb.amax(dim=2) - mins)
    B = qb.shape[0]
    # column-major: every pack of column 0 first
    w_cm = widths.transpose(1, 2)  # [B, D, P]
    pos, w, payload_bits = _bit_positions(w_cm, pack_size)
    vals = (qb - mins.unsqueeze(2)).permute(0, 3, 1, 2)  # [B, D, P, ps]
    word, shift = pos >> 5, pos & 31
    low = (vals << shift) & 0xFFFFFFFF
    spill = vals >> (32 - shift)  # the part past the word (0 if none)
    n_words = (payload_bits + 31) // 32
    max_words, max_width = (torch.stack([n_words.max(), w_cm.max()]).tolist()
                            if B else (0, 0))
    if max_width > 32:
        raise ValueError(f"a pack {max_width} bits wide; the format holds up to 32")
    buf = torch.zeros((B, max_words + 2), dtype=torch.int64, device=q.device)
    buf.scatter_add_(1, word.reshape(B, -1), low.reshape(B, -1))
    buf.scatter_add_(1, (word + 1).reshape(B, -1), spill.reshape(B, -1))
    payload = _to_int32_bits(buf[:, :max_words])
    widths_out = w_cm.to(torch.uint8)
    mins_out = mins.transpose(1, 2).to(torch.int32)
    if not lead:
        return PackedBlock(payload[0], widths_out[0], mins_out[0], pack_size,
                           (n, d), int(payload_bits[0]))
    return PackedBlocks(payload.reshape(*lead, max_words), n_words.reshape(lead),
                        widths_out.reshape(*lead, d, n_packs),
                        mins_out.reshape(*lead, d, n_packs), pack_size, (n, d),
                        payload_bits.reshape(lead))


def unpack_block(blk) -> torch.Tensor:
    """``PackedBlock`` -> int64 [N, D]; ``PackedBlocks`` -> int64 [..., N, D]."""
    n, d = blk.shape
    ps = blk.pack_size
    batched = isinstance(blk, PackedBlocks)
    lead = tuple(blk.payload_bits.shape) if batched else ()
    widths = blk.widths.reshape(-1, d, n // ps).to(torch.int64)
    mins = blk.mins.reshape(-1, d, n // ps).to(torch.int64)
    B = widths.shape[0]
    words = blk.payload.reshape(B, -1).to(torch.int64) & 0xFFFFFFFF
    # two zero words past the end: a value's spill word, and the offsets of
    # trailing width-0 packs, stay in range
    words = torch.nn.functional.pad(words, (0, 2))
    pos, w, _ = _bit_positions(widths, ps)
    word, shift = (pos >> 5).reshape(B, -1), (pos & 31).reshape(B, -1)
    lo = words.gather(1, word) >> shift
    hi = words.gather(1, word + 1) << (32 - shift)
    mask = torch.bitwise_left_shift(torch.ones_like(w), w) - 1
    vals = ((lo | hi).reshape(pos.shape) & mask) + mins.unsqueeze(-1)
    out = vals.reshape(B, d, n).transpose(1, 2)  # [B, N, D]
    return out.reshape(*lead, n, d) if batched else out[0]
