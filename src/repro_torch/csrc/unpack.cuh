// K1: tier-tile decompression as a __device__ function.
//
// Replaces repro/kernels/unpack.py::decode_tier_tile (with unpack_words_2d,
// unpack_shifts_2d and broadcast_packwise), which every Pallas kernel of
// the JAX package inlines. decode_tier_value decodes ONE value of one
// channel row (K2, K5 call it per (channel, token)); decode_tier_run a run
// of consecutive tokens from words already loaded (K3, K4, K6, K7). Either
// way the results stay in registers: decoded values never reach device
// memory.
//
// Row layout (docs/formats.md): token l of a width-w tier sits in bits
// [(l % vpw) * w, (l % vpw + 1) * w) of 32-bit word l / vpw (vpw = 32 / w);
// its pack p = l / pack has an int8 min at min_row[p] and a 2-bit shift at
// bits [2 * (p % 4), 2 * (p % 4) + 2) of shift byte p / 4. The decoded
// integer is (stored << shift) + half + min with the mid-rise
// half = 2^(shift - 1) (0 when shift is 0).
#pragma once

#include <cstdint>

// log2_w: log2 of the tier width (0..4 for widths 1, 2, 4, 8, 16);
// log2_pack: log2 of the pack size (3 or 4 for packs of 8 or 16).
__device__ __forceinline__ int decode_tier_value(
    const int32_t* __restrict__ pay_row, const int8_t* __restrict__ min_row,
    const uint8_t* __restrict__ sft_row, int log2_w, int log2_pack, int l) {
  const int lvpw = 5 - log2_w;  // log2(values per word)
  const uint32_t word = static_cast<uint32_t>(__ldg(pay_row + (l >> lvpw)));
  const int bit = (l & ((1 << lvpw) - 1)) << log2_w;
  const uint32_t mask = (1u << (1 << log2_w)) - 1u;
  const int stored = static_cast<int>((word >> bit) & mask);
  const int p = l >> log2_pack;
  const int sh = (__ldg(sft_row + (p >> 2)) >> ((p & 3) * 2)) & 3;
  const int half = sh > 0 ? (1 << (sh - 1)) : 0;
  return (stored << sh) + half + static_cast<int>(__ldg(min_row + p));
}

// The same decode for N consecutive tokens from l0 of one pack (N a power
// of two no larger than the pack, l0 a multiple of N), from the words that
// hold them: words[0] is word l0 >> log2(32 / w) of the row, and the run
// spans max(1, N * w / 32) words. LW = log2 of the width is a constant, so
// the shifts and masks are too. sh, mn: the pack's 2-bit shift and min.
// Only l0's offset below one word is read, so l0 may be counted from the
// row's start or from its page's.
template <int LW, int N>
__device__ __forceinline__ void decode_tier_run(const uint32_t* words, int l0, int sh,
                                                int mn, float (&x)[N]) {
  constexpr int VPW_MASK = (1 << (5 - LW)) - 1;  // values per word - 1
  constexpr uint32_t VMASK = (1u << (1 << LW)) - 1u;
  const int half = sh > 0 ? (1 << (sh - 1)) : 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t word = words[(k << LW) >> 5];
    const int stored = static_cast<int>((word >> (((l0 + k) & VPW_MASK) << LW)) & VMASK);
    x[k] = static_cast<float>((stored << sh) + half + mn);
  }
}
