// K1: tier-tile decompression as a __device__ function.
//
// Replaces repro/kernels/unpack.py::decode_tier_tile (with unpack_words_2d,
// unpack_shifts_2d and broadcast_packwise), which every Pallas kernel of
// the JAX package inlines. decode_tier_run decodes a run of consecutive
// tokens of one channel row from words already loaded (K2, K5 from shared
// memory; K3, K4, K6, K7 from registers); the results stay in registers:
// decoded values never reach device memory.
//
// Row layout (docs/formats.md): token l of a width-w tier sits in bits
// [(l % vpw) * w, (l % vpw + 1) * w) of 32-bit word l / vpw (vpw = 32 / w);
// its pack p = l / pack has an int8 min at min_row[p] and a 2-bit shift at
// bits [2 * (p % 4), 2 * (p % 4) + 2) of shift byte p / 4. The decoded
// integer is (stored << shift) + half + min with the mid-rise
// half = 2^(shift - 1) (0 when shift is 0).
#pragma once

#include <cstdint>

// The decode of N consecutive tokens from l0 of one pack (N a power of
// two no larger than the pack, l0 a multiple of N), from the words that
// hold them: words[0] is word l0 >> log2(32 / w) of the row, and the run
// spans max(1, N * w / 32) words. LW = log2 of the width is a constant, so
// the shifts and masks are too. sh, mn: the pack's 2-bit shift and min.
// Only l0's offset below one word is read, so l0 may be counted from the
// row's start or from its page's.
//
// The integer never goes through an int-to-float conversion: stored << sh
// (below 2^19) is OR'd into the mantissa of 2^23, and 2^23 - (half + mn) is
// subtracted. Every operand and the result are integers below 2^24 in
// magnitude, so the float is exactly (float)((stored << sh) + half + mn),
// in 3 instructions a value where the conversion took 5.
template <int LW, int N>
__device__ __forceinline__ void decode_tier_run(const uint32_t* words, int l0, int sh,
                                                int mn, float (&x)[N]) {
  constexpr int VPW_MASK = (1 << (5 - LW)) - 1;  // values per word - 1
  constexpr uint32_t VMASK = (1u << (1 << LW)) - 1u;
  constexpr int NW = (N << LW) >= 32 ? (N << LW) / 32 : 1;
  const float off = 8388608.f - static_cast<float>((sh > 0 ? (1 << (sh - 1)) : 0) + mn);
  const uint32_t mask = VMASK << sh;
  uint64_t shifted[NW];  // each word << sh, its top bits kept
#pragma unroll
  for (int q = 0; q < NW; ++q) shifted[q] = static_cast<uint64_t>(words[q]) << sh;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t v = static_cast<uint32_t>(shifted[(k << LW) >> 5] >>
                                             (((l0 + k) & VPW_MASK) << LW));
    x[k] = __uint_as_float((v & mask) | 0x4B000000u) - off;  // 0x4B000000: 2^23
  }
}
