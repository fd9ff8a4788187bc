// Shared-memory staging of a span of tier-packed tokens (cp.async, and the
// mbarriers and transaction counts that TMA copies complete on), and the
// decode of a lane's 8-token chunk from it: what the span kernels K2/K5
// (packed_attention.cu) and K4/K7 (tier_matvec.cu) have in common.
//
// A staged span holds, for each channel row of a tier, the span's payload
// words ((SPAN << log2 w) >> 3 bytes), its int8 pack mins (SPAN >> log2
// pack bytes) and its 2-bit shifts (SPAN >> (log2 pack + 2) bytes), each
// leaf's rows back to back; a run of the span that starts at token r0
// sits at the same offsets the run has within the span.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "unpack.cuh"

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define CHUNK 8            // consecutive tokens per lane
#define SPAN (32 * CHUNK)  // tokens a span block covers, a chunk per lane

// ---------------------------------------------------------------------------
// cp.async into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async(int lg, void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (lg == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (lg == 3)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the first nb bytes of C rows, row c from src + c * src_stride to
// dst + c * dst_stride (bytes), with nthr threads together (this one is
// thread tid of them; by default the whole block): cp.async in the widest
// of 16, 8 and 4 bytes that every address, stride and length allows, plain
// byte copies below 4.
__device__ __forceinline__ void stage_rows(char* dst, int dst_stride, const char* src,
                                           int64_t src_stride, int C, int nb,
                                           int tid = threadIdx.x, int nthr = NTHREADS) {
  const uint64_t a = reinterpret_cast<uint64_t>(src) | reinterpret_cast<uint64_t>(dst) |
                     static_cast<uint64_t>(src_stride) | static_cast<uint64_t>(dst_stride) |
                     static_cast<uint64_t>(nb);
  if ((a & 3) == 0) {
    const int lg = (a & 15) == 0 ? 4 : ((a & 7) == 0 ? 3 : 2);
    const int per_row = nb >> lg;
    for (int i = tid; i < C * per_row; i += nthr) {
      const int c = i / per_row, k = (i - c * per_row) << lg;
      cp_async(lg, dst + c * dst_stride + k, src + c * src_stride + k);
    }
  } else {
    for (int i = tid; i < C * nb; i += nthr) {
      const int c = i / nb, k = i - c * nb;
      dst[c * dst_stride + k] = static_cast<char>(__ldg(src + c * src_stride + k));
    }
  }
}

// ---------------------------------------------------------------------------
// mbarriers in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival, with release semantics for this thread's earlier writes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Hold the barrier's phase open until this thread's cp.asyncs so far land.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Make the barriers' initialization visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Add bytes to the barrier's transaction count for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// decode from a staged span
// ---------------------------------------------------------------------------

// The words of a lane's 8-token chunk, as one vector load where they span
// more than one word (widths 8 and 16: 2 and 4 words, aligned).
template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t (&wd)[NW]) {
  if constexpr (NW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    wd[0] = v.x, wd[1] = v.y, wd[2] = v.z, wd[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    wd[0] = v.x, wd[1] = v.y;
  } else {
    wd[0] = src[0];
  }
}

// Channel c's chunk at t0 (a multiple of CHUNK) of one staged tier, decoded.
template <int LW>
__device__ __forceinline__ void decode_chunk(const char* pay, const int8_t* mins,
                                             const uint8_t* sfts, int lp, int c, int t0,
                                             float (&x)[CHUNK]) {
  constexpr int NW = (CHUNK << LW) >= 32 ? (CHUNK << LW) / 32 : 1;
  uint32_t wd[NW];
  load_words<NW>(reinterpret_cast<const uint32_t*>(pay + c * ((SPAN << LW) >> 3)) +
                     ((t0 << LW) >> 5),
                 wd);
  const int pk = t0 >> lp;
  const int sh = (sfts[c * (SPAN >> (lp + 2)) + (pk >> 2)] >> ((pk & 3) * 2)) & 3;
  const int mv = mins[c * (SPAN >> lp) + pk];
  decode_tier_run<LW, CHUNK>(wd, t0, sh, mv, x);  // K1
}
