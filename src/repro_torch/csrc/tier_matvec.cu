// K3, K4, K6 and K7: one tier's matrix-vector products over the
// tier-packed KV cache, for sm_90a, in two kernel bodies each templated on
// how a token is addressed.
//
// K3 replaces repro/kernels/kpack_matvec.py::kpack_tier_scores (Pallas
// _kernel) and K6 ::kpack_tier_scores_paged (_paged_kernel), the paper's
// K matrix-vector kernel (Fig. 8):
//   si[r, g, l] = sum_c q[r, g, c] * K_int[r, c, l]   for l < n_valid[r],
//                 0 (exact, nothing decoded)            otherwise.
// K4 replaces repro/kernels/vpack_matvec.py::vpack_tier_out and K7
// ::vpack_tier_out_paged, the paper's V matrix-vector kernel (Fig. 11):
//   out[r, g, c] = sum_{l < n_valid[r]} w[r, g, l] * V_int[r, c, l]
// with w already scaled by the per-token V scale. The per-token scale and
// zero of K and the V zero term are rank-1 corrections applied outside
// (kernels/ops.py), as in the reference. r runs over (batch row, kv head)
// pairs, batch-major; c over the tier's channels (tier order).
//
// Addressing. Dense (K3, K4): the leaves are [BH, C, units] and token l of
// row r sits at l of storage row r. Paged (K6, K7): the leaves are pools
// [H_kv, n_pool_pages, C, page units]; token l of row r = b * H_kv + h
// sits at l % page_size of page page_table[b, l / page_size], head h
// (the pool-layout contract of repro/kernels/pallas_utils.py). Everything
// else is the same code, and the work a thread or lane does depends only
// on its token indices, not on the tile or the page size, so K6 on a pool
// and K3 on its gathered dense view do the same float operations in the
// same order (bitwise equal), and so do K7 and K4. Rows read only tokens
// below their n_valid: a dead token's page-table entry is never read.
//
// Bound on the H100 SXM (3.35 TB/s): memory. A live (token, head) costs
// the tier's payload bits, an int8 min and a 2-bit shift per pack, per
// channel: at llama2-7b decode (B=4, 32 kv heads, one 4-bit tier of 128
// channels, pack 8, 3,456 live tokens per head) about 9.3 MB, plus K3's
// 1 MB of scores over the whole bucket and K4's live weights: ~3 us each.
// Both kernels are templated on the tier width (LW = log2 width), so the
// decode's shifts and masks are constants.
//
// Design.
//   * K3/K6: one 256-thread block per (row, 256-token span). Warp w takes
//     the channels w, w + 8, ..., lane j the span's 8-token chunk j: for
//     each channel the warp reads one coalesced run of the channel row
//     (the loads of 4 channels in flight together), decodes its chunk once
//     per word, min and shift, and FMAs with q[c] from shared memory into
//     8 partial scores; the warps' partials of each token are then added
//     in warp order through shared memory. A span at or past n_valid
//     writes zeros only.
//   * K4/K7 (PR 13's warp per (row, channel) ran at 10x its bound: its
//     decode and w loads followed its tier loads, the 16 channel-group
//     blocks of a row each re-read w, a quarter of its blocks belonged to
//     dead rows). One 256-thread block per (row, 256-token span); a span at
//     or past n_valid exits at once, and span 0 of an empty row writes its
//     zeros. Warp 7 is the producer: it copies the span's w (G x SPAN f32)
//     and then the span's tier bytes into a ring of MAX_STAGES buffers, a
//     group of CG = 32 channels each, so shared memory stays bounded
//     whatever the spec (a width-16 tier of 256 channels is ~141 KB a
//     span); an mbarrier per buffer completes when its group has landed,
//     another when the consumers are done with it. Payload and mins come
//     by one tensor copy (TMA) each a group where a run is the whole span
//     and the layout is 16-byte aligned, by cp.async otherwise; the shifts
//     (8 or 4 bytes a row) by cp.async. Issuing cp.asyncs for a group took
//     the producer ~2.6 us (their issue is throttled), so the groups landed
//     no faster than one block could decode them; two tensor copies issue
//     at once. Warps 0-6 are the consumers: warp w takes the channel quads
//     w, w + 7, ... of the tier as their groups land, lane j the span's
//     8-token chunk j; it decodes the quad's four rows from shared memory
//     (K1) and FMAs each in token order with its chunk of w, held in
//     registers (zero at and past n_valid); a fixed transposed butterfly
//     sums the quad over the lanes (6 shuffles for 4 channels). A row of
//     one live span writes its output; longer rows write span partials
//     [BH, n_spans, G, C] and the row's last span block to finish (an
//     atomic counts arrivals, never values) sums them in span order and
//     resets its counter, so the counters ([BH] int32, zero between
//     launches) serve the launches of one stream at a time.
//   A chunk never straddles a payload word, a pack or a page. No atomic
//   accumulates a value: two launches are bitwise equal. K7 stages a span
//   in runs of at most a page (the largest power of two <= SPAN dividing
//   the page, or the bucket when dense), each resolving page_table[b, l /
//   page] once; the runs only move bytes, so K7 on a pool equals K4 on the
//   gathered view bitwise at every page size, and K4 over a bucket view
//   equals K4 over the full capacity.
// Left on the table: K3 reads q from shared memory once per (channel,
// chunk) and stages nothing. K4/K7 at the calibrated spec are now bound by
// the consumers' decode (~4 instructions a value and ~3 more a channel
// chunk; launch/matvec_breakdown.py) and by the chain launch, n_valid, first
// group, last group, fence, atomic, merge; at G = 1 the V matvec is a GEMV
// no tensor core helps; a row's span partials make a second trip through
// L2; pages under 256 tokens stage by cp.async.
#include <cuda.h>  // CUtensorMap (the map is encoded through the runtime's entry point)
#include <cuda_runtime.h>

#include <cstdint>

#include "staging.cuh"  // cp.async staging, decode_chunk (K1), SPAN, CHUNK

#define MAX_G 8
#define MAX_C 256
static_assert(SPAN == NTHREADS, "K3 writes one token per thread");
#define KUNROLL 4     // K3/K6: channels per warp whose loads are in flight together
#define CG 32         // K4/K7: channels per staged group
#define MAX_STAGES 4  // K4/K7: groups whose copies are in flight at once
#define PRODUCER (NWARPS - 1)  // K4/K7: the warp that issues the copies

// Strides are in elements; every leaf's last axis is contiguous. "ss"
// steps a storage row (dense: a (batch row, head) row; paged: a pool
// page), "sh" a kv head (paged only; 0 when dense), "sc" a channel.
struct TierMatvecParams {
  const int32_t* payload;
  const int8_t* mins;
  const uint8_t* shifts;
  int64_t pay_ss, pay_sh, pay_sc;
  int64_t min_ss, min_sh, min_sc;
  int64_t sft_ss, sft_sh, sft_sc;
  const float* x;  // K3/K6: q [BH, G, C]; K4/K7: w [BH, G, L]
  int64_t x_sr, x_sg;
  const int32_t* n_valid;  // [BH]
  float* out;              // K3/K6: si [BH, G, L]; K4/K7: [BH, G, C]; contiguous
  const int32_t* page_table;  // paged: [B, max_pages], row stride pt_sb
  int64_t pt_sb, page_size;
  int64_t BH, Hkv, G, C, L, log2_w, log2_pack;  // dense: Hkv = 1
  float* part;        // K4/K7: span partials [BH, ceil(L / SPAN), G, C]
  int32_t* counters;  // K4/K7: [BH] span arrivals, zero between launches
  int64_t S;          // storage rows: dense BH, paged the pool's pages
};

// Row r's token l: its storage row s, kv head h and offset ll within s.
template <bool PAGED>
__device__ __forceinline__ void locate(const TierMatvecParams& p, int r, int l,
                                       int64_t& s, int& h, int& ll) {
  const int b = r / static_cast<int>(p.Hkv);
  h = r % static_cast<int>(p.Hkv);
  if (PAGED) {
    s = p.page_table[b * p.pt_sb + l / p.page_size];
    ll = static_cast<int>(l % p.page_size);
  } else {
    s = b;
    ll = l;
  }
}

__device__ __forceinline__ int clamp_n(const TierMatvecParams& p, int r) {
  const int n = p.n_valid[r];
  return n < 0 ? 0 : (n > p.L ? static_cast<int>(p.L) : n);
}

// One channel row's 8-token chunk: the words it spans, its pack's min and
// 2-bit shift (a chunk lies in one pack: pack_size >= CHUNK and chunks are
// aligned), loaded from storage row s, head h, offset ll0 (locate).
template <int LW>
struct Chunk {
  static constexpr int LVPW = 5 - LW;  // log2(values per word)
  static constexpr int NW = (CHUNK << LW) >= 32 ? (CHUNK << LW) / 32 : 1;
  uint32_t wd[NW];
  int sh, mv;

  __device__ __forceinline__ void load(const TierMatvecParams& p, int64_t s, int h,
                                       int ll0, int c) {
    const int32_t* pay = p.payload + s * p.pay_ss + h * p.pay_sh + c * p.pay_sc + (ll0 >> LVPW);
    const int pk = ll0 >> static_cast<int>(p.log2_pack);
#pragma unroll
    for (int q = 0; q < NW; ++q) wd[q] = static_cast<uint32_t>(__ldg(pay + q));
    sh = (__ldg(p.shifts + s * p.sft_ss + h * p.sft_sh + c * p.sft_sc + (pk >> 2)) >>
          ((pk & 3) * 2)) & 3;
    mv = static_cast<int>(__ldg(p.mins + s * p.min_ss + h * p.min_sh + c * p.min_sc + pk));
  }

  __device__ __forceinline__ void decode(int l0, float (&x)[CHUNK]) const {
    decode_tier_run<LW, CHUNK>(wd, l0, sh, mv, x);  // K1, unpack.cuh
  }
};

template <bool PAGED, int LW>
__global__ void __launch_bounds__(NTHREADS)
    kpack_scores_kernel(const TierMatvecParams p) {
  __shared__ float s_q[MAX_G][MAX_C];
  __shared__ __align__(16) float s_part[NWARPS][SPAN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x;
  const int span0 = static_cast<int>(blockIdx.y) * SPAN;
  const int G = static_cast<int>(p.G), C = static_cast<int>(p.C);
  const int L = static_cast<int>(p.L);
  const int n = clamp_n(p, r);
  float* out = p.out + static_cast<int64_t>(r) * G * L;
  const int t = span0 + threadIdx.x;  // the token this thread writes
  if (span0 >= n) {  // dead span: exact zeros, nothing decoded
    if (t < L)
      for (int g = 0; g < G; ++g) out[static_cast<int64_t>(g) * L + t] = 0.f;
    return;
  }
  const float* q = p.x + r * p.x_sr;
  for (int i = threadIdx.x; i < G * C; i += NTHREADS) {
    const int g = i / C, c = i % C;
    s_q[g][c] = q[g * p.x_sg + c];
  }
  __syncthreads();
  // this lane's chunk of the span, summed over this warp's channels
  // warp, warp + NWARPS, ... in order
  const int l0 = span0 + lane * CHUNK;
  float part[MAX_G][CHUNK];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) part[g][k] = 0.f;
  if (l0 < n) {
    int64_t s;
    int h, ll0;
    locate<PAGED>(p, r, l0, s, h, ll0);
    for (int c0 = warp; c0 < C; c0 += NWARPS * KUNROLL) {
      Chunk<LW> ch[KUNROLL];
#pragma unroll
      for (int u = 0; u < KUNROLL; ++u)
        if (c0 + u * NWARPS < C) ch[u].load(p, s, h, ll0, c0 + u * NWARPS);
#pragma unroll
      for (int u = 0; u < KUNROLL; ++u) {
        const int c = c0 + u * NWARPS;
        if (c >= C) break;
        float x[CHUNK];
        ch[u].decode(l0, x);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) {
            const float qc = s_q[g][c];
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) part[g][k] = fmaf(qc, x[k], part[g][k]);
          }
      }
    }
  }
  // the warps' partial sums of each token, added in warp order
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    float4* dst = reinterpret_cast<float4*>(&s_part[warp][lane * CHUNK]);
    dst[0] = make_float4(part[g][0], part[g][1], part[g][2], part[g][3]);
    dst[1] = make_float4(part[g][4], part[g][5], part[g][6], part[g][7]);
    __syncthreads();
    if (t < L) {
      float si = s_part[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) si += s_part[w][threadIdx.x];
      out[static_cast<int64_t>(g) * L + t] = t < n ? si : 0.f;
    }
    __syncthreads();
  }
}

// K4/K7's dynamic shared memory: w [G][SPAN] f32, then a ring of `stages`
// buffers, each one channel group's staged tier bytes (a payload, a min
// and a shift row per channel). Set by the host (v_layout()).
struct VLayout {
  int32_t mn, sft;  // offsets of the mins and shifts within a group buffer
  int32_t group;    // bytes of a group buffer
  int32_t stages;   // group buffers, and groups in flight at once
  int32_t total;
  int32_t run;  // tokens per staged run
  int32_t tma;  // 1: payload and mins by one tensor copy each a group
};

// A tensor copy (TMA) of the box at coordinates (x, y, z, w) of map into
// shared memory, counted against bar's transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int x, int y,
                                            int z, int w, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(w),
      "r"(smem_addr(bar))
      : "memory");
}

// Stage channels [c0, c0 + nc) of row r's span from s0 (the runs that
// start below n) into the group buffer buf, by the producer warp's lanes:
// payload and mins by a tensor copy each where the layout allows it (one
// run a span; bar counts their bytes), cp.async otherwise.
template <bool PAGED, int LW>
__device__ __forceinline__ void stage_group(const TierMatvecParams& p, const VLayout& lay,
                                            const CUtensorMap* tm_pay, const CUtensorMap* tm_min,
                                            char* buf, int r, int s0, int n, int c0, int nc,
                                            uint64_t* bar, int lane) {
  const int lp = static_cast<int>(p.log2_pack);
  for (int r0 = 0; r0 < SPAN && s0 + r0 < n; r0 += lay.run) {
    int64_t s;
    int h, ll;
    locate<PAGED>(p, r, s0 + r0, s, h, ll);
    if (lay.tma) {
      if (lane == 0) {
        mbar_expect_tx(bar, lay.sft);  // CG rows of payload, then of mins
        tma_load_4d(buf, tm_pay, (ll << LW) >> 5, c0, static_cast<int>(s), h, bar);
        tma_load_4d(buf + lay.mn, tm_min, ll >> lp, c0, static_cast<int>(s), h, bar);
      }
    } else {
      stage_rows(buf + ((r0 << LW) >> 3), (SPAN << LW) >> 3,
                 reinterpret_cast<const char*>(p.payload + s * p.pay_ss + h * p.pay_sh +
                                               c0 * p.pay_sc + ((ll << LW) >> 5)),
                 p.pay_sc * 4, nc, (lay.run << LW) >> 3, lane, 32);
      stage_rows(buf + lay.mn + (r0 >> lp), SPAN >> lp,
                 reinterpret_cast<const char*>(p.mins + s * p.min_ss + h * p.min_sh +
                                               c0 * p.min_sc + (ll >> lp)),
                 p.min_sc, nc, lay.run >> lp, lane, 32);
    }
    stage_rows(buf + lay.sft + (r0 >> (lp + 2)), SPAN >> (lp + 2),
               reinterpret_cast<const char*>(p.shifts + s * p.sft_ss + h * p.sft_sh +
                                             c0 * p.sft_sc + (ll >> (lp + 2))),
               p.sft_sc, nc, lay.run >> (lp + 2), lane, 32);
  }
}

// Four per-lane values each summed over the warp's 32 lanes, by a fixed
// transposed butterfly (6 shuffles for the four): lane l returns the sum of
// value 2 * bit 4 + bit 3 of l.
__device__ __forceinline__ float warp_sum4(float v0, float v1, float v2, float v3, int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float k0 = hi16 ? v2 : v0, k1 = hi16 ? v3 : v1;
  k0 += __shfl_xor_sync(0xffffffffu, hi16 ? v0 : v2, 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi16 ? v1 : v3, 16);
  float k = hi8 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) k += __shfl_xor_sync(0xffffffffu, k, o);
  return k;
}

// Row r's output: its nsp span partials summed in span order; run by the
// row's last span block.
__device__ __forceinline__ void merge_spans(const TierMatvecParams& p, int r, int nsp) {
  const int GC = static_cast<int>(p.G * p.C);
  const float* part = p.part + static_cast<int64_t>(r) * gridDim.y * GC;
  float* out = p.out + static_cast<int64_t>(r) * GC;
  for (int i = threadIdx.x; i < GC; i += NTHREADS) {
    float acc = 0.f;
    for (int s = 0; s < nsp; ++s) acc += __ldcg(part + s * GC + i);
    out[i] = acc;
  }
}

// Four blocks an SM (64 registers) hold the main shape's 480 live span
// blocks in one wave; at GM >= 4 the weights alone take 32-64 registers.
template <bool PAGED, int LW, int GM>
__global__ void __launch_bounds__(NTHREADS, GM > 2 ? 2 : 4)
    vpack_span_kernel(const TierMatvecParams p, const VLayout lay,
                      const __grid_constant__ CUtensorMap tm_pay,
                      const __grid_constant__ CUtensorMap tm_min) {
  extern __shared__ __align__(128) char smem[];  // tensor copies land on 128 bytes
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x;
  const int s0 = static_cast<int>(blockIdx.y) * SPAN;
  const int G = static_cast<int>(p.G), C = static_cast<int>(p.C);
  const int n = clamp_n(p, r);
  if (s0 >= n) {  // a dead span; span 0 of an empty row writes its zeros
    if (n == 0 && blockIdx.y == 0)
      for (int i = tid; i < G * C; i += NTHREADS) p.out[static_cast<int64_t>(r) * G * C + i] = 0.f;
    return;
  }
  const int nt = min(SPAN, n - s0);  // the span's live tokens
  const int nsp = (n + SPAN - 1) / SPAN;
  const int ngroups = (C + CG - 1) / CG;
  float* s_w = reinterpret_cast<float*>(smem);
  char* bufs = smem + G * SPAN * 4;
  if (warp == PRODUCER)  // w of the live chunks, before anything waits
    stage_rows(smem, SPAN * 4, reinterpret_cast<const char*>(p.x + r * p.x_sr + s0),
               p.x_sg * 4, G, ((nt + CHUNK - 1) & ~(CHUNK - 1)) * 4, lane, 32);
  if (tid < lay.stages) {
    mbar_init(&full[tid], 32);          // the producer's lanes
    mbar_init(&empty[tid], NWARPS - 1);  // a lane of each consumer warp
  }
  fence_mbar_init();
  __syncthreads();

  float* dst = p.out + static_cast<int64_t>(r) * G * C;  // one span: the output
  if (nsp > 1) dst = p.part + (static_cast<int64_t>(r) * gridDim.y + blockIdx.y) * G * C;
  if (warp == PRODUCER) {
    // the copies, group after group into the ring (w went first, above);
    // full[slot] completes when a group, and every copy before it, has landed
    for (int gi = 0; gi < ngroups; ++gi) {
      const int slot = gi % lay.stages;
      if (gi >= lay.stages) mbar_wait(&empty[slot], (gi / lay.stages - 1) & 1);
      stage_group<PAGED, LW>(p, lay, &tm_pay, &tm_min, bufs + slot * lay.group, r, s0, n,
                             gi * CG, min(CG, C - gi * CG), &full[slot], lane);
      cp_async_mbar_arrive(&full[slot]);
      mbar_arrive(&full[slot]);
    }
  } else {
    // consumer warp cw: the quads of channels cw, cw + 7, ... of the tier
    // (4 channels each), a group at a time; lane j the span's chunk t0,
    // with its weights (zero at and past n)
    const int t0 = lane * CHUNK;
    const bool live = t0 < nt;
    const int lp = static_cast<int>(p.log2_pack);
    float wr[GM][CHUNK];
    int q = warp;
    for (int gi = 0; gi < ngroups; ++gi) {
      const int slot = gi % lay.stages;
      mbar_wait(&full[slot], (gi / lay.stages) & 1);
      if (gi == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
          if (g < G && live) {
            const float4* src = reinterpret_cast<const float4*>(s_w + g * SPAN + t0);
            a = src[0];
            b = src[1];
          }
          wr[g][0] = a.x, wr[g][1] = a.y, wr[g][2] = a.z, wr[g][3] = a.w;
          wr[g][4] = b.x, wr[g][5] = b.y, wr[g][6] = b.z, wr[g][7] = b.w;
#pragma unroll
          for (int k = 0; k < CHUNK; ++k)
            if (t0 + k >= nt) wr[g][k] = 0.f;
        }
      }
      const char* buf = bufs + slot * lay.group;
      const int c0 = gi * CG, nc = min(CG, C - c0);
      for (; 4 * q < c0 + nc; q += NWARPS - 1) {  // the warp's quads in this group
        const int cq = 4 * q - c0;
        float a[4][GM];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int g = 0; g < GM; ++g) a[j][g] = 0.f;
        if (live) {  // decode and FMA
          // all four rows, branch-free: the buffer holds CG rows, and a
          // row at or past nc is decoded and then dropped
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x[CHUNK];
            decode_chunk<LW>(buf, reinterpret_cast<const int8_t*>(buf + lay.mn),
                             reinterpret_cast<const uint8_t*>(buf + lay.sft), lp, cq + j, t0, x);
#pragma unroll
            for (int g = 0; g < GM; ++g)
#pragma unroll
              for (int k = 0; k < CHUNK; ++k) a[j][g] = fmaf(wr[g][k], x[k], a[j][g]);
          }
        }
        const int j = ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);  // warp_sum4's channel
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float v = warp_sum4(a[0][g], a[1][g], a[2][g], a[3][g], lane);
          if ((lane & 7) == 0 && g < G && cq + j < nc) dst[g * C + c0 + cq + j] = v;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the buffer
    }
  }
  if (nsp == 1) return;
  // the row's last span block to finish merges; the atomic counts
  // arrivals only (no value is accumulated), and the merger resets it
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(p.counters + r, 1) == nsp - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  merge_spans(p, r, nsp);
  if (tid == 0) p.counters[r] = 0;
}

// K3/K6: one instantiation per tier width, log2 of 1, 2, 4, 8, 16 = 0..4.
#define LAUNCH_BY_WIDTH(KERNEL)                                           \
  switch (p->log2_w) {                                                    \
    case 0: KERNEL<PAGED, 0><<<grid, NTHREADS, 0, st>>>(*p); break;       \
    case 1: KERNEL<PAGED, 1><<<grid, NTHREADS, 0, st>>>(*p); break;       \
    case 2: KERNEL<PAGED, 2><<<grid, NTHREADS, 0, st>>>(*p); break;       \
    case 3: KERNEL<PAGED, 3><<<grid, NTHREADS, 0, st>>>(*p); break;       \
    case 4: KERNEL<PAGED, 4><<<grid, NTHREADS, 0, st>>>(*p); break;       \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }                                                                       \
  return static_cast<int>(cudaGetLastError())

template <bool PAGED>
static int launch_scores(const TierMatvecParams* p, void* stream) {
  const dim3 grid(static_cast<unsigned>(p->BH),
                  static_cast<unsigned>((p->L + SPAN - 1) / SPAN));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  LAUNCH_BY_WIDTH(kpack_scores_kernel);
}

// The current device's opt-in shared memory a block, less the kernel's
// static shared memory (read on every launch: it is one attribute query).
static int max_smem() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v - 1024;
}

// K4/K7's shared memory: w, then min(groups, MAX_STAGES) group buffers.
static VLayout v_layout(const TierMatvecParams& p, bool paged) {
  VLayout s{};
  const int lw = static_cast<int>(p.log2_w), lp = static_cast<int>(p.log2_pack);
  s.mn = CG * ((SPAN << lw) >> 3);  // every part a multiple of 16 bytes
  s.sft = s.mn + CG * (SPAN >> lp);
  s.group = s.sft + CG * (SPAN >> (lp + 2));
  const int groups = static_cast<int>((p.C + CG - 1) / CG);
  s.stages = groups < MAX_STAGES ? groups : MAX_STAGES;
  s.total = static_cast<int>(p.G) * SPAN * 4 + s.stages * s.group;
  const int64_t unit = paged ? p.page_size : p.L;
  s.run = SPAN;
  while (unit % s.run) s.run >>= 1;
  // tensor copies: a run is the whole span, every address and stride of
  // payload and mins a multiple of 16 bytes (the boxes' rows are 16 at least)
  const uint64_t a = reinterpret_cast<uint64_t>(p.payload) | reinterpret_cast<uint64_t>(p.mins) |
                     static_cast<uint64_t>(p.pay_sc * 4) | static_cast<uint64_t>(p.pay_ss * 4) |
                     static_cast<uint64_t>(p.pay_sh * 4) | static_cast<uint64_t>(p.min_sc) |
                     static_cast<uint64_t>(p.min_ss) | static_cast<uint64_t>(p.min_sh) |
                     static_cast<uint64_t>(SPAN >> lp);
  s.tma = s.run == SPAN && (a & 15) == 0;
  return s;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A leaf as a 4-d tensor (units within a storage row, channel, storage
// row, kv head; dense: one head) with a box of one span of CG channels.
static bool encode_leaf(CUtensorMap* map, const void* base, CUtensorMapDataType type, int esize,
                        int64_t units, int64_t C, int64_t S, int64_t H, int64_t sc, int64_t ss,
                        int64_t sh, int box_units) {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return false;
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(units), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sc * esize),
                                 static_cast<cuuint64_t>(ss * esize),
                                 static_cast<cuuint64_t>((sh ? sh : ss * S) * esize)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_units), CG, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool PAGED, int LW, int GM>
static cudaError_t launch_v(const TierMatvecParams& p, const VLayout& s, dim3 grid,
                            cudaStream_t st) {
  auto kernel = vpack_span_kernel<PAGED, LW, GM>;
  // above 48 KB a launch needs the opt-in; set on every such launch (it
  // is per device, and cheap), so a second device gets it too
  if (s.total > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
    if (e != cudaSuccess) return e;
  }
  CUtensorMap tm_pay{}, tm_min{};
  if (s.tma) {
    const int lp = static_cast<int>(p.log2_pack);
    const int64_t units = PAGED ? p.page_size : p.L, H = PAGED ? p.Hkv : 1;
    if (!encode_leaf(&tm_pay, p.payload, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, (units << LW) >> 5,
                     p.C, p.S, H, p.pay_sc, p.pay_ss, p.pay_sh, (SPAN << LW) >> 5) ||
        !encode_leaf(&tm_min, p.mins, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, units >> lp, p.C, p.S, H,
                     p.min_sc, p.min_ss, p.min_sh, SPAN >> lp))
      return cudaErrorInvalidValue;
  }
  kernel<<<grid, NTHREADS, s.total, st>>>(p, s, tm_pay, tm_min);
  return cudaGetLastError();
}

template <bool PAGED, int GM>
static cudaError_t launch_v_width(const TierMatvecParams& p, const VLayout& s, dim3 grid,
                                  cudaStream_t st) {
  switch (p.log2_w) {
    case 0: return launch_v<PAGED, 0, GM>(p, s, grid, st);
    case 1: return launch_v<PAGED, 1, GM>(p, s, grid, st);
    case 2: return launch_v<PAGED, 2, GM>(p, s, grid, st);
    case 3: return launch_v<PAGED, 3, GM>(p, s, grid, st);
    case 4: return launch_v<PAGED, 4, GM>(p, s, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
static int launch_out(const TierMatvecParams* p, void* stream) {
  const VLayout s = v_layout(*p, PAGED);
  if (s.total > max_smem() || s.run < (4 << p->log2_pack) || s.run < 32 || p->G > MAX_G ||
      p->C > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(p->BH), static_cast<unsigned>((p->L + SPAN - 1) / SPAN));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p->G == 1)
    e = launch_v_width<PAGED, 1>(*p, s, grid, st);
  else if (p->G == 2)
    e = launch_v_width<PAGED, 2>(*p, s, grid, st);
  else if (p->G <= 4)
    e = launch_v_width<PAGED, 4>(*p, s, grid, st);
  else
    e = launch_v_width<PAGED, 8>(*p, s, grid, st);
  return static_cast<int>(e);
}

extern "C" int tier_matvec_params_size() {
  return static_cast<int>(sizeof(TierMatvecParams));
}

extern "C" int tier_matvec_span() { return SPAN; }

// Launch on `stream`; return cudaGetLastError() (0 on success). The
// callers check shapes, types and strides (kernels/kpack_matvec.py,
// kernels/vpack_matvec.py); for K4/K7 they allocate p->part and pass
// zeroed p->counters.
extern "C" int kpack_scores_launch(const TierMatvecParams* p, void* stream) {
  return launch_scores<false>(p, stream);  // K3
}

extern "C" int kpack_scores_paged_launch(const TierMatvecParams* p, void* stream) {
  return launch_scores<true>(p, stream);  // K6
}

extern "C" int vpack_out_launch(const TierMatvecParams* p, void* stream) {
  return launch_out<false>(p, stream);  // K4
}

extern "C" int vpack_out_paged_launch(const TierMatvecParams* p, void* stream) {
  return launch_out<true>(p, stream);  // K7
}
