// K2 and K5: fused decode attention over the tier-packed KV cache, for
// sm_90a, in one kernel body templated on how a run of tokens is addressed.
//
// K2 replaces repro/kernels/packed_attention.py::fused_packed_attention
// (the Pallas kernel _fused_kernel + _flash_tile_body) over the DENSE
// cache; K5 replaces ::fused_packed_attention_paged (_paged_fused_kernel)
// over the PAGE POOL. One wrapper call per layer per decode step computes,
// for every (batch row, kv head), the log-sum-exp partials of attention
// over that row's compressed region:
//   scores[g, l] = (q_perm[g] . K_int[:, l] * kscale[l]
//                   + sum(q[g]) * kzero[l]) * sm_scale,  l < n_comp[b]
//   m[g], l[g]   = max / normalizer of exp(scores)
//   acc[g, c]    = sum_l p[g, l] * vscale[l] * V_int[c, l]
//                  + sum_l p[g, l] * vzero[l]
// with K_int / V_int decoded from their tiers (K1, unpack.cuh). The K
// channel permutation is applied to q in the prologue and the V inverse
// permutation in the merge's scatter; the residual-buffer merge happens
// outside (kernels/ops.py).
//
// Bound on the H100 SXM (3.35 TB/s): memory. Each live (token, kv head)
// costs the compressed K and V payload bits, an int8 min and a 2-bit shift
// per pack and channel, and 16 bytes of f32 scale/zero. At llama2-7b decode
// with the calibrated spec (K and V one 4-bit tier of 128 channels, pack 8)
// that is 184 bytes: at B=4, 32 kv heads and live counts {0, 64, 1344,
// 2048} about 20.6 MB, a bound of 6.15 us; at serving's 4 rows of ~1000
// tokens about 23.5 MB, 7 us. The integer decode and the FMAs (~8 M warp
// instructions at the first shape, ~9 us of issue on 132 SMs) come close
// to it, so the kernel needs every SM busy and its loads coalesced.
//
// Design. The first version (one block per row, a loop over 256-token
// tiles, a thread per token walking 128 channels with three dependent
// global loads each, a thread per V channel walking its row one token at a
// time, three block reductions per tile) ran 150x its bound: 32 blocks of
// 2048-token rows set the time on 32 of 132 SMs, and no load was coalesced.
//   * Split contexts (flash-decoding). The grid is (B * H_kv, ceil(L /
//     SPAN)); a block owns the SPAN = 256 tokens [s0, s0 + SPAN) of its row
//     and exits at once if s0 >= n_comp. Each live span writes its partials
//     (m, l, the zero-term sum z and acc[G, Dv]) to a scratch tensor the
//     wrapper allocates. The row's last span block to finish (an atomic
//     counts arrivals; no value is ever accumulated atomically) merges the
//     row's live spans IN SPAN ORDER (fixed-order LSE merge), adds z and
//     scatters through the V inverse permutation. An empty row gives o = 0,
//     m = -1e30, l = 0 exactly. At the first shape above: 15 live spans per
//     head, 480 blocks instead of 128, all resident at once (4 an SM). A
//     second merge kernel, even launched as a programmatic dependent,
//     timed slower.
//   * Staging. The span's bytes (every K and V tier's payload words, mins
//     and shift bytes, and the f32 scale/zero) are copied into shared
//     memory with cp.async, 16 bytes a request where addresses and lengths
//     allow (a channel row's span is one contiguous run at the calibrated
//     spec), 8 or 4 below that, bytes for runs of under 4 bytes. K and the
//     scale/zero form the first commit group; V's copies are issued once K
//     has landed, before the scores are computed, so they land while K is
//     used (issued together with K's, the kernel timed slower). ~56 KB a
//     block at the calibrated spec (4 blocks an SM); a spec whose K and V
//     do not fit side by side stages V after the scores into K's space. At
//     the first shape the copies alone take about as long as a torch.sum
//     over as many contiguous bytes (launch/k2_breakdown.py, PERF.md).
//   * Decode from shared memory, one 8-token chunk per lane (K1's
//     decode_tier_run, instantiated per tier width): scores with warp w
//     over channels w, w + 8, ... and lane j over chunk j, the warps'
//     partial sums of each token added in warp order; V with the same
//     split, each lane's chunk sums merged by a fixed shuffle butterfly.
//     One max and one (l, z) sum reduction per span.
//   * Paged addressing per run. A span is staged in runs of RUN tokens
//     (the largest power of two <= SPAN dividing the page size, or the
//     bucket L when dense), each run resolving page_table[b, l / page] once.
//     The float operations and their order depend only on token indices
//     (the span, the chunk, the channel), never on L, the run or the page,
//     so K5 on a pool is bitwise equal to K2 on the gathered dense view at
//     every page size, and K2 over a bucket view equals K2 over the full
//     capacity whenever every n_comp fits the bucket.
//   Two launches are bitwise equal. The arrival counters ([B * H_kv] int32,
//   zero between launches: the merging block resets its row's) belong to
//   one stream of one device (the wrapper keys them by the current
//   stream), so launches on two streams at once never share them.
//   * Group sizes up to 16 (recurrentgemma-9b's local attention: 16 query
//     heads over one kv head of 256 channels). The per-group registers
//     (8 scores a lane a group, then 8 weights) are a template bound GM
//     in {1, 2, 4, 8, 16}; at GM = 16 a thread holds 128 partial scores,
//     and one block of q (16 KB), p * vscale (16 KB) and a 4-bit K and V
//     (~42 KB each) takes ~128 KB of shared memory, one block an SM.
// Left on the table: the loads and the decode of a block run one after the
// other and every block of the first shape's single wave loads at once, so
// the decode does not overlap the copies; at llama2's G = 1 the work is a
// GEMV that no tensor core can help.
#include <cuda_runtime.h>

#include <cstdint>

#include "staging.cuh"  // cp.async staging, decode_chunk (K1), SPAN

#define MAX_TIERS 6
#define MAX_G 16
#define MAX_D 256
static_assert(SPAN == NTHREADS, "the scores keep one token per thread");
#define NEG_INF (-1e30f)

// Strides are in elements; every row's last axis is contiguous. The "sb"
// stride steps a batch row (dense) or a pool page (paged).
struct TierDesc {
  const int32_t* payload;
  const int8_t* mins;
  const uint8_t* shifts;
  int64_t log2_w, count;
  int64_t pay_sb, pay_sh, pay_sc;
  int64_t min_sb, min_sh, min_sc;
  int64_t sft_sb, sft_sh, sft_sc;
};

struct PackedAttnParams {
  TierDesc k[MAX_TIERS];
  TierDesc v[MAX_TIERS];
  int64_t nk, nv;
  const float* q;  // [B, H, D] contiguous, original channel order
  const int32_t* kperm;
  int64_t kperm_sb, kperm_sh;
  const int32_t* vperm;
  int64_t vperm_sb, vperm_sh;
  const float* kscale;
  int64_t kscale_sb, kscale_sh;
  const float* kzero;
  int64_t kzero_sb, kzero_sh;
  const float* vscale;
  int64_t vscale_sb, vscale_sh;
  const float* vzero;
  int64_t vzero_sb, vzero_sh;
  const int32_t* n_comp;  // [B]
  float* out;             // [B, H, Dv] contiguous, original channel order
  float* m_out;           // [B, H]
  float* l_out;           // [B, H]
  const int32_t* page_table;  // paged: [B, max_pages], row stride pt_sb
  int64_t pt_sb, page_size;
  int64_t B, Hkv, G, D, Dv, L, log2_pack;  // paged: L = n_tokens
  double sm_scale;
  float* part;        // scratch [B * H_kv, ceil(L / SPAN), G * (Dv + 3)]
  int32_t* counters;  // [B * H_kv] span arrivals, zero between launches
};

// Byte offsets into the dynamic shared memory, set by the host (layout()).
struct SmemLayout {
  int32_t k_pay[MAX_TIERS], k_min[MAX_TIERS], k_sft[MAX_TIERS];
  int32_t v_pay[MAX_TIERS], v_min[MAX_TIERS], v_sft[MAX_TIERS];
  int32_t meta;  // f32 [4][SPAN]: kscale, kzero, vscale, vzero
  int32_t q;     // f32 [G][D], q permuted by K's chan_perm
  int32_t ws;    // f32 [G][SPAN], p * vscale
  int32_t part;  // f32 [NWARPS][SPAN], the warps' partial scores
  int32_t total;
  int32_t run;      // tokens per staged run
  int32_t v_early;  // 1: V has its own space, copied before the scores
};

// Where token l of batch row b lives: its storage row (batch row, or the
// physical page) and its offset in that row.
template <bool PAGED>
__device__ __forceinline__ void locate(const PackedAttnParams& p, int b, int l,
                                       int64_t& s, int& ll) {
  if (PAGED) {
    s = p.page_table[b * p.pt_sb + l / p.page_size];
    ll = static_cast<int>(l % p.page_size);
  } else {
    s = b;
    ll = l;
  }
}

// Stage one tensor's tiers for the runs of the span from s0 that start
// below n: payload words, mins and shift bytes of every channel row.
template <bool PAGED>
__device__ __forceinline__ void stage_tiers(const PackedAttnParams& p, const TierDesc* d,
                                            int ntiers, const int32_t* pay_off,
                                            const int32_t* min_off, const int32_t* sft_off,
                                            char* smem, int b, int h, int s0, int n, int run) {
  const int lp = static_cast<int>(p.log2_pack);
  for (int r0 = 0; r0 < SPAN && s0 + r0 < n; r0 += run) {
    int64_t s;
    int ll;
    locate<PAGED>(p, b, s0 + r0, s, ll);
    for (int t = 0; t < ntiers; ++t) {
      const TierDesc& dt = d[t];
      const int lw = static_cast<int>(dt.log2_w), C = static_cast<int>(dt.count);
      stage_rows(smem + pay_off[t] + ((r0 << lw) >> 3), (SPAN << lw) >> 3,
                 reinterpret_cast<const char*>(dt.payload + s * dt.pay_sb + h * dt.pay_sh +
                                               ((ll << lw) >> 5)),
                 dt.pay_sc * 4, C, (run << lw) >> 3);
      stage_rows(smem + min_off[t] + (r0 >> lp), SPAN >> lp,
                 reinterpret_cast<const char*>(dt.mins + s * dt.min_sb + h * dt.min_sh +
                                               (ll >> lp)),
                 dt.min_sc, C, run >> lp);
      stage_rows(smem + sft_off[t] + (r0 >> (lp + 2)), SPAN >> (lp + 2),
                 reinterpret_cast<const char*>(dt.shifts + s * dt.sft_sb + h * dt.sft_sh +
                                               (ll >> (lp + 2))),
                 dt.sft_sc, C, run >> (lp + 2));
    }
  }
}

// The per-token kscale, kzero, vscale, vzero of the span's live runs.
template <bool PAGED>
__device__ __forceinline__ void stage_meta(const PackedAttnParams& p, char* dst, int b,
                                           int h, int s0, int n, int run) {
  const float* src[4] = {p.kscale, p.kzero, p.vscale, p.vzero};
  const int64_t sb[4] = {p.kscale_sb, p.kzero_sb, p.vscale_sb, p.vzero_sb};
  const int64_t sh[4] = {p.kscale_sh, p.kzero_sh, p.vscale_sh, p.vzero_sh};
  for (int r0 = 0; r0 < SPAN && s0 + r0 < n; r0 += run) {
    int64_t s;
    int ll;
    locate<PAGED>(p, b, s0 + r0, s, ll);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stage_rows(dst + (i * SPAN + r0) * 4, 0,
                 reinterpret_cast<const char*>(src[i] + s * sb[i] + h * sh[i] + ll), 0, 1,
                 run * 4);
  }
}

// ---------------------------------------------------------------------------
// decode from shared memory
// ---------------------------------------------------------------------------

// Scores: this lane's chunk at t0 summed over this warp's channels of one
// tier (warp, warp + NWARPS, ... in order). sq: q of the tier's channels,
// row stride D.
template <int LW, int GM>
__device__ __forceinline__ void k_tier(const char* pay, const int8_t* mins,
                                       const uint8_t* sfts, int lp, int C, const float* sq,
                                       int D, int G, int warp, int t0,
                                       float (&part)[GM][CHUNK]) {
#pragma unroll 4
  for (int c = warp; c < C; c += NWARPS) {
    float x[CHUNK];
    decode_chunk<LW>(pay, mins, sfts, lp, c, t0, x);
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        const float qc = sq[g * D + c];
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) part[g][k] = fmaf(qc, x[k], part[g][k]);
      }
  }
}

// V: each of this warp's channels of one tier over the span, lane sums
// merged by a fixed butterfly; lane 0 writes acc[g][c] to out (row
// stride Dv).
template <int LW, int GM>
__device__ __forceinline__ void v_tier(const char* pay, const int8_t* mins,
                                       const uint8_t* sfts, int lp, int C,
                                       const float (&wr)[GM][CHUNK], bool live, int G,
                                       int lane, int warp, int t0, float* out, int Dv) {
  for (int c = warp; c < C; c += NWARPS) {
    float a[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) a[g] = 0.f;
    if (live) {
      float x[CHUNK];
      decode_chunk<LW>(pay, mins, sfts, lp, c, t0, x);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) a[g] = fmaf(wr[g][k], x[k], a[g]);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a[g] += __shfl_xor_sync(0xffffffffu, a[g], o);
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) out[g * Dv + c] = a[g];
  }
}

#define BY_WIDTH(FN, LWV, ...)                \
  switch (LWV) {                              \
    case 0: FN<0, GM>(__VA_ARGS__); break;    \
    case 1: FN<1, GM>(__VA_ARGS__); break;    \
    case 2: FN<2, GM>(__VA_ARGS__); break;    \
    case 3: FN<3, GM>(__VA_ARGS__); break;    \
    default: FN<4, GM>(__VA_ARGS__); break;   \
  }

// Fixed-order block reduction of NV values per thread (NV <= 2 * GM):
// butterfly shuffles inside each warp, then the warp partials added (or
// maxed) in warp order by thread i. Results in out[0 .. NV).
template <bool IS_MAX, int NR>
__device__ __forceinline__ void block_reduce(const float (&v)[NR], int NV,
                                             float (*s_red)[NWARPS], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (i < NV) {
      float x = v[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, o);
        x = IS_MAX ? fmaxf(x, y) : x + y;
      }
      if (lane == 0) s_red[i][warp] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float x = s_red[threadIdx.x][0];
    for (int w = 1; w < NWARPS; ++w)
      x = IS_MAX ? fmaxf(x, s_red[threadIdx.x][w]) : x + s_red[threadIdx.x][w];
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the span kernel and the merge
// ---------------------------------------------------------------------------

// Merge row's live spans in span order (fixed-order LSE merge), add the
// zero term, scatter through the V inverse permutation; run by the row's
// last span block. s_alpha: nsp * G floats of shared scratch.
__device__ __forceinline__ void merge_row(const PackedAttnParams& p, int row, int b, int h,
                                          int nsp, int nspan, float* s_alpha, float* s_z) {
  const int G = static_cast<int>(p.G), Dv = static_cast<int>(p.Dv);
  const int64_t stride = static_cast<int64_t>(G) * (Dv + 3);
  const float* part = p.part + static_cast<int64_t>(row) * nspan * stride;
  if (threadIdx.x < G) {  // m, l, z and the span weights of group g
    const int g = threadIdx.x;
    float M = NEG_INF;
    for (int s = 0; s < nsp; ++s) M = fmaxf(M, __ldcg(part + s * stride + G * Dv + g));
    float l = 0.f, z = 0.f;
    for (int s = 0; s < nsp; ++s) {
      const float* ps = part + s * stride + G * Dv;
      const float a = expf(__ldcg(ps + g) - M);
      s_alpha[s * G + g] = a;
      l = fmaf(a, __ldcg(ps + G + g), l);
      z = fmaf(a, __ldcg(ps + 2 * G + g), z);
    }
    s_z[g] = z;
    p.m_out[row * G + g] = M;
    p.l_out[row * G + g] = l;
  }
  __syncthreads();
  const int32_t* vperm = p.vperm + b * p.vperm_sb + h * p.vperm_sh;
  for (int i = threadIdx.x; i < G * Dv; i += NTHREADS) {
    const int g = i / Dv, c = i - g * Dv;
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < nsp; ++s) acc = fmaf(s_alpha[s * G + g], __ldcg(part + s * stride + i), acc);
    p.out[(static_cast<int64_t>(row) * G + g) * Dv + vperm[c]] = acc + s_z[g];
  }
}

template <bool PAGED, int GM>
__global__ void __launch_bounds__(NTHREADS)
    packed_attention_span_kernel(const PackedAttnParams p, const SmemLayout lay) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float s_red[2 * GM][NWARPS];
  __shared__ float s_stat[3 * GM];  // m, l, z of the span
  __shared__ float s_qsum[GM];
  __shared__ float s_z[GM];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const int b = row / static_cast<int>(p.Hkv), h = row % static_cast<int>(p.Hkv);
  const int s0 = static_cast<int>(blockIdx.y) * SPAN;
  int n = p.n_comp[b];
  n = n < 0 ? 0 : (n > p.L ? static_cast<int>(p.L) : n);
  const int G = static_cast<int>(p.G), D = static_cast<int>(p.D);
  const int Dv = static_cast<int>(p.Dv);
  if (s0 >= n) {  // a dead span; span 0 of an empty row writes its partials
    if (n == 0 && blockIdx.y == 0) {
      for (int i = tid; i < G * Dv; i += NTHREADS) p.out[static_cast<int64_t>(row) * G * Dv + i] = 0.f;
      if (tid < G) p.m_out[row * G + tid] = NEG_INF, p.l_out[row * G + tid] = 0.f;
    }
    return;
  }
  const int nt = min(SPAN, n - s0);
  const int lp = static_cast<int>(p.log2_pack);
  const float sm = static_cast<float>(p.sm_scale);
  float* s_meta = reinterpret_cast<float*>(smem + lay.meta);
  float* s_q = reinterpret_cast<float*>(smem + lay.q);
  float* s_ws = reinterpret_cast<float*>(smem + lay.ws);
  float* s_part = reinterpret_cast<float*>(smem + lay.part);

  // copies: K and the scale/zero (group 1); V follows once K has landed
  stage_tiers<PAGED>(p, p.k, static_cast<int>(p.nk), lay.k_pay, lay.k_min, lay.k_sft, smem,
                     b, h, s0, n, lay.run);
  stage_meta<PAGED>(p, smem + lay.meta, b, h, s0, n, lay.run);
  cp_async_commit();

  // while they fly: absorb the K channel permutation into q
  const int32_t* kperm = p.kperm + b * p.kperm_sb + h * p.kperm_sh;
  const float* qrow = p.q + static_cast<int64_t>(row) * G * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, j = i - g * D;
    s_q[i] = qrow[g * D + kperm[j]];
  }
  __syncthreads();
  if (tid < G) {
    float s = 0.f;
    for (int j = 0; j < D; ++j) s += s_q[tid * D + j];
    s_qsum[tid] = s;
  }
  cp_async_wait<0>();
  __syncthreads();
  // V (group 2) lands while the scores are computed
  if (lay.v_early)
    stage_tiers<PAGED>(p, p.v, static_cast<int>(p.nv), lay.v_pay, lay.v_min, lay.v_sft,
                       smem, b, h, s0, n, lay.run);
  cp_async_commit();

  // scores: lane chunk t0, warp channels; then the warps' sums in order
  const int t0 = lane * CHUNK;
  const bool live = t0 < nt;
  float part[GM][CHUNK];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) part[g][k] = 0.f;
  if (live) {
    int off = 0;
    for (int t = 0; t < p.nk; ++t) {
      const char* pay = smem + lay.k_pay[t];
      const int8_t* mn = reinterpret_cast<const int8_t*>(smem + lay.k_min[t]);
      const uint8_t* sf = reinterpret_cast<const uint8_t*>(smem + lay.k_sft[t]);
      const int C = static_cast<int>(p.k[t].count);
      BY_WIDTH(k_tier, static_cast<int>(p.k[t].log2_w), pay, mn, sf, lp, C, s_q + off, D, G,
               warp, t0, part);
      off += C;
    }
  }
  const bool valid = tid < nt;  // the token this thread scores
  float sc[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    sc[g] = NEG_INF;
    if (g < G) {
      float4* dst = reinterpret_cast<float4*>(s_part + warp * SPAN + t0);
      dst[0] = make_float4(part[g][0], part[g][1], part[g][2], part[g][3]);
      dst[1] = make_float4(part[g][4], part[g][5], part[g][6], part[g][7]);
      __syncthreads();
      float si = s_part[tid];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) si += s_part[w * SPAN + tid];
      if (valid) sc[g] = (si * s_meta[tid] + s_qsum[g] * s_meta[SPAN + tid]) * sm;
      __syncthreads();
    }
  }

  // the span's softmax: one max, then one sum of (p, p * vzero) pairs
  block_reduce<true, GM>(sc, G, s_red, s_stat);
  float pz[2 * GM];  // p and p * vzero of group g at 2g, 2g + 1
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const float pr = (valid && g < G) ? expf(sc[g] - s_stat[g]) : 0.f;
    pz[2 * g] = pr;
    pz[2 * g + 1] = valid ? pr * s_meta[3 * SPAN + tid] : 0.f;
    if (g < G) s_ws[g * SPAN + tid] = valid ? pr * s_meta[2 * SPAN + tid] : 0.f;
  }
  block_reduce<false, 2 * GM>(pz, 2 * G, s_red, s_stat + GM);  // l, z of g at GM + 2g, + 1

  // V (after its copies land): warp channels, lane chunk t0
  if (!lay.v_early) {
    stage_tiers<PAGED>(p, p.v, static_cast<int>(p.nv), lay.v_pay, lay.v_min, lay.v_sft,
                       smem, b, h, s0, n, lay.run);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  float wr[GM][CHUNK];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    if (g < G && live) {
      const float4* src = reinterpret_cast<const float4*>(s_ws + g * SPAN + t0);
      a = src[0];
      c = src[1];
    }
    wr[g][0] = a.x, wr[g][1] = a.y, wr[g][2] = a.z, wr[g][3] = a.w;
    wr[g][4] = c.x, wr[g][5] = c.y, wr[g][6] = c.z, wr[g][7] = c.w;
  }
  const int64_t stride = static_cast<int64_t>(G) * (Dv + 3);
  float* out = p.part + (static_cast<int64_t>(row) * gridDim.y + blockIdx.y) * stride;
  int off = 0;
  for (int t = 0; t < p.nv; ++t) {
    const char* pay = smem + lay.v_pay[t];
    const int8_t* mn = reinterpret_cast<const int8_t*>(smem + lay.v_min[t]);
    const uint8_t* sf = reinterpret_cast<const uint8_t*>(smem + lay.v_sft[t]);
    const int C = static_cast<int>(p.v[t].count);
    BY_WIDTH(v_tier, static_cast<int>(p.v[t].log2_w), pay, mn, sf, lp, C, wr, live, G, lane,
             warp, t0, out + off, Dv);
    off += C;
  }
  if (tid < G) {
    out[G * Dv + tid] = s_stat[tid];                       // m
    out[G * Dv + G + tid] = s_stat[GM + 2 * tid];          // l
    out[G * Dv + 2 * G + tid] = s_stat[GM + 2 * tid + 1];  // z
  }
  // the row's last live span to finish merges; the atomic counts
  // arrivals only (no value is accumulated), and the merger resets it
  __threadfence();
  __syncthreads();
  const int nsp = (n + SPAN - 1) / SPAN;
  if (tid == 0) s_last = atomicAdd(p.counters + row, 1) == nsp - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_row(p, row, b, h, nsp, static_cast<int>(gridDim.y), s_part, s_z);
  if (tid == 0) p.counters[row] = 0;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int align16(int x) { return (x + 15) & ~15; }

// The current device's opt-in shared memory a block, less room for the
// kernel's static shared memory (under 1.4 KB at GM = 16; read on every
// launch: it is one attribute query).
static int max_smem() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v - 2048;
}

// The dynamic shared memory of a launch: the fixed parts, K's tiers, then
// V's beside them or, if both do not fit, over K's (copied after the
// scores).
static SmemLayout layout(const PackedAttnParams& p, bool paged) {
  SmemLayout s{};
  const int lp = static_cast<int>(p.log2_pack);
  int off = 0;
  s.meta = off, off += 4 * SPAN * 4;
  s.q = off, off = align16(off + static_cast<int>(p.G * p.D) * 4);
  s.ws = off, off += static_cast<int>(p.G) * SPAN * 4;
  s.part = off, off += NWARPS * SPAN * 4;
  auto tiers = [&](const TierDesc* d, int64_t nt, int32_t* pay, int32_t* mn, int32_t* sf,
                   int o) {
    for (int t = 0; t < nt; ++t) {
      const int C = static_cast<int>(d[t].count), lw = static_cast<int>(d[t].log2_w);
      pay[t] = o, o = align16(o + C * ((SPAN << lw) >> 3));
      mn[t] = o, o = align16(o + C * (SPAN >> lp));
      sf[t] = o, o = align16(o + C * (SPAN >> (lp + 2)));
    }
    return o;
  };
  const int k_end = tiers(p.k, p.nk, s.k_pay, s.k_min, s.k_sft, off);
  const int both = tiers(p.v, p.nv, s.v_pay, s.v_min, s.v_sft, k_end);
  s.v_early = both <= max_smem();
  if (!s.v_early) {
    const int v_end = tiers(p.v, p.nv, s.v_pay, s.v_min, s.v_sft, off);
    s.total = k_end > v_end ? k_end : v_end;
  } else {
    s.total = both;
  }
  const int64_t unit = paged ? p.page_size : p.L;
  s.run = SPAN;
  while (unit % s.run) s.run >>= 1;
  return s;
}

template <bool PAGED, int GM>
static cudaError_t launch_span(const PackedAttnParams& p, const SmemLayout& s, dim3 grid,
                               cudaStream_t st) {
  auto kernel = packed_attention_span_kernel<PAGED, GM>;
  // above 48 KB a launch needs the opt-in; set on every such launch (it
  // is per device, and cheap), so a second device gets it too
  if (s.total > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, NTHREADS, s.total, st>>>(p, s);
  return cudaGetLastError();
}

template <bool PAGED>
static int launch(const PackedAttnParams* p, void* stream) {
  const SmemLayout s = layout(*p, PAGED);
  if (s.total > max_smem() || s.run < (4 << p->log2_pack) || s.run < 32 || p->G > MAX_G ||
      p->D > MAX_D || p->Dv > MAX_D || (p->L + SPAN - 1) / SPAN * p->G > NWARPS * SPAN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nspan = static_cast<int>((p->L + SPAN - 1) / SPAN);
  const dim3 grid(static_cast<unsigned>(p->B * p->Hkv), static_cast<unsigned>(nspan));
  cudaError_t e;
  if (p->G == 1)
    e = launch_span<PAGED, 1>(*p, s, grid, st);
  else if (p->G == 2)
    e = launch_span<PAGED, 2>(*p, s, grid, st);
  else if (p->G <= 4)
    e = launch_span<PAGED, 4>(*p, s, grid, st);
  else if (p->G <= 8)
    e = launch_span<PAGED, 8>(*p, s, grid, st);
  else
    e = launch_span<PAGED, 16>(*p, s, grid, st);
  return static_cast<int>(e);
}

extern "C" int packed_attention_params_size() {
  return static_cast<int>(sizeof(PackedAttnParams));
}

extern "C" int packed_attention_span() { return SPAN; }

// The dynamic shared memory one span block of this launch takes, in bytes.
extern "C" int packed_attention_smem_bytes(const PackedAttnParams* p, int paged) {
  return layout(*p, paged != 0).total;
}

// Launch the span kernel on `stream`; return cudaGetLastError() (0 on
// success). The caller checks shapes, types and strides, allocates
// p->part and passes zeroed p->counters (kernels/packed_attention.py).
extern "C" int packed_attention_launch(const PackedAttnParams* p, void* stream) {
  return launch<false>(p, stream);  // K2: dense leaves
}

extern "C" int packed_attention_paged_launch(const PackedAttnParams* p,
                                             void* stream) {
  return launch<true>(p, stream);  // K5: pool leaves + page table
}
