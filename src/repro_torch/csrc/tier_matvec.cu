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
// Design (simple first). A first version walked each row with one chain
// of dependent loads per thread (K3: a thread per token over all channels)
// or per warp (K4), which left too few loads in flight to cover the
// latency of device memory (PERF.md); these keep more in flight and read
// each channel row in coalesced runs.
//   * K3/K6: one 256-thread block per (row, 256-token span). Warp w takes
//     the channels w, w + 8, ..., lane j the span's 8-token chunk j: for
//     each channel the warp reads one coalesced run of the channel row
//     (the loads of 4 channels in flight together), decodes its chunk once
//     per word, min and shift, and FMAs with q[c] from shared memory into
//     8 partial scores; the warps' partials of each token are then added
//     in warp order through shared memory. A span at or past n_valid
//     writes zeros only.
//   * K4/K7: one warp per (row, channel), 8 warps a block; lane j takes the
//     8-token chunks j, j + 32, ... of the row in order. Each step a lane
//     first loads the words, min and shift of 4 chunks (a warp: 4
//     coalesced requests of one channel row), then decodes them and FMAs
//     with w, read as float4. Lane sums merge by a fixed butterfly of
//     shuffles.
//   A chunk never straddles a payload word, a pack or a page. No atomics:
//   two launches are bitwise equal.
// Left on the table: no cp.async/TMA staging; K3 reads q from shared
// memory once per (channel, chunk); K4 re-reads w once per channel from
// L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "unpack.cuh"

#define MAX_G 8
#define MAX_C 256
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define CHUNK 8  // K4/K7: consecutive tokens per lane and chunk
#define CPL 4    // K4/K7: chunks per lane whose loads are in flight together
#define SPAN (32 * CHUNK)  // K3/K6: tokens a block covers, one a thread
static_assert(SPAN == NTHREADS, "K3 writes one token per thread");
#define KUNROLL 4  // K3/K6: channels per warp whose loads are in flight together

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

template <bool PAGED, int LW>
__global__ void __launch_bounds__(NTHREADS)
    vpack_out_kernel(const TierMatvecParams p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x;
  const int c = static_cast<int>(blockIdx.y) * NWARPS + warp;
  if (c >= p.C) return;  // whole warps; no block barrier below
  const int G = static_cast<int>(p.G);
  const int n = clamp_n(p, r);
  const float* w = p.x + r * p.x_sr;
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;

  // lane's chunks lane, lane + 32, ... in order, CPL of them loaded at once
  for (int base = lane * CHUNK; base < n; base += 32 * CHUNK * CPL) {
    Chunk<LW> ch[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int l0 = base + j * 32 * CHUNK;
      if (l0 < n) {
        int64_t s;
        int h, ll0;
        locate<PAGED>(p, r, l0, s, h, ll0);
        ch[j].load(p, s, h, ll0, c);
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int l0 = base + j * 32 * CHUNK;
      if (l0 >= n) break;
      float x[CHUNK];
      ch[j].decode(l0, x);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float4* w4 = reinterpret_cast<const float4*>(w + g * p.x_sg + l0);
          const float4 a = __ldg(w4), b = __ldg(w4 + 1);
          const float wk[CHUNK] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int k = 0; k < CHUNK; ++k)
            if (l0 + k < n) acc[g] = fmaf(wk[k], x[k], acc[g]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) p.out[(static_cast<int64_t>(r) * G + g) * p.C + c] = acc[g];
  }
}

// One instantiation per tier width: log2 of 1, 2, 4, 8, 16 = 0..4.
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

template <bool PAGED>
static int launch_out(const TierMatvecParams* p, void* stream) {
  const dim3 grid(static_cast<unsigned>(p->BH),
                  static_cast<unsigned>((p->C + NWARPS - 1) / NWARPS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  LAUNCH_BY_WIDTH(vpack_out_kernel);
}

extern "C" int tier_matvec_params_size() {
  return static_cast<int>(sizeof(TierMatvecParams));
}

// Launch on `stream`; return cudaGetLastError() (0 on success). The
// callers check shapes, types and strides (kernels/kpack_matvec.py,
// kernels/vpack_matvec.py).
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
