// K2 and K5: fused decode attention over the tier-packed KV cache, for
// sm_90a, in one kernel body templated on how a context tile is addressed.
//
// K2 replaces repro/kernels/packed_attention.py::fused_packed_attention
// (the Pallas kernel _fused_kernel + _flash_tile_body) over the DENSE
// cache; K5 replaces ::fused_packed_attention_paged (_paged_fused_kernel)
// over the PAGE POOL. One launch per layer per decode step computes, for
// every (batch row, kv head), the log-sum-exp partials of attention over
// that row's compressed region:
//   scores[g, l] = (q_perm[g] . K_int[:, l] * kscale[l]
//                   + sum(q[g]) * kzero[l]) * sm_scale,  l < n_comp[b]
//   m[g], l[g]   = running max / normalizer of exp(scores)
//   acc[g, c]    = sum_l p[g, l] * vscale[l] * V_int[c, l]
//                  + sum_l p[g, l] * vzero[l]
// with K_int / V_int decoded from their tiers in registers (unpack.cuh).
// The K channel permutation is applied to q in the prologue and the V
// inverse permutation in the epilogue's scatter; the residual-buffer merge
// happens outside (kernels/ops.py).
//
// Addressing. Dense (K2): leaves are [B, H_kv, C, units]; the tile's
// storage row is batch row b and token l sits at l. Paged (K5): leaves are
// pools [H_kv, n_pool_pages, C, page units]; a tile never straddles a page
// (tile_l divides page_size), so each tile resolves its physical page
// once, phys = page_table[b, t0 / page_size], and token l sits at
// l % page_size of that page: payload word (l % page) >> log2(32 / w),
// pack min (l % page) >> log2(pack), shift byte that >> 2 (the
// pool-layout contract of repro/kernels/pallas_utils.py). The per-token
// scale / zero are read from the pool [H_kv, P, page] through the same
// phys, where the reference gathered them dense outside the kernel. The
// descriptors' "row" strides are the batch stride (dense) or the page
// stride (paged); everything else is the same code, so K5 on a pool and
// K2 on its gathered dense view do the same float operations in the same
// order and give bitwise-equal results.
//
// Bound on the H100 SXM: memory. Each live token costs the compressed K
// and V payload bits, 10 bits of pack metadata per value / pack_size, and
// 16 bytes of f32 scale/zero per (token, head); the kernel's least time is
// those bytes over 3.35 TB/s (about 28 MB per layer at llama2-7b with
// B=4, 1k live tokens and 5 payload bits per value: about 8 us). K5 reads
// one page-table entry more per tile.
//
// Design (simple first; it is far from that bound):
//   * one 256-thread block per (b, kv head) row; a loop inside the block
//     walks 256-token context tiles up to the row's n_comp (the TPU's
//     sequential grid axis becomes the loop, tile skipping its bound);
//   * scores: one thread per token, integer dot over every K tier;
//   * V: one thread per channel, sequential over the tile's tokens;
//   * online-softmax state in shared memory; every sum is an f32 FMA or a
//     fixed-order warp-shuffle + shared-memory reduction. No atomics, so
//     two launches give bitwise-identical outputs.
// Left on the table: no cp.async/TMA staging of tiles in shared memory
// (the V loop reads each row with a stride), no split of the context over
// several blocks (B * H_kv blocks must fill 132 SMs alone), and at
// llama2's G = 1 the work is a GEMV that no tensor core can help.
#include <cuda_runtime.h>

#include <cstdint>

#include "unpack.cuh"

#define MAX_TIERS 6
#define MAX_G 8
#define MAX_D 256
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
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
  int64_t B, Hkv, G, D, Dv, L, log2_pack, tile_l;  // paged: L = n_tokens
  double sm_scale;
};

// Fixed-order block reduction of G values per thread: butterfly shuffles
// inside each warp, then warp partials summed in warp order by thread g.
template <bool IS_MAX>
__device__ __forceinline__ void block_reduce(const float (&v)[MAX_G], int G,
                                             float (*s_red)[NWARPS],
                                             float* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      float x = v[g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, o);
        x = IS_MAX ? fmaxf(x, y) : x + y;
      }
      if (lane == 0) s_red[g][warp] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float x = s_red[threadIdx.x][0];
    for (int w = 1; w < NWARPS; ++w)
      x = IS_MAX ? fmaxf(x, s_red[threadIdx.x][w]) : x + s_red[threadIdx.x][w];
    s_out[threadIdx.x] = x;
  }
  __syncthreads();
}

template <bool PAGED>
__global__ void __launch_bounds__(NTHREADS)
    packed_attention_kernel(const PackedAttnParams p) {
  __shared__ float s_q[MAX_G][MAX_D];     // q permuted by K's chan_perm
  __shared__ float s_w[MAX_G][NTHREADS];  // tile weights p * vscale
  __shared__ float s_red[MAX_G][NWARPS];
  __shared__ float s_m[MAX_G], s_l[MAX_G], s_z[MAX_G], s_alpha[MAX_G];
  __shared__ float s_qsum[MAX_G], s_max[MAX_G], s_psum[MAX_G], s_zsum[MAX_G];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.Hkv, h = blockIdx.x % p.Hkv;
  const int G = p.G, D = p.D, Dv = p.Dv, TL = p.tile_l;
  const float sm = static_cast<float>(p.sm_scale);

  // prologue: absorb the K channel permutation into q
  const int32_t* kperm = p.kperm + b * p.kperm_sb + h * p.kperm_sh;
  const float* qrow = p.q + (static_cast<int64_t>(b) * p.Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, j = i % D;
    s_q[g][j] = qrow[g * D + kperm[j]];
  }
  if (tid < G) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
    s_z[tid] = 0.f;
  }
  __syncthreads();
  if (tid < G) {
    float s = 0.f;
    for (int j = 0; j < D; ++j) s += s_q[tid][j];
    s_qsum[tid] = s;
  }

  int n = p.n_comp[b];
  n = n < 0 ? 0 : (n > p.L ? static_cast<int>(p.L) : n);

  // this thread's V channel (tier order): its tier and row within it
  int v_t = -1, v_c = 0;
  {
    int off = 0;
    for (int t = 0; t < p.nv; ++t) {
      const int c = tid - off;
      if (c >= 0 && c < p.v[t].count) {
        v_t = t;
        v_c = c;
      }
      off += static_cast<int>(p.v[t].count);
    }
  }
  const int lp = static_cast<int>(p.log2_pack);
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += TL) {
    // the tile's storage row s (batch row, or the physical page) and the
    // tile's first token within it
    int64_t s = b;
    int lt0 = t0;
    if (PAGED) {
      s = p.page_table[b * p.pt_sb + t0 / p.page_size];
      lt0 = static_cast<int>(t0 % p.page_size);
    }
    const int l = t0 + tid;  // the token's position in the row
    const int ll = lt0 + tid;  // ... and in its storage row
    const bool valid = tid < TL && l < n;
    float sc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) sc[g] = NEG_INF;
    if (valid) {
      float si[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) si[g] = 0.f;
      int off = 0;
      for (int t = 0; t < p.nk; ++t) {
        const TierDesc& d = p.k[t];
        const int32_t* pay = d.payload + s * d.pay_sb + h * d.pay_sh;
        const int8_t* mn = d.mins + s * d.min_sb + h * d.min_sh;
        const uint8_t* sf = d.shifts + s * d.sft_sb + h * d.sft_sh;
        const int lw = static_cast<int>(d.log2_w);
#pragma unroll 4
        for (int c = 0; c < d.count; ++c) {
          const float x = static_cast<float>(decode_tier_value(
              pay + c * d.pay_sc, mn + c * d.min_sc, sf + c * d.sft_sc, lw, lp, ll));
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) si[g] = fmaf(s_q[g][off + c], x, si[g]);
        }
        off += static_cast<int>(d.count);
      }
      const float ks = p.kscale[s * p.kscale_sb + h * p.kscale_sh + ll];
      const float kz = p.kzero[s * p.kzero_sb + h * p.kzero_sh + ll];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) sc[g] = (si[g] * ks + s_qsum[g] * kz) * sm;
    }
    // online softmax over the tile
    block_reduce<true>(sc, G, s_red, s_max);
    if (tid < G) {
      const float m_new = fmaxf(s_m[tid], s_max[tid]);
      s_alpha[tid] = expf(s_m[tid] - m_new);
      s_m[tid] = m_new;
    }
    __syncthreads();
    float pr[MAX_G], pz[MAX_G];
    const float vs = valid ? p.vscale[s * p.vscale_sb + h * p.vscale_sh + ll] : 0.f;
    const float vz = valid ? p.vzero[s * p.vzero_sb + h * p.vzero_sh + ll] : 0.f;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      pr[g] = (valid && g < G) ? expf(sc[g] - s_m[g]) : 0.f;
      pz[g] = pr[g] * vz;
      if (g < G && tid < TL) s_w[g][tid] = pr[g] * vs;
    }
    block_reduce<false>(pr, G, s_red, s_psum);
    block_reduce<false>(pz, G, s_red, s_zsum);
    if (tid < G) {
      s_l[tid] = s_l[tid] * s_alpha[tid] + s_psum[tid];
      s_z[tid] = s_z[tid] * s_alpha[tid] + s_zsum[tid];
    }
    // V: this thread's channel over the tile's live tokens
    if (v_t >= 0) {
      const TierDesc& d = p.v[v_t];
      const int32_t* v_pay = d.payload + s * d.pay_sb + h * d.pay_sh + v_c * d.pay_sc;
      const int8_t* v_min = d.mins + s * d.min_sb + h * d.min_sh + v_c * d.min_sc;
      const uint8_t* v_sft = d.shifts + s * d.sft_sb + h * d.sft_sh + v_c * d.sft_sc;
      const int v_lw = static_cast<int>(d.log2_w);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) acc[g] *= s_alpha[g];
      const int nl = min(TL, n - t0);
#pragma unroll 4
      for (int j = 0; j < nl; ++j) {
        const float x = static_cast<float>(
            decode_tier_value(v_pay, v_min, v_sft, v_lw, lp, lt0 + j));
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) acc[g] = fmaf(s_w[g][j], x, acc[g]);
      }
    }
    __syncthreads();
  }

  // epilogue: zero-term, V inverse permutation (scatter), partials
  const int64_t row = static_cast<int64_t>(b) * p.Hkv + h;
  if (v_t >= 0 && tid < Dv) {
    const int32_t* vperm = p.vperm + b * p.vperm_sb + h * p.vperm_sh;
    const int orig = vperm[tid];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) p.out[(row * G + g) * Dv + orig] = acc[g] + s_z[g];
  }
  if (tid < G) {
    p.m_out[row * G + tid] = s_m[tid];
    p.l_out[row * G + tid] = s_l[tid];
  }
}

template <bool PAGED>
static int launch(const PackedAttnParams* p, void* stream) {
  const dim3 grid(static_cast<unsigned>(p->B * p->Hkv));
  packed_attention_kernel<PAGED>
      <<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int packed_attention_params_size() {
  return static_cast<int>(sizeof(PackedAttnParams));
}

// Launch on `stream`; return cudaGetLastError() (0 on success). The
// caller checks shapes, types and strides (kernels/packed_attention.py).
extern "C" int packed_attention_launch(const PackedAttnParams* p, void* stream) {
  return launch<false>(p, stream);  // K2: dense leaves
}

extern "C" int packed_attention_paged_launch(const PackedAttnParams* p,
                                             void* stream) {
  return launch<true>(p, stream);  // K5: pool leaves + page table
}
