// K2 and K3: paged flash-decode over a page pool, one online-softmax body
// behind a page-load hook, as in the TPU template.
//
// Replaces src/repro/kernels/attention_template.py: fused_paged_attention
// (online_softmax_step, row_lengths, launched through _launch ->
// pallas_call) with
//   K2: the _make_load_ams hook (restore_page): packed AMS-e2m2 pages;
//   K3: the _load_pair hook with pv_dtype = the pool's bf16: bf16 pages.
//
// Per (slot b, kv head h) the kernel walks block_table[b, i], loads each
// page's K and V into shared memory as f32 (K2 restores the packed planes -
// hi nibbles, shared-LSB bitplane, f32 scale per token and head - to exact
// lattice values; K3 widens bf16 rows, read with 16-byte loads, which is
// exact), and runs the online softmax of the reference: scores get an
// additive -2e30 mask past a row's length, the running max is clamped at
// -1e30, so masked scores give exp(...) == 0 exactly and a row of length 0
// ends as exact zeros; the output is acc / max(l, 1e-20). K3 rounds p to
// bf16 at the running max before the PV product (l sums the unrounded p),
// as the template does with pv_dtype. Ragged chunks arrive folded: row r of
// the [R = c*g] query block belongs to query r / g (chunk-major), whose
// valid key count is lengths[b*c + r/g].
//
// Bound: each page is read once per (slot, head, row tile) and the work per
// byte is small, so both are bound by device-memory bytes at decode.
// Design: one warp per folded query row (8 rows per block, so decode with
// g = 7 needs one block per (slot, head)); each lane holds hd/32 dims of q
// and of the accumulator. The block stops after the last page any of its
// rows can see: pages past every row's length contribute exact zeros in
// the reference, so skipping them is exact. Known weak spot: 8 slots x 4
// kv heads fill 32 of the H100's 132 SMs at decode (a split-KV pass with a
// (m, l, acc) combine is later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define K2_WARPS 8
#define K2_HD_MAX 128
#define K2_PAGE_MAX 32
#define K2_DPL (K2_HD_MAX / 32)
#define NEG_BIG (-2e30f)
#define NEG_CLAMP (-1e30f)

// e2m2, bias 1: code = S << 4 | E << 2 | M
__device__ __forceinline__ float decode_e2m2(int code) {
  const int M = code & 3;
  const int E = (code >> 2) & 3;
  const int S = (code >> 4) & 1;
  float v;
  if (E == 0) {
    v = (float)M * 0.25f;                           // M * 2^(1 - 1 - 2)
  } else {
    v = __int_as_float(((E - 1 + 127) << 23) | (M << 21));
  }
  return S ? -v : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// --- page-load hooks: one page of one kv head -> Ks/Vs [t][d] f32 ---------

// K2: packed AMS-e2m2 planes restored to lattice values times scale
struct AmsPages {
  const int8_t* khi; const int32_t* klsb; const float* ksc;
  const int8_t* vhi; const int32_t* vlsb; const float* vsc;
  int hb, gw, ksh;
  static constexpr bool kPvBf16 = false;

  __device__ __forceinline__ void restore(float (*dst)[K2_HD_MAX], const int8_t* __restrict__ hi,
                                          const int32_t* __restrict__ lsb,
                                          const float* __restrict__ sc, int64_t pg, int page,
                                          int kv, int h, int hd) const {
    for (int i = threadIdx.x; i < page * hd; i += blockDim.x) {
      const int t = i / hd, d = i - t * hd;
      const int64_t vec = (pg * page + t) * kv + h;
      const int byte = ((int)hi[vec * hb + (d >> 1)]) & 0xFF;
      const int nib = (d & 1) ? ((byte >> 4) & 0xF) : (byte & 0xF);
      const int grp = d / ksh;
      const int bit = (lsb[vec * gw + (grp >> 5)] >> (grp & 31)) & 1;
      dst[t][d] = decode_e2m2((nib << 1) | bit) * sc[vec];
    }
  }
  __device__ __forceinline__ void load(float (*Ks)[K2_HD_MAX], float (*Vs)[K2_HD_MAX],
                                       int64_t pg, int page, int kv, int h, int hd) const {
    restore(Ks, khi, klsb, ksc, pg, page, kv, h, hd);
    restore(Vs, vhi, vlsb, vsc, pg, page, kv, h, hd);
  }
};

// K3: bf16 pages [P, page, kv, hd], widened to f32 (exact)
struct Bf16Pages {
  const __nv_bfloat16* k; const __nv_bfloat16* v;
  static constexpr bool kPvBf16 = true;

  __device__ __forceinline__ static void widen(float (*dst)[K2_HD_MAX],
                                               const __nv_bfloat16* __restrict__ src,
                                               int64_t pg, int page, int kv, int h, int hd) {
    if ((hd & 7) == 0) {               // 16-byte loads: 8 bf16 per thread
      const int vpr = hd >> 3;         // vectors per row
      for (int i = threadIdx.x; i < page * vpr; i += blockDim.x) {
        const int t = i / vpr, d = (i - t * vpr) << 3;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + ((pg * page + t) * kv + h) * (int64_t)hd + d);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(p2[j]);
          dst[t][d + 2 * j] = f.x;
          dst[t][d + 2 * j + 1] = f.y;
        }
      }
    } else {
      for (int i = threadIdx.x; i < page * hd; i += blockDim.x) {
        const int t = i / hd, d = i - t * hd;
        dst[t][d] = __bfloat162float(src[((pg * page + t) * kv + h) * (int64_t)hd + d]);
      }
    }
  }
  __device__ __forceinline__ void load(float (*Ks)[K2_HD_MAX], float (*Vs)[K2_HD_MAX],
                                       int64_t pg, int page, int kv, int h, int hd) const {
    widen(Ks, k, pg, page, kv, h, hd);
    widen(Vs, v, pg, page, kv, h, hd);
  }
};

// --- the shared online-softmax walk -----------------------------------------
template <class Pages>
__global__ void __launch_bounds__(K2_WARPS * 32)
paged_attention_kernel(const float* __restrict__ q, const Pages pages,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ lengths, float* __restrict__ out,
                       int kv, int R, int hd, int page, int MP, int c, int g) {
  __shared__ __align__(16) float Ks[K2_PAGE_MAX][K2_HD_MAX];
  __shared__ __align__(16) float Vs[K2_PAGE_MAX][K2_HD_MAX];
  __shared__ int maxlen_s;
  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.z * K2_WARPS + warp;
  const bool has_row = row < R;
  const int len = has_row ? lengths[(int64_t)b * c + row / g] : 0;

  if (threadIdx.x == 0) maxlen_s = 0;
  __syncthreads();
  if (lane == 0 && has_row && len > 0) atomicMax(&maxlen_s, len);
  __syncthreads();
  const int maxlen = min(maxlen_s, MP * page);
  const int npages = (maxlen + page - 1) / page;

  const int64_t qo = (((int64_t)b * kv + h) * R + row) * hd;
  float qr[K2_DPL], acc[K2_DPL];
#pragma unroll
  for (int j = 0; j < K2_DPL; ++j) {
    const int d = lane + 32 * j;
    qr[j] = (has_row && d < hd) ? q[qo + d] : 0.f;
    acc[j] = 0.f;
  }
  float m = NEG_CLAMP, l = 0.f;

  for (int i = 0; i < npages; ++i) {
    const int64_t pg = block_table[(int64_t)b * MP + i];
    __syncthreads();                     // previous page fully consumed
    pages.load(Ks, Vs, pg, page, kv, h, hd);
    __syncthreads();
    if (has_row) {                       // warp-uniform
      float my_s = 0.f;                  // lane t keeps the score of token t
      for (int t = 0; t < page; ++t) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < K2_DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) part = fmaf(qr[j], Ks[t][d], part);
        }
        part = warp_sum(part);
        if (lane == t) my_s = part;
      }
      const int kpos = i * page + lane;
      const float s = (lane < page) ? my_s + ((kpos < len) ? 0.f : NEG_BIG) : -INFINITY;
      const float m_new = fmaxf(fmaxf(m, warp_max(s)), NEG_CLAMP);
      const float p = (lane < page) ? expf(s - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(p);
      // the PV product takes p in the pages' type (bf16 for K3)
      const float pv = Pages::kPvBf16 ? __bfloat162float(__float2bfloat16(p)) : p;
#pragma unroll
      for (int j = 0; j < K2_DPL; ++j) acc[j] *= corr;
      for (int t = 0; t < page; ++t) {
        const float pt = __shfl_sync(0xffffffffu, pv, t);
#pragma unroll
        for (int j = 0; j < K2_DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) acc[j] = fmaf(pt, Vs[t][d], acc[j]);
        }
      }
      m = m_new;
    }
  }
  if (has_row) {
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int j = 0; j < K2_DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) out[qo + d] = acc[j] / den;
    }
  }
}

template <class Pages>
static int launch(const void* q, const Pages& pages, const void* block_table,
                  const void* lengths, void* out, int B, int kv, int R, int hd, int page,
                  int MP, int c, int g, void* stream) {
  if (B <= 0 || kv <= 0 || R <= 0) return (int)cudaSuccess;
  if (hd > K2_HD_MAX || page > K2_PAGE_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid(B, kv, (R + K2_WARPS - 1) / K2_WARPS);
  paged_attention_kernel<Pages><<<grid, K2_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, pages, (const int32_t*)block_table, (const int32_t*)lengths,
      (float*)out, kv, R, hd, page, MP, c, g);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_ams(const void* q, const void* khi, const void* klsb,
                                   const void* ksc, const void* vhi, const void* vlsb,
                                   const void* vsc, const void* block_table,
                                   const void* lengths, void* out, int B, int kv, int R,
                                   int hd, int hb, int gw, int ksh, int page, int MP,
                                   int c, int g, void* stream) {
  AmsPages pages{(const int8_t*)khi, (const int32_t*)klsb, (const float*)ksc,
                 (const int8_t*)vhi, (const int32_t*)vlsb, (const float*)vsc, hb, gw, ksh};
  return launch(q, pages, block_table, lengths, out, B, kv, R, hd, page, MP, c, g, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* block_table, const void* lengths, void* out,
                                    int B, int kv, int R, int hd, int page, int MP, int c,
                                    int g, void* stream) {
  Bf16Pages pages{(const __nv_bfloat16*)k, (const __nv_bfloat16*)v};
  return launch(q, pages, block_table, lengths, out, B, kv, R, hd, page, MP, c, g, stream);
}
