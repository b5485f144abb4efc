// K4 and K5: flash-decode over a contiguous cache, one online-softmax body
// behind a row-load hook, as in the TPU template.
//
// Replaces src/repro/kernels/attention_template.py: fused_contiguous_attention
// (online_softmax_step, row_lengths, launched through _launch -> pallas_call)
// with
//   K4: the _load_pair hook, pv_dtype = the cache's bf16: a GQA cache of
//       separate K and V [B, S, kv, hd] (the JAX engine's default cache);
//   K5: the _make_load_stream(hd_v) hook: one absorbed-MLA stream
//       [B, S, kv, hd] whose values are its first hd_v columns.
//
// Per (slot b, kv head h, tile of 8 folded query rows) the kernel walks the
// keys in the reference's blocks of block_kv keys. The TPU kernel rounds p to
// bf16 at the running max of each block, so to give its numbers a block is
// read twice, in sub-tiles of 32 keys through shared memory (bf16 widened
// exactly to f32, 16-byte loads): pass 1 takes each row's max over the
// block's scores, pass 2 recomputes the scores, forms p = exp(s - m_new)
// (l sums p unrounded) and adds bf16(p) * v into the accumulator, which is
// rescaled by exp(m - m_new) only at block boundaries. Scores get an
// additive -2e30 mask past a row's length and the running max is clamped at
// -1e30, so masked keys give exp(...) == 0 exactly and a row of length 0
// ends as exact zeros; the output is acc / max(l, 1e-20). Ragged chunks
// arrive folded: row r of the [R = c*g] query block belongs to query r / g
// (chunk-major), whose valid key count is lengths[b*c + r/g]. K5 reads V as
// the first hd_v columns of the K sub-tile already in shared memory, so the
// values cost no extra read.
//
// Bound: at decode the keys are read once per (slot, head, row tile) and
// each byte feeds few operations, so K4 is bound by device-memory bytes; K5
// shares one stream across 40 heads (rows = c * 40), so its bound is the
// operations, 2 * (hd + hd_v) per row and key. Design: one warp per folded
// query row (8 per block), each lane holding hd/32 dims of q and hd_v/32 of
// the accumulator; the block stops after the last key any of its rows can
// see (keys past every row's length contribute exact zeros in the
// reference, so skipping them is exact). Row tiles of one (slot, head) run
// in separate blocks with their own accumulators. Known weak spots: the
// scores of a block are computed twice, every row tile re-reads the keys,
// and 8 slots x 4 kv heads fill 32 of the 132 SMs at GQA decode (wgmma for
// the 40 MLA heads sharing one stream, and split-KV, are later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define CA_WARPS 8
#define CA_TILE 32            // keys per shared-memory sub-tile: one per lane
#define NEG_BIG (-2e30f)
#define NEG_CLAMP (-1e30f)

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

// Rows t0 .. t0+n-1 of head h of slot b of a [B, S, kv, W] bf16 cache ->
// dst[i * W + d] f32 (exact), with 16-byte loads when ``vec``.
__device__ __forceinline__ void widen_rows(float* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ src, int b,
                                           int t0, int n, int S, int kv, int h, int W,
                                           bool vec) {
  if (vec) {                            // 8 bf16 per thread and load
    const int vpr = W >> 3;
    for (int i = threadIdx.x; i < n * vpr; i += blockDim.x) {
      const int t = i / vpr, d = (i - t * vpr) << 3;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (((int64_t)b * S + t0 + t) * kv + h) * W + d);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p2[j]);
        dst[t * W + d + 2 * j] = f.x;
        dst[t * W + d + 2 * j + 1] = f.y;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * W; i += blockDim.x) {
      const int t = i / W, d = i - t * W;
      dst[i] = __bfloat162float(src[(((int64_t)b * S + t0 + t) * kv + h) * W + d]);
    }
  }
}

// --- row-load hooks: keys (and values) t0 .. t0+n-1 -> shared f32 tiles ----

// K4: separate K [B, S, kv, hd] and V [B, S, kv, hd_v]
struct PairRows {
  const __nv_bfloat16* k; const __nv_bfloat16* v;
  bool kvec, vvec;
  static constexpr bool kStream = false;

  __device__ __forceinline__ void keys(float* Ks, int b, int t0, int n, int S, int kv, int h,
                                       int hd) const {
    widen_rows(Ks, k, b, t0, n, S, kv, h, hd, kvec);
  }
  __device__ __forceinline__ void values(float* Vs, int b, int t0, int n, int S, int kv,
                                         int h, int hd_v) const {
    widen_rows(Vs, v, b, t0, n, S, kv, h, hd_v, vvec);
  }
};

// K5: one stream [B, S, kv, hd]; the values are the first hd_v columns of
// the key tile already in shared memory
struct StreamRows {
  const __nv_bfloat16* k;
  bool kvec;
  static constexpr bool kStream = true;

  __device__ __forceinline__ void keys(float* Ks, int b, int t0, int n, int S, int kv, int h,
                                       int hd) const {
    widen_rows(Ks, k, b, t0, n, S, kv, h, hd, kvec);
  }
  __device__ __forceinline__ void values(float*, int, int, int, int, int, int, int) const {}
};

// Lane t gets the masked score of key t0 + t (-inf past the sub-tile).
template <int DPL>
__device__ __forceinline__ float tile_scores(const float (&qr)[DPL], const float* Ks, int n,
                                             int hd, int t0, int len, int lane) {
  float my_s = 0.f;
  for (int t = 0; t < n; ++t) {
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) part = fmaf(qr[j], Ks[t * hd + d], part);
    }
    part = warp_sum(part);
    if (lane == t) my_s = part;
  }
  return (lane < n) ? my_s + ((t0 + lane < len) ? 0.f : NEG_BIG) : -INFINITY;
}

template <int DPL, int VPL, class Rows>
__global__ void __launch_bounds__(CA_WARPS * 32)
contiguous_attention_kernel(const float* __restrict__ q, const Rows rows,
                            const int32_t* __restrict__ lengths, float* __restrict__ out,
                            int S, int kv, int R, int hd, int hd_v, int block_kv, int c,
                            int g) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                                        // [CA_TILE][hd]
  float* Vs = Rows::kStream ? smem : smem + CA_TILE * hd;  // [CA_TILE][ldv]
  const int ldv = Rows::kStream ? hd : hd_v;
  __shared__ int maxlen_s;
  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.z * CA_WARPS + warp;
  const bool has_row = row < R;
  const int len = has_row ? lengths[(int64_t)b * c + row / g] : 0;

  if (threadIdx.x == 0) maxlen_s = 0;
  __syncthreads();
  if (lane == 0 && has_row && len > 0) atomicMax(&maxlen_s, len);
  __syncthreads();
  const int nkeys = min(maxlen_s, S);

  const int64_t qo = (((int64_t)b * kv + h) * R + row) * hd;
  const int64_t oo = (((int64_t)b * kv + h) * R + row) * hd_v;
  float qr[DPL], acc[VPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    qr[j] = (has_row && d < hd) ? q[qo + d] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = 0.f;
  float m = NEG_CLAMP, l = 0.f;

  for (int b0 = 0; b0 < nkeys; b0 += block_kv) {
    const int b1 = min(b0 + block_kv, nkeys);
    // pass 1: each row's max over the block's scores
    float bmax = -INFINITY;
    for (int t0 = b0; t0 < b1; t0 += CA_TILE) {
      const int n = min(CA_TILE, b1 - t0);
      __syncthreads();                   // previous sub-tile fully consumed
      rows.keys(Ks, b, t0, n, S, kv, h, hd);
      __syncthreads();
      if (has_row) bmax = fmaxf(bmax, tile_scores<DPL>(qr, Ks, n, hd, t0, len, lane));
    }
    const float m_new = fmaxf(fmaxf(m, warp_max(bmax)), NEG_CLAMP);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] *= corr;
    // pass 2: p at the block's max, bf16(p) * v into the accumulator
    for (int t0 = b0; t0 < b1; t0 += CA_TILE) {
      const int n = min(CA_TILE, b1 - t0);
      __syncthreads();
      rows.keys(Ks, b, t0, n, S, kv, h, hd);
      rows.values(Vs, b, t0, n, S, kv, h, hd_v);
      __syncthreads();
      if (has_row) {                     // warp-uniform
        const float s = tile_scores<DPL>(qr, Ks, n, hd, t0, len, lane);
        const float p = (lane < n) ? expf(s - m_new) : 0.f;
        l += warp_sum(p);
        const float pv = __bfloat162float(__float2bfloat16(p));   // pv_dtype = bf16
        for (int t = 0; t < n; ++t) {
          const float pt = __shfl_sync(0xffffffffu, pv, t);
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const int d = lane + 32 * j;
            if (d < hd_v) acc[j] = fmaf(pt, Vs[t * ldv + d], acc[j]);
          }
        }
      }
    }
    m = m_new;
  }
  if (has_row) {
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd_v) out[oo + d] = acc[j] / den;
    }
  }
}

template <int DPL, int VPL, class Rows>
static int launch(const void* q, const Rows& rows, const void* lengths, void* out, int B,
                  int S, int kv, int R, int hd, int hd_v, int block_kv, int c, int g,
                  void* stream) {
  if (hd > 32 * DPL || hd_v > 32 * VPL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * CA_TILE * (hd + (Rows::kStream ? 0 : hd_v));
  auto kernel = contiguous_attention_kernel<DPL, VPL, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, kv, (R + CA_WARPS - 1) / CA_WARPS);
  kernel<<<grid, CA_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, rows, (const int32_t*)lengths, (float*)out, S, kv, R, hd, hd_v,
      block_kv, c, g);
  return (int)cudaGetLastError();
}

static bool vec16(const void* p, int W) {
  return (W & 7) == 0 && ((uintptr_t)p & 15) == 0;
}

static int check_args(int B, int S, int kv, int R, int hd, int hd_v, int block_kv, int c,
                      int g) {
  if (B < 0 || S < 1 || kv < 1 || R < 0 || hd < 1 || hd_v < 1 || block_kv < 1 || c < 1 ||
      g < 1 || R != c * g)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

extern "C" int contiguous_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int B, int S, int kv,
                                    int R, int hd, int hd_v, int block_kv, int c, int g,
                                    void* stream) {
  const int bad = check_args(B, S, kv, R, hd, hd_v, block_kv, c, g);
  if (bad) return bad;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  PairRows rows{(const __nv_bfloat16*)k, (const __nv_bfloat16*)v, vec16(k, hd),
                vec16(v, hd_v)};
  // hd and hd_v up to 128, the widest GQA head a served config has; wider
  // heads get cudaErrorInvalidValue from launch()
  return launch<4, 4>(q, rows, lengths, out, B, S, kv, R, hd, hd_v, block_kv, c, g, stream);
}

extern "C" int contiguous_attention_mla(const void* q, const void* cache, const void* lengths,
                                        void* out, int B, int S, int kv, int R, int hd,
                                        int hd_v, int block_kv, int c, int g, void* stream) {
  const int bad = check_args(B, S, kv, R, hd, hd_v, block_kv, c, g);
  if (bad || hd_v > hd) return bad ? bad : (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  StreamRows rows{(const __nv_bfloat16*)cache, vec16(cache, hd)};
  return launch<9, 8>(q, rows, lengths, out, B, S, kv, R, hd, hd_v, block_kv, c, g, stream);
}
