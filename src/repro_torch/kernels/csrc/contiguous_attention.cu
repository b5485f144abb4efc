// K4 and K5: flash-decode over a contiguous cache, one online-softmax
// contract (the TPU template's) behind two kernels.
//
// Replaces src/repro/kernels/attention_template.py: fused_contiguous_attention
// (online_softmax_step, row_lengths, launched through _launch -> pallas_call)
// with
//   K4: the _load_pair hook, pv_dtype = the cache's bf16: a GQA cache of
//       separate K and V [B, S, kv, hd] (the JAX engine's default cache);
//   K5: the _make_load_stream(hd_v) hook: one absorbed-MLA stream
//       [B, S, kv, hd] whose values are its first hd_v columns.
//
// The contract both keep: the keys are walked in the reference's blocks of
// block_kv keys (kernels/tuning.reference_block_kv); per block the running
// max is m_new = max(m, block max of the masked scores, -1e30), p =
// exp(s - m_new) (l sums p unrounded), and bf16(p) * v is added to the
// accumulator, rescaled by exp(m - m_new) at block boundaries. Scores get an
// additive -2e30 mask past a row's length, so masked keys give exp(...) == 0
// exactly and a row of length 0 ends as exact zeros; the output is
// acc / max(l, 1e-20). Ragged chunks arrive folded: row r of the [R = c*g]
// query block belongs to query r / g (chunk-major), whose valid key count is
// lengths[b*c + r/g]. Keys past every row's length contribute exact zeros,
// so a (slot, head, row tile) stops after the last key any of its rows sees.
//
// K4 (`contiguous_attention`, the kernel below `k4_kernel`). Bound: at decode
// each key and value byte feeds 2 * rows operations, so the bytes bound it;
// the old one-warp-per-row walk was bound by latency and occupancy instead
// (32 CTAs on 132 SMs, serial shuffle reductions, every block read twice).
// Design:
//  * A thread-block cluster of up to 8 CTAs per (slot b, kv head h, tile of
//    16 folded rows) splits the visible keys of every block into contiguous
//    shares of whole 32-key tiles (kernels/tuning.attention_shares; the
//    cluster size from tuning.plan_contiguous_attention): 8 slots x 4 kv
//    heads at decode run 256 CTAs, not 32.
//  * Each CTA computes its share's scores once, on the tensor cores: q
//    arrives unrounded in f32 and is split into three bf16 parts (hi + mid +
//    lo, exact to f32's 24 bits), each multiplied by the bf16 keys with
//    mma.sync m16n8k16 and f32 accumulation, and the scores stay in shared
//    memory. The CTAs exchange their per-row block maxima through
//    distributed shared memory (one cluster barrier per block), so every
//    CTA forms p at the plain walk's m_new: the split changes only the f32
//    order of the sums.
//  * p is rounded to bf16 and bf16(p) . bf16(v) runs on the tensor cores
//    (exact products, f32 sums; 16 rows of A, padded past R).
//  * K and V arrive as bf16 in a ring of 8 tiles of 32 keys with 16-byte
//    cp.async (plain loads at odd widths), never widened in shared memory,
//    and are consumed two tiles a step (one barrier pair per 64 keys); each
//    key and value of a share is read once per row tile. q's f32 loads are
//    issued before the lengths' barrier, so the two latencies overlap.
//  * After the last block the CTAs' (l, acc) meet in distributed shared
//    memory; each rank finishes a share of the 16 x hd_v outputs, summing
//    the ranks' partials in rank order (deterministic, one launch).
//  * When a share's scores do not fit in shared memory (16 rows x more than
//    1024 keys of one block: a long block_kv with few CTAs; no served shape)
//    the first pass keeps only the max and the second recomputes the scores
//    of each step's two tiles before forming p, as the old walk did.
//
// K5 (`contiguous_attention_mla`, `contiguous_attention_kernel` with the
// StreamRows hook) keeps its first design: per (slot b, kv head h, tile of 8
// folded query rows), one warp per row, each lane holding hd/32 dims of q and
// hd_v/32 of the accumulator; a block is read twice, in sub-tiles of 32 keys
// widened exactly to f32 in shared memory (16-byte loads): pass 1 takes each
// row's max, pass 2 recomputes the scores and adds bf16(p) * v. V is the
// first hd_v columns of the K sub-tile already in shared memory. Its bound is
// the operations, 2 * (hd + hd_v) per row and key (40 heads share one
// stream). Known weak spots: the scores of a block are computed twice,
// every row tile re-reads the keys, and the shuffle reductions per key are
// serial (wgmma for the 40 heads sharing one stream is later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// K4: clustered split of every key block, scores once, tensor cores
// ---------------------------------------------------------------------------
#define K4_ROWS 16            // folded query rows per CTA: one m16 tile
#define K4_TK 32              // keys per ring tile: one n8 tile per warp
#define K4_WARPS 4
#define K4_HDP 128            // widest head dims (K4 refuses wider)
#define K4_LDK (K4_HDP + 8)   // bf16 per smem key row: 272 B, conflict-free fragments
#define K4_LDP (2 * K4_TK + 8)   // bf16 per smem p row: two tiles a step
#define K4_LDO (K4_HDP + 4)   // f32 per smem output row
#define K4_NS 8               // ring slots of one 32-key K or V tile

// wait until at most n of the committed groups are pending (0 <= n < K4_NS)
__device__ __forceinline__ void k4_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void k4_ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t k4_pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// x = hi + mid + lo, each bf16 (exact to f32's 24 significant bits)
__device__ __forceinline__ void k4_split(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

// Rows t0 .. t0+31 (those < t_end; zeros past it) of head h of slot b of a
// [B, S, kv, W] bf16 cache -> dst[key][K4_LDK], zeros past W: dims
// [0, K4_HDP) with 16-byte cp.async when ``vec``, [0, Wp) with plain loads
// otherwise.
__device__ __forceinline__ void k4_load_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ src, int b,
                                             int t0, int t_end, int S, int kv, int h, int W,
                                             int Wp, bool vec) {
  if (vec) {                         // every row's K4_HDP dims, zeros past W
    // thread: dims d .. d+7 of rows r0, r0 + 8, r0 + 16, r0 + 24
    constexpr int CPR = K4_HDP / 8, RSTEP = K4_WARPS * 32 / CPR;
    const int r0 = threadIdx.x / CPR, d = (threadIdx.x % CPR) * 8;
    const int64_t row = (int64_t)kv * W;
    const __nv_bfloat16* p = src + (((int64_t)b * S + t0 + r0) * kv + h) * W + d;
#pragma unroll
    for (int u = 0; u < K4_TK / RSTEP; ++u) {
      const bool ok = (t0 + r0 + RSTEP * u < t_end) && (d < W);
      cp_async16(dst + (r0 + RSTEP * u) * K4_LDK + d, ok ? p + RSTEP * u * row : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < K4_TK * Wp; i += K4_WARPS * 32) {
      const int r = i / Wp, d = i - r * Wp;
      dst[r * K4_LDK + d] = (t0 + r < t_end && d < W)
                                ? src[(((int64_t)b * S + t0 + r) * kv + h) * W + d]
                                : __float2bfloat16_rn(0.f);
    }
  }
}

__global__ void __launch_bounds__(K4_WARPS * 32)
k4_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
          const __nv_bfloat16* __restrict__ vc, const int32_t* __restrict__ lengths,
          float* __restrict__ out, int S, int kv, int R, int hd, int hd_v, int block_kv,
          int c, int g, int score_keys, int two_pass, int kvec, int vvec) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  const int lds = score_keys + 4;                                   // f32 per score row
  float* Ssm = reinterpret_cast<float*>(k4_smem);                   // [16][lds]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(k4_smem + K4_ROWS * lds * 4);
  __nv_bfloat16* Psm = ring + K4_NS * K4_TK * K4_LDK;               // [16][K4_LDP]
  float* small = reinterpret_cast<float*>(Psm + K4_ROWS * K4_LDP);
  float* mrow = small;              // [16] running max
  float* corr = small + 16;         // [16] exp(m - m_new) of this block
  float* cmax = small + 32;         // [2][16] this CTA's block maxima, by block parity
  float* wmax = small + 64;         // [4][16] per warp
  float* lsum = small + 128;        // [16] this CTA's l
  int* lens = reinterpret_cast<int*>(small + 144);   // [16]
  float* Osm = reinterpret_cast<float*>(ring);       // [16][K4_LDO] after the walk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (blockIdx.x / CL) * K4_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;

  // q's A fragments (rows gq, gq+8): the f32 loads are issued before the
  // lengths' barrier so their latencies overlap
  const int nks = (hd + 15) >> 4;
  float qraw[K4_HDP / 16][4][2];
  {
    const float* qb = q + (((int64_t)b * kv + h) * R) * hd;
#pragma unroll
    for (int ks = 0; ks < K4_HDP / 16; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {      // a0a1, a2a3, a4a5, a6a7
        const int row = row0 + gq + ((e & 1) ? 8 : 0);
        const int d = 16 * ks + 2 * t + ((e & 2) ? 8 : 0);
        qraw[ks][e][0] = (row < R && d < hd) ? qb[(int64_t)row * hd + d] : 0.f;
        qraw[ks][e][1] = (row < R && d + 1 < hd) ? qb[(int64_t)row * hd + d + 1] : 0.f;
      }
    }
  }
  if (tid < K4_ROWS) {
    const int row = row0 + tid;
    lens[tid] = row < R ? lengths[(int64_t)b * c + row / g] : 0;
    mrow[tid] = NEG_CLAMP;
  }
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int i = 0; i < K4_ROWS; ++i) maxlen = max(maxlen, lens[i]);
  const int nkeys = min(maxlen, S);
  const int len_a = lens[gq], len_b = lens[gq + 8];        // the thread's score rows
  // three bf16 parts per k-step
  uint32_t qa[3][K4_HDP / 16][4];
#pragma unroll
  for (int ks = 0; ks < K4_HDP / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat16 p0[3], p1[3];
      k4_split(qraw[ks][e][0], p0);
      k4_split(qraw[ks][e][1], p1);
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) qa[pp][ks][e] = k4_pack(p0[pp], p1[pp]);
    }
  }

  const int wk = 16 * nks;                          // key dims loaded (zeros past hd)
  const int wv = min(K4_HDP, ((hd_v + 31) >> 5) << 5);   // value dims loaded
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float lpart = 0.f;                                // row tid / 8, keys of this thread
  const int prow = tid >> 3, pk = (tid & 7) * 8;

  int blk = 0;
  for (int b0 = 0; b0 < nkeys; b0 += block_kv, ++blk) {
    const int b1 = min(b0 + block_kv, nkeys);
    const int sh = ((b1 - b0 + CL - 1) / CL + K4_TK - 1) / K4_TK * K4_TK;
    const int lo = min(b0 + rank * sh, b1), hi = min(lo + sh, b1);
    const int ntile = (hi - lo + K4_TK - 1) / K4_TK;
    // the block's loads, one 32-key tile each, in the order they are used:
    // items 0 .. ntile-1 are the K tiles of pass 1; then per tile j the V
    // tile (fit) or the K and V tiles (two_pass). Item i sits in ring slot
    // i % K4_NS; up to K4_NS items are in flight or in use.
    const int per2 = two_pass ? 2 : 1;
    const int total = ntile * (1 + per2);
    int issued = 0;
    auto tile = [&](int item) { return ring + (item % K4_NS) * K4_TK * K4_LDK; };
    // make items [.., u1] resident, after issuing up to u0 + K4_NS - 1
    // (items below u0 are no longer read: every step starts at a barrier)
    auto acquire = [&](int u0, int u1) {
      __syncthreads();
      for (; issued < min(total, u0 + K4_NS); ++issued) {
        const int item = issued;
        if (item < ntile) {
          k4_load_tile(tile(item), kc, b, lo + item * K4_TK, hi, S, kv, h, hd, wk, kvec);
        } else {
          const int j = (item - ntile) / per2;
          if (two_pass && (item - ntile) % 2 == 0)
            k4_load_tile(tile(item), kc, b, lo + j * K4_TK, hi, S, kv, h, hd, wk, kvec);
          else
            k4_load_tile(tile(item), vc, b, lo + j * K4_TK, hi, S, kv, h, hd_v, wv, vvec);
        }
        cp_async_commit();
      }
      k4_wait_pending(issued - 1 - u1);
      __syncthreads();
    };
    // scores of the tile's 32 keys (warp w: keys 8w .. 8w+7) -> running
    // maxima; stored at Ssm[row][off + key] when ``store``
    float mx_a = -INFINITY, mx_b = -INFINITY;
    auto scores = [&](const __nv_bfloat16* Kt, int t0, int off, bool store) {
      // six independent accumulators (q part x k-step parity), so the mma
      // chains stay short; summed in a fixed order
      float sp[6][4];
#pragma unroll
      for (int u = 0; u < 6; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[u][e] = 0.f;
      const __nv_bfloat16* kr = Kt + (8 * warp + gq) * K4_LDK + 2 * t;
#pragma unroll
      for (int ks = 0; ks < K4_HDP / 16; ++ks) {
        if (ks < nks) {
          const uint32_t b0r = *reinterpret_cast<const uint32_t*>(kr + 16 * ks);
          const uint32_t b1r = *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8);
#pragma unroll
          for (int pp = 0; pp < 3; ++pp) mma_bf16(sp[2 * pp + (ks & 1)], qa[pp][ks], b0r, b1r);
        }
      }
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = ((sp[4][e] + sp[5][e]) + (sp[2][e] + sp[3][e])) + (sp[0][e] + sp[1][e]);
      const int key = t0 + 8 * warp + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = key + (e & 1);
        const int len = (e & 2) ? len_b : len_a;
        s[e] = kk >= hi ? -INFINITY : s[e] + (kk < len ? 0.f : NEG_BIG);
      }
      mx_a = fmaxf(mx_a, fmaxf(s[0], s[1]));
      mx_b = fmaxf(mx_b, fmaxf(s[2], s[3]));
      if (store) {
        const int col = off + 8 * warp + 2 * t;
        *reinterpret_cast<float2*>(Ssm + gq * lds + col) = make_float2(s[0], s[1]);
        *reinterpret_cast<float2*>(Ssm + (gq + 8) * lds + col) = make_float2(s[2], s[3]);
      }
    };

    // pass 1, two tiles a step: the share's scores (kept unless two_pass)
    // and their maxima
    for (int i = 0; i < ntile; i += 2) {
      acquire(i, min(i + 1, ntile - 1));
      scores(tile(i), lo + i * K4_TK, i * K4_TK, !two_pass);
      if (i + 1 < ntile) scores(tile(i + 1), lo + (i + 1) * K4_TK, (i + 1) * K4_TK, !two_pass);
    }
    // the cluster's block max: every CTA forms p at the plain walk's m_new
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    if (t == 0) {
      wmax[warp * 16 + gq] = mx_a;
      wmax[warp * 16 + gq + 8] = mx_b;
    }
    __syncthreads();
    float* cm = cmax + (blk & 1) * 16;
    if (tid < K4_ROWS) {
      float m = wmax[tid];
#pragma unroll
      for (int w = 1; w < K4_WARPS; ++w) m = fmaxf(m, wmax[w * 16 + tid]);
      cm[tid] = m;
    }
    cluster.sync();
    if (tid < K4_ROWS) {
      float m = mrow[tid];
      for (int r = 0; r < CL; ++r) m = fmaxf(m, cluster.map_shared_rank(cm, r)[tid]);
      m = fmaxf(m, NEG_CLAMP);
      corr[tid] = expf(mrow[tid] - m);
      mrow[tid] = m;
    }
    __syncthreads();
    {
      const float ca = corr[gq], cb = corr[gq + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] *= ca;
        acc[i][1] *= ca;
        acc[i][2] *= cb;
        acc[i][3] *= cb;
      }
      lpart *= corr[prow];
    }
    const float mnew = mrow[prow];
    // pass 2, two tiles a step: p = exp(s - m_new), l += p, acc += bf16(p) . v
    for (int j = 0; j < ntile; j += 2) {
      const int nt2 = min(2, ntile - j);
      const int u0 = ntile + per2 * j, u1 = u0 + per2 * nt2 - 1;
      acquire(u0, u1);
      if (two_pass) {
        scores(tile(u0), lo + j * K4_TK, 0, true);
        if (nt2 > 1) scores(tile(u0 + 2), lo + (j + 1) * K4_TK, K4_TK, true);
        __syncthreads();
      }
      {
        __nv_bfloat16 pb[8];
        if (pk < nt2 * K4_TK) {
          const float* sr = Ssm + prow * lds + (two_pass ? 0 : j * K4_TK) + pk;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float p = expf(sr[e] - mnew);
            lpart += p;
            pb[e] = __float2bfloat16_rn(p);              // pv_dtype = bf16
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) pb[e] = __float2bfloat16_rn(0.f);
        }
        uint4 w4;
        w4.x = k4_pack(pb[0], pb[1]);
        w4.y = k4_pack(pb[2], pb[3]);
        w4.z = k4_pack(pb[4], pb[5]);
        w4.w = k4_pack(pb[6], pb[7]);
        *reinterpret_cast<uint4*>(Psm + prow * K4_LDP + pk) = w4;
      }
      __syncthreads();
      const int d0 = 32 * warp;
      if (d0 < hd_v) {
        const int mi = lane >> 3, r = lane & 7;
#pragma unroll
        for (int kk = 0; kk < 2 * K4_TK / 16; ++kk) {
          if (kk < nt2 * (K4_TK / 16)) {
            // V rows 16 kk .. 16 kk + 15 of the step: tile kk / 2 of it
            const __nv_bfloat16* Vt = tile(u0 + per2 * (kk >> 1) + per2 - 1) +
                                      ((kk & 1) * 16) * K4_LDK;
            uint32_t a[4];
            const __nv_bfloat16* pr = Psm + gq * K4_LDP + 16 * kk + 2 * t;
            a[0] = *reinterpret_cast<const uint32_t*>(pr);
            a[1] = *reinterpret_cast<const uint32_t*>(pr + 8 * K4_LDP);
            a[2] = *reinterpret_cast<const uint32_t*>(pr + 8);
            a[3] = *reinterpret_cast<const uint32_t*>(pr + 8 * K4_LDP + 8);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t bv[4];
              k4_ldmatrix_x4_trans(
                  bv, Vt + ((mi & 1) * 8 + r) * K4_LDK + d0 + 16 * np + (mi >> 1) * 8);
              mma_bf16(acc[2 * np], a, bv[0], bv[1]);
              mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
            }
          }
        }
      }
    }
    __syncthreads();                  // the ring and P are free for the next block
  }

  // this CTA's (l, acc) -> shared memory; the ranks' partials summed in rank
  // order by the rank that finishes each output
#pragma unroll
  for (int o = 1; o <= 4; o <<= 1) lpart += __shfl_xor_sync(0xffffffffu, lpart, o);
  if ((tid & 7) == 0) lsum[prow] = lpart;
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: reuse it for acc
  {
    const int d0 = 32 * warp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + 8 * i + 2 * t;
      *reinterpret_cast<float2*>(Osm + gq * K4_LDO + d) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(Osm + (gq + 8) * K4_LDO + d) =
          make_float2(acc[i][2], acc[i][3]);
    }
  }
  cluster.sync();
  // rank q finishes every CL-th run of 128 (row, 4 dims) cells: the ranks'
  // partials loaded first, then summed in rank order
  const int nrow = min(K4_ROWS, R - row0);
  const int dq = (hd_v + 3) >> 2;
  for (int e = tid + rank * K4_WARPS * 32; e < nrow * dq; e += CL * K4_WARPS * 32) {
    const int r = e / dq, d = (e - r * dq) * 4;
    float4 part[8];
    float lp[8];
#pragma unroll
    for (int q2 = 0; q2 < 8; ++q2) {
      if (q2 < CL) {
        part[q2] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(Osm, q2) +
                                                     r * K4_LDO + d);
        lp[q2] = cluster.map_shared_rank(lsum, q2)[r];
      }
    }
    float4 s = part[0];
    float l = lp[0];
#pragma unroll
    for (int q2 = 1; q2 < 8; ++q2) {
      if (q2 < CL) {
        s.x += part[q2].x;
        s.y += part[q2].y;
        s.z += part[q2].z;
        s.w += part[q2].w;
        l += lp[q2];
      }
    }
    const float den = fmaxf(l, 1e-20f);
    const float sv[4] = {s.x, s.y, s.z, s.w};
    float* o = out + (((int64_t)b * kv + h) * R + row0 + r) * hd_v;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < hd_v) o[d + i] = sv[i] / den;
  }
  cluster.sync();                     // no CTA leaves while its partials are read
}

static size_t k4_smem_bytes(int score_keys) {
  return (size_t)K4_ROWS * (score_keys + 4) * 4 + K4_NS * K4_TK * K4_LDK * 2 +
         K4_ROWS * K4_LDP * 2 + 160 * 4;
}

static int k4_launch(const void* q, const void* k, const void* v, const void* lengths,
                     void* out, int B, int S, int kv, int R, int hd, int hd_v, int block_kv,
                     int c, int g, int cluster, int score_keys, int two_pass, void* stream) {
  const int share = ((block_kv + cluster - 1) / cluster + K4_TK - 1) / K4_TK * K4_TK;
  if (hd > K4_HDP || hd_v > K4_HDP || cluster < 1 || cluster > 8 || score_keys % K4_TK ||
      score_keys < (two_pass ? 2 * K4_TK : share))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k4_smem_bytes(score_keys);
  static size_t allowed = 48 * 1024;     // the kernel's dynamic shared-memory limit so far
  if (smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(k4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((R + K4_ROWS - 1) / K4_ROWS), kv, B);
  cfg.blockDim = dim3(K4_WARPS * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, k4_kernel, (const float*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)lengths, (float*)out, S, kv, R, hd, hd_v, block_kv, c, g, score_keys,
      two_pass, (int)vec16(k, hd), (int)vec16(v, hd_v));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan (cluster, score_keys, two_pass) comes from
// kernels/tuning.plan_contiguous_attention; hd and hd_v up to 128, the widest
// GQA head a served config has (wider heads get cudaErrorInvalidValue).
extern "C" int contiguous_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int B, int S, int kv,
                                    int R, int hd, int hd_v, int block_kv, int c, int g,
                                    int cluster, int score_keys, int two_pass, void* stream) {
  const int bad = check_args(B, S, kv, R, hd, hd_v, block_kv, c, g);
  if (bad) return bad;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  return k4_launch(q, k, v, lengths, out, B, S, kv, R, hd, hd_v, block_kv, c, g, cluster,
                   score_keys, two_pass, stream);
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
