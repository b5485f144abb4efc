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
//    16 folded rows) splits every block into contiguous shares of whole
//    32-key tiles (kernels/tuning.attention_shares of the whole block, each
//    cut at the last key a row of the tile sees; the cluster size from
//    tuning.plan_contiguous_attention, a function of the block alone): 8
//    slots x 4 kv heads at decode run 256 CTAs, not 32. A row's keys are
//    then split and merged in an order set by the block and the cluster, so
//    a row gets the same bits whatever other rows and slots the call holds
//    (keys past a row's length add exact zeros; a block past it leaves its
//    max, so its rescale is 1).
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
// K5 (`contiguous_attention_mla`, `k5_kernel`): K4's design widened to the
// absorbed-MLA stream. MiniCPM3-4B puts 40 heads on one stream of 256 + 32
// columns whose values are its first 256, so each key feeds 40 rows x
// 2 * (288 + 256) operations at decode: the operations bound it, and the
// first design (one warp per row, 5 row tiles of 8 per slot, every key read
// twice per tile and widened to f32, serial shuffle sums) reached 1/236 of
// that bound. Design:
//  * One CTA holds 48 folded rows (three m16 tiles: all 40 heads of a slot
//    at decode), so each 32-key tile is loaded once (16-byte cp.async,
//    bf16, never widened) and serves every head; chunks of 16 queries (640
//    rows) take 14 row groups.
//  * A cluster of up to 8 CTAs (the portable size; the plan in
//    kernels/tuning.plan_mla_attention) splits each key block as K4's
//    does: 8 slots at decode run 64 CTAs, not 40 one-warp-per-row blocks.
//    A share of up to 128 keys stays resident in a 4-tile ring from the
//    scores to the p.v product (one read of every key per block); longer
//    shares stream through the ring twice and recompute their scores.
//  * q arrives unrounded in f32 and sits in shared memory as three bf16
//    parts (85 KB); scores are computed once on the tensor cores (mma.sync
//    m16n8k16, each warp 16 keys x 48 rows per step of 64 keys, 18 k-steps
//    of 16 at hd 288) and kept in shared memory; the block max is shared
//    through DSMEM, so p is rounded to bf16 at the plain walk's m_new.
//  * bf16(p) . v runs on the tensor cores with v = columns 0 .. hd_v - 1 of
//    the key tiles already in shared memory (ldmatrix.trans), each warp
//    holding a 64-column band of the 48 x 256 f32 accumulator in registers.
//  * The ranks' (l, acc) meet in distributed shared memory and are summed
//    in rank order (deterministic, one launch).
//  * 195 KB of shared memory: one CTA per SM.
// Known weak spots: at the served block of 512 keys a rank holds 32-64 keys,
// so its fixed costs (the q split, the max exchange, the combine) dominate;
// chunks of 16 run 896 CTAs in 6.8 waves of one per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace cg = cooperative_groups;

#define NEG_BIG (-2e30f)
#define NEG_CLAMP (-1e30f)

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
      split_bf16x3(qraw[ks][e][0], p0);
      split_bf16x3(qraw[ks][e][1], p1);
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) qa[pp][ks][e] = pack_bf16x2(p0[pp], p1[pp]);
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
    // the rank's share of the whole block [b0, min(b0 + block_kv, S)), cut
    // at the keys this tile's rows can see: a row's split follows the block
    // and the cluster alone, never the other rows of the tile
    const int b1 = min(b0 + block_kv, S);
    const int sh = ((b1 - b0 + CL - 1) / CL + K4_TK - 1) / K4_TK * K4_TK;
    const int hi = min(min(b0 + (rank + 1) * sh, b1), nkeys);
    const int lo = min(b0 + rank * sh, hi);
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
      cp_async_wait_pending(issued - 1 - u1);
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
        w4.x = pack_bf16x2(pb[0], pb[1]);
        w4.y = pack_bf16x2(pb[2], pb[3]);
        w4.z = pack_bf16x2(pb[4], pb[5]);
        w4.w = pack_bf16x2(pb[6], pb[7]);
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
              ldmatrix_x4_trans(
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

// ---------------------------------------------------------------------------
// K5: the absorbed-MLA stream, K4's design widened to one 288-wide stream
// ---------------------------------------------------------------------------
#define K5_MT 3                     // m16 row tiles per CTA
#define K5_ROWS (16 * K5_MT)        // folded query rows per CTA (40 heads at decode)
#define K5_WARPS 4
#define K5_TK 32                    // keys per ring tile
#define K5_HDP 288                  // widest stream (MiniCPM3-4B: 256 + 32)
#define K5_HVP 256                  // widest value slice
#define K5_LDK (K5_HDP + 8)         // bf16 per smem key or q row: 592 B, conflict-free ldmatrix
#define K5_NS 4                     // ring slots: a share of up to 128 keys stays resident
#define K5_LDS (K5_NS * K5_TK + 4)  // f32 per score row
#define K5_LDP (2 * K5_TK + 8)      // bf16 per p row: two tiles a step
#define K5_LDO (K5_HVP + 4)         // f32 per output row
#define K5_MAX_CLUSTER 8            // the portable cluster size
#define K5_QB 9                     // q loads in flight per thread

// Rows t0 .. t0+31 (those < t_end; zeros past it) of head h of slot b of a
// [B, S, kv, W] bf16 stream -> dst[key][K5_LDK], zeros past W: all K5_HDP
// dims with 16-byte cp.async when ``vec``, [0, Wp) with plain loads
// otherwise.
__device__ __forceinline__ void k5_load_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ src, int b,
                                             int t0, int t_end, int S, int kv, int h, int W,
                                             int Wp, bool vec) {
  if (vec) {
    constexpr int CPR = K5_HDP / 8;              // 16-byte chunks per row
    for (int i = threadIdx.x; i < K5_TK * CPR; i += K5_WARPS * 32) {
      const int r = i / CPR, d = (i - r * CPR) * 8;
      const bool ok = (t0 + r < t_end) && (d < W);
      cp_async16(dst + r * K5_LDK + d,
                 ok ? src + (((int64_t)b * S + t0 + r) * kv + h) * W + d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < K5_TK * Wp; i += K5_WARPS * 32) {
      const int r = i / Wp, d = i - r * Wp;
      dst[r * K5_LDK + d] = (t0 + r < t_end && d < W)
                                ? src[(((int64_t)b * S + t0 + r) * kv + h) * W + d]
                                : __float2bfloat16_rn(0.f);
    }
  }
}

__global__ void __launch_bounds__(K5_WARPS * 32, 1)
k5_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
          const int32_t* __restrict__ lengths, float* __restrict__ out, int S, int kv, int R,
          int hd, int hd_v, int block_kv, int c, int g, int kvec, int qvec) {
  extern __shared__ __align__(16) unsigned char k5_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(k5_smem);    // [3][48][K5_LDK]
  __nv_bfloat16* ring = qs + 3 * K5_ROWS * K5_LDK;                  // [NS][32][K5_LDK]
  float* Ssm = reinterpret_cast<float*>(ring + K5_NS * K5_TK * K5_LDK);   // [48][K5_LDS]
  __nv_bfloat16* Psm = reinterpret_cast<__nv_bfloat16*>(Ssm + K5_ROWS * K5_LDS);  // [48][LDP]
  float* small = reinterpret_cast<float*>(Psm + K5_ROWS * K5_LDP);
  float* mrow = small;                     // [48] running max
  float* corr = small + K5_ROWS;           // [48] exp(m - m_new) of this block
  float* cmax = small + 2 * K5_ROWS;       // [2][48] this CTA's block maxima, by block parity
  float* wmax = small + 4 * K5_ROWS;       // [4][48] per warp
  float* lsum = small + 8 * K5_ROWS;       // [48] this CTA's l
  int* lens = reinterpret_cast<int*>(small + 9 * K5_ROWS);   // [48]
  float* Osm = reinterpret_cast<float*>(ring);                // [48][K5_LDO] after the walk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (blockIdx.x / CL) * K5_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;

  if (tid < K5_ROWS) {
    const int row = row0 + tid;
    lens[tid] = row < R ? lengths[(int64_t)b * c + row / g] : 0;
    mrow[tid] = NEG_CLAMP;
  }
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int i = 0; i < K5_ROWS; ++i) maxlen = max(maxlen, lens[i]);
  const int nkeys = min(maxlen, S);
  const int nks = (hd + 15) >> 4;
  const int wk = 16 * nks;                   // key dims loaded (zeros past hd)

  // the current block: this rank's keys [lo, hi) in ntile tiles, its load
  // items (resident: the share's tiles, loaded once and serving both
  // passes; else pass 2 loads them again, items ntile .. 2 ntile - 1) and
  // how many are issued; item i sits in ring slot i % K5_NS
  int lo = 0, hi = 0, ntile = 0, total = 0, issued = 0;
  auto plan_block = [&](int b0) {
    // the rank's share of the whole block, cut at the tile's keys (as K4)
    const int b1 = min(b0 + block_kv, S);
    const int sh = ((b1 - b0 + CL - 1) / CL + K5_TK - 1) / K5_TK * K5_TK;
    hi = min(min(b0 + (rank + 1) * sh, b1), nkeys);
    lo = min(b0 + rank * sh, hi);
    ntile = (hi - lo + K5_TK - 1) / K5_TK;
    total = ntile <= K5_NS ? ntile : 2 * ntile;
    issued = 0;
  };
  auto tile = [&](int item) { return ring + (item % K5_NS) * (K5_TK * K5_LDK); };
  auto issue = [&](int upto) {               // items [issued, min(total, upto))
    for (; issued < min(total, upto); ++issued) {
      const int j = issued < ntile ? issued : issued - ntile;
      k5_load_tile(tile(issued), kc, b, lo + j * K5_TK, hi, S, kv, h, hd, wk, kvec);
      cp_async_commit();
    }
  };
  // the first block's tiles are in flight while q is split
  if (nkeys > 0) {
    plan_block(0);
    issue(K5_NS);
  }
  // q -> three bf16 parts (hi + mid + lo, exact to f32's 24 bits) in shared
  // memory, zeros past hd (up to whole k-steps) and past R; K5_QB loads in
  // flight per thread
  {
    const float* qb = q + ((int64_t)b * kv + h) * R * hd;
    const int per = qvec ? 4 : 1;                   // f32 per load
    const int nq = wk / per;                        // loads per row
    const int nitems = K5_ROWS * nq;
    for (int e0 = tid; e0 < nitems; e0 += K5_QB * K5_WARPS * 32) {
      float4 xv[K5_QB];
#pragma unroll
      for (int u = 0; u < K5_QB; ++u) {
        const int e = e0 + u * K5_WARPS * 32;
        const int r = e / nq, d = (e - r * nq) * per;
        xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < nitems && row0 + r < R && d < hd) {
          const float* src = qb + (int64_t)(row0 + r) * hd + d;
          if (qvec)
            xv[u] = *reinterpret_cast<const float4*>(src);
          else
            xv[u].x = *src;
        }
      }
#pragma unroll
      for (int u = 0; u < K5_QB; ++u) {
        const int e = e0 + u * K5_WARPS * 32;
        if (e < nitems) {
          const int r = e / nq, d = (e - r * nq) * per;
          const float x[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i < per) {
              __nv_bfloat16 pq[3];
              split_bf16x3(x[i], pq);
#pragma unroll
              for (int pp = 0; pp < 3; ++pp) qs[(pp * K5_ROWS + r) * K5_LDK + d + i] = pq[pp];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  int len_r[2 * K5_MT];                      // the thread's score rows 16 mt + gq (+ 8)
#pragma unroll
  for (int j = 0; j < 2 * K5_MT; ++j) len_r[j] = lens[16 * (j >> 1) + gq + 8 * (j & 1)];

  // p . v accumulator: warp w holds value dims [64 w, 64 w + 64) of all 48 rows
  float acc[K5_MT][8][4];
#pragma unroll
  for (int mt = 0; mt < K5_MT; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float lpart[K5_MT] = {0.f, 0.f, 0.f};      // rows prow + 16 i, keys pk .. pk+7 of a step
  const int prow = tid >> 3, pk = (tid & 7) * 8;
  const int d0 = 64 * warp;

  int blk = 0;
  for (int b0 = 0; b0 < nkeys; b0 += block_kv, ++blk) {
    if (blk > 0) plan_block(b0);
    const bool resident = ntile <= K5_NS;
    auto acquire = [&](int u0, int u1) {
      __syncthreads();
      issue(u0 + K5_NS);
      cp_async_wait_pending(issued - 1 - u1);
      __syncthreads();
    };
    // scores of a step's nt2 tiles (warp w: keys 16 w .. 16 w + 15 of the
    // step, two n8 tiles) -> running maxima; stored at Ssm[row][soff + key]
    // when ``store``
    float mx[2 * K5_MT];
#pragma unroll
    for (int j = 0; j < 2 * K5_MT; ++j) mx[j] = -INFINITY;
    auto scores = [&](int key0, const __nv_bfloat16* TA, const __nv_bfloat16* TB, int nt2,
                      int soff, bool store) {
      if (16 * warp >= nt2 * K5_TK) return;                      // warp-uniform
      const __nv_bfloat16* kb = ((warp >> 1) ? TB : TA) +
                                (16 * (warp & 1) + (lane & 7) + 8 * (lane >> 4)) * K5_LDK +
                                8 * ((lane >> 3) & 1);
      const __nv_bfloat16* qa = qs + (lane & 15) * K5_LDK + 8 * (lane >> 4);
      // one accumulator per q part, summed in a fixed order
      float sp[3][K5_MT][2][4];
#pragma unroll
      for (int pp = 0; pp < 3; ++pp)
#pragma unroll
        for (int mt = 0; mt < K5_MT; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[pp][mt][n][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t bk[4];                      // b0, b1 of keys 0-7, then of keys 8-15
        ldmatrix_x4(bk, kb + 16 * ks);
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) {
#pragma unroll
          for (int mt = 0; mt < K5_MT; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, qa + (pp * K5_ROWS + 16 * mt) * K5_LDK + 16 * ks);
            mma_bf16(sp[pp][mt][0], a, bk[0], bk[1]);
            mma_bf16(sp[pp][mt][1], a, bk[2], bk[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < K5_MT; ++mt) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int kk = 16 * warp + 8 * n + 2 * t;               // key of the step
          float s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + kk + (e & 1);
            const int len = len_r[2 * mt + (e >> 1)];
            const float v = (sp[2][mt][n][e] + sp[1][mt][n][e]) + sp[0][mt][n][e];
            s[e] = key >= hi ? -INFINITY : v + (key < len ? 0.f : NEG_BIG);
          }
          mx[2 * mt] = fmaxf(mx[2 * mt], fmaxf(s[0], s[1]));
          mx[2 * mt + 1] = fmaxf(mx[2 * mt + 1], fmaxf(s[2], s[3]));
          if (store) {
            float* sr = Ssm + (16 * mt + gq) * K5_LDS + soff + kk;
            *reinterpret_cast<float2*>(sr) = make_float2(s[0], s[1]);
            *reinterpret_cast<float2*>(sr + 8 * K5_LDS) = make_float2(s[2], s[3]);
          }
        }
      }
    };

    // pass 1, two tiles a step: the share's scores (kept when resident) and
    // their maxima
    for (int i = 0; i < ntile; i += 2) {
      acquire(i, min(i + 1, ntile - 1));
      scores(lo + i * K5_TK, tile(i), tile(i + 1), min(2, ntile - i), i * K5_TK, resident);
    }
    // the cluster's block max: every CTA forms p at the plain walk's m_new
#pragma unroll
    for (int j = 0; j < 2 * K5_MT; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    }
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < 2 * K5_MT; ++j)
        wmax[warp * K5_ROWS + 16 * (j >> 1) + gq + 8 * (j & 1)] = mx[j];
    }
    __syncthreads();
    float* cm = cmax + (blk & 1) * K5_ROWS;
    if (tid < K5_ROWS) {
      float m = wmax[tid];
#pragma unroll
      for (int w = 1; w < K5_WARPS; ++w) m = fmaxf(m, wmax[w * K5_ROWS + tid]);
      cm[tid] = m;
    }
    cluster.sync();
    if (tid < K5_ROWS) {
      float m = mrow[tid];
      for (int r = 0; r < CL; ++r) m = fmaxf(m, cluster.map_shared_rank(cm, r)[tid]);
      m = fmaxf(m, NEG_CLAMP);
      corr[tid] = expf(mrow[tid] - m);
      mrow[tid] = m;
    }
    __syncthreads();
    float mnew[K5_MT];
#pragma unroll
    for (int mt = 0; mt < K5_MT; ++mt) {
      const float ca = corr[16 * mt + gq], cb = corr[16 * mt + gq + 8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[mt][n][0] *= ca;
        acc[mt][n][1] *= ca;
        acc[mt][n][2] *= cb;
        acc[mt][n][3] *= cb;
      }
      lpart[mt] *= corr[prow + 16 * mt];
      mnew[mt] = mrow[prow + 16 * mt];
    }
    // pass 2, two tiles a step: p = exp(s - m_new), l += p, acc += bf16(p) . v,
    // v being the first hd_v columns of the key tiles
    for (int j = 0; j < ntile; j += 2) {
      const int nt2 = min(2, ntile - j);
      int ia = j, soff = j * K5_TK;
      if (resident) {
        __syncthreads();                  // the previous step's p is consumed
      } else {
        ia = ntile + j;
        soff = 0;
        acquire(ia, ia + nt2 - 1);
        scores(lo + j * K5_TK, tile(ia), tile(ia + 1), nt2, 0, true);
        __syncthreads();
      }
#pragma unroll
      for (int mt = 0; mt < K5_MT; ++mt) {
        __nv_bfloat16 pb[8];
        if (pk < nt2 * K5_TK) {
          const float* sr = Ssm + (prow + 16 * mt) * K5_LDS + soff + pk;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float p = expf(sr[e] - mnew[mt]);
            lpart[mt] += p;
            pb[e] = __float2bfloat16_rn(p);              // pv_dtype = bf16
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) pb[e] = __float2bfloat16_rn(0.f);
        }
        uint4 w4;
        w4.x = pack_bf16x2(pb[0], pb[1]);
        w4.y = pack_bf16x2(pb[2], pb[3]);
        w4.z = pack_bf16x2(pb[4], pb[5]);
        w4.w = pack_bf16x2(pb[6], pb[7]);
        *reinterpret_cast<uint4*>(Psm + (prow + 16 * mt) * K5_LDP + pk) = w4;
      }
      __syncthreads();
      if (d0 < hd_v) {
        const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int kk = 0; kk < 2 * K5_TK / 16; ++kk) {
          if (kk < nt2 * (K5_TK / 16)) {
            // V rows 16 kk .. 16 kk + 15 of the step: tile kk / 2 of it
            const __nv_bfloat16* Vt = tile(ia + (kk >> 1)) + ((kk & 1) * 16) * K5_LDK;
            uint32_t a[K5_MT][4];
#pragma unroll
            for (int mt = 0; mt < K5_MT; ++mt)
              ldmatrix_x4(a[mt], Psm + (16 * mt + (lane & 15)) * K5_LDP + 16 * kk +
                                        8 * (lane >> 4));
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (d0 + 16 * np < hd_v) {
                uint32_t bv[4];
                ldmatrix_x4_trans(
                    bv, Vt + ((mi & 1) * 8 + r8) * K5_LDK + d0 + 16 * np + (mi >> 1) * 8);
#pragma unroll
                for (int mt = 0; mt < K5_MT; ++mt) {
                  mma_bf16(acc[mt][2 * np], a[mt], bv[0], bv[1]);
                  mma_bf16(acc[mt][2 * np + 1], a[mt], bv[2], bv[3]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();                  // the ring, scores and p are free for the next block
  }

  // this CTA's (l, acc) -> shared memory; the ranks' partials summed in rank
  // order by the rank that finishes each output
#pragma unroll
  for (int mt = 0; mt < K5_MT; ++mt) {
#pragma unroll
    for (int o = 1; o <= 4; o <<= 1) lpart[mt] += __shfl_xor_sync(0xffffffffu, lpart[mt], o);
  }
  if ((tid & 7) == 0) {
#pragma unroll
    for (int mt = 0; mt < K5_MT; ++mt) lsum[prow + 16 * mt] = lpart[mt];
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: reuse it for acc
  if (d0 < hd_v) {
#pragma unroll
    for (int mt = 0; mt < K5_MT; ++mt) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float* o = Osm + (16 * mt + gq) * K5_LDO + d0 + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[mt][n][0], acc[mt][n][1]);
        *reinterpret_cast<float2*>(o + 8 * K5_LDO) = make_float2(acc[mt][n][2], acc[mt][n][3]);
      }
    }
  }
  cluster.sync();
  // rank q finishes every CL-th run of 128 (row, 4 dims) cells: the ranks'
  // partials loaded first, then summed in rank order
  const int nrow = min(K5_ROWS, R - row0);
  const int dq = (hd_v + 3) >> 2;
  for (int e = tid + rank * K5_WARPS * 32; e < nrow * dq; e += CL * K5_WARPS * 32) {
    const int r = e / dq, d = (e - r * dq) * 4;
    float4 part[K5_MAX_CLUSTER];
    float lp[K5_MAX_CLUSTER];
#pragma unroll
    for (int q2 = 0; q2 < K5_MAX_CLUSTER; ++q2) {
      if (q2 < CL) {
        part[q2] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(Osm, q2) +
                                                     r * K5_LDO + d);
        lp[q2] = cluster.map_shared_rank(lsum, q2)[r];
      }
    }
    float4 s = part[0];
    float l = lp[0];
#pragma unroll
    for (int q2 = 1; q2 < K5_MAX_CLUSTER; ++q2) {
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

static size_t k5_smem_bytes() {
  return (size_t)3 * K5_ROWS * K5_LDK * 2 + (size_t)K5_NS * K5_TK * K5_LDK * 2 +
         (size_t)K5_ROWS * K5_LDS * 4 + (size_t)K5_ROWS * K5_LDP * 2 + 10 * K5_ROWS * 4;
}

static int k5_launch(const void* q, const void* k, const void* lengths, void* out, int B,
                     int S, int kv, int R, int hd, int hd_v, int block_kv, int c, int g,
                     int cluster, void* stream) {
  if (hd > K5_HDP || hd_v > K5_HVP || hd_v > hd || cluster < 1 || cluster > K5_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k5_smem_bytes();
  static bool ready = false;            // the kernel's attributes are set once
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(k5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((R + K5_ROWS - 1) / K5_ROWS), kv, B);
  cfg.blockDim = dim3(K5_WARPS * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int qvec = (hd & 3) == 0 && ((uintptr_t)q & 15) == 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, k5_kernel, (const float*)q, (const __nv_bfloat16*)k, (const int32_t*)lengths,
      (float*)out, S, kv, R, hd, hd_v, block_kv, c, g, (int)vec16(k, hd), qvec);
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

// The cluster comes from kernels/tuning.plan_mla_attention; hd up to 288 and
// hd_v up to 256 (MiniCPM3-4B's stream; wider gets cudaErrorInvalidValue).
extern "C" int contiguous_attention_mla(const void* q, const void* cache, const void* lengths,
                                        void* out, int B, int S, int kv, int R, int hd,
                                        int hd_v, int block_kv, int c, int g, int cluster,
                                        void* stream) {
  const int bad = check_args(B, S, kv, R, hd, hd_v, block_kv, c, g);
  if (bad) return bad;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  return k5_launch(q, cache, lengths, out, B, S, kv, R, hd, hd_v, block_kv, c, g, cluster,
                   stream);
}
