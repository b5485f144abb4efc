// K2, K3 and K5p: paged flash-decode over a page pool, one online-softmax
// contract (the TPU template's) behind two kernels.
//
// Replaces src/repro/kernels/attention_template.py: fused_paged_attention
// (online_softmax_step, row_lengths, launched through _launch ->
// pallas_call) with
//   K2:  the _make_load_ams hook (restore_page): packed AMS pages (e2m2 or
//        e2m1 codes);
//   K3:  the _load_pair hook with pv_dtype = the pool's bf16: bf16 pages;
//   K5p: the paged absorbed-MLA stream (value_slice): one stream pool whose
//        values are its first hd_v columns, on bf16 pages (_make_load_stream)
//        or on AMS pages (_make_load_ams with hd_v: only the K planes are
//        restored).
//
// The contract all three keep (the reference's online softmax): scores get
// an additive -2e30 mask past a row's length, the running max is clamped at
// -1e30, so masked scores give exp(...) == 0 exactly and a row of length 0
// ends as exact zeros; the output is acc / max(l, 1e-20). bf16 pages round
// p to bf16 at the running max, which advances once per page, before the
// PV product (l sums the unrounded p), as the template does with pv_dtype;
// AMS pages keep p in f32. Ragged chunks arrive folded: row r of the
// [R = c*g] query block belongs to query r / g (chunk-major), whose valid
// key count is lengths[b*c + r/g]. Keys past every row's length contribute
// exact zeros, so a block of rows stops after the last key any of them sees.
//
// K3 and K5p (`paged_attention_kernel`, one body behind a page-load hook).
// Per (slot b, kv head h) the block walks block_table[b, i], loads each
// page's K and V into shared memory as f32 (bf16 pages widened with 16-byte
// loads, which is exact; AMS stream pages restored to lattice values times
// scale; a stream page is loaded once and its first hd_v columns are the
// values). One warp per folded query row (8 rows per block); each lane
// holds hd/32 dims of q and hd_v/32 of the accumulator, compile-time per
// instantiation (4 / 4 up to 128 wide for K3, 9 / 8 up to 288 / 256 for
// K5p). A page of any size is walked in sub-tiles of at most 32 tokens
// (lane t scores token t of a sub-tile), in two passes over a page wider
// than 32: the first keeps the sub-tiles' scores (up to 256 tokens per warp
// in shared memory; past that they are recomputed) and forms the page's
// max, the second forms p at that max and adds the values, so bf16 pages
// round p where the plain walk does. Sub-tiles sit in dynamic shared memory
// as f32 rows at a compile-time stride (runtime strides made the kernels
// slower on the card), under the 48 KB a launch gets without opting in.
// Bound: K3 by device-memory bytes at decode; K5p, 40 heads on one stream,
// by its operations. Known weak spots: 8 slots x 4 kv heads fill 32 of
// the H100's 132 SMs at K3's decode (K2's split needs K4's max exchange
// here, because bf16 pages round p at the page max), and K5p's row tiles
// (5 per slot at decode, 80 at chunk 16) each reload, and on AMS pages
// re-restore, every page, with scalar FMAs.
//
// K2 (`paged_attention_ams`, `k2_kernel`). Bound: at decode each token and
// kv head is 144 bytes of planes feeding 7 rows x 4 * 128 f32 operations,
// so the f32 operations bound it, just above the bytes; the first design
// (the shared walk with a restore hook) ran 32 CTAs at decode, walked 64 pages
// one after another with no prefetch, restored element by element and
// reached 1/557 of that bound. Design:
//  * A cluster of up to 8 CTAs per (slot, kv head, tile of 8 or 16 folded
//    rows) splits the tokens the tile's rows can see into contiguous shares
//    of whole 32-token sub-tiles (kernels/tuning.plan_paged_attention): 8
//    slots x 4 kv heads at decode run 256 CTAs. p stays f32 on AMS pages,
//    so where the running max advances changes only the f32 rounding: each
//    rank keeps its own (m, l, acc), advancing m once per sub-tile, and the
//    ranks merge them in rank order through distributed shared memory
//    (deterministic, one launch).
//  * The planes (hi bytes, lsb words, scales of K and V) of a sub-tile are
//    fetched two sub-tiles ahead with cp.async into a 3-stage ring, their
//    block-table entries read one sub-tile earlier still; pages of any size
//    (a sub-tile spans pages below 32 tokens, a page spans sub-tiles above).
//  * Restore in vector form: one thread per 32-bit word of hi nibbles turns
//    it and its shared LSBs (a 64-bit window of the lsb words) into 8
//    values through a 32-entry table, times the token's scale, into f32 rows
//    in shared memory (two float4 stores).
//  * Scores: lane = token, each warp 2 or 4 rows sharing every float4 load
//    of the restored key; p . v: thread = value dim, every row.
// Known weak spots: it runs at 20x its bound at decode, a rank walking only
// 2-4 sub-tiles behind a chain of fixed latencies (lengths, block table,
// first planes, the DSMEM merge) with three barriers per sub-tile; q . k
// and p . v stay on the CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <cooperative_groups.h>

#include "sm90_async.cuh"

namespace cg = cooperative_groups;

#define PA_WARPS 8
#define PA_TILE 32    // tokens of a page in shared memory at once
#define PA_KEEP 256   // tokens of a page whose scores a warp keeps
#define NEG_BIG (-2e30f)
#define NEG_CLAMP (-1e30f)

// The e2 formats of core/formats, bias 1: e2m2 code = S << 4 | E << 2 | M,
// e2m1 code = S << 3 | E << 1 | M (MB mantissa bits).
template <int MB>
__device__ __forceinline__ float decode_e2(int code) {
  const int M = code & ((1 << MB) - 1);
  const int E = (code >> MB) & 3;
  const int S = (code >> (MB + 2)) & 1;
  float v;
  if (E == 0) {
    v = (float)M * (1.0f / (1 << MB));              // M * 2^(1 - 1 - MB)
  } else {
    v = __int_as_float(((E - 1 + 127) << 23) | (M << (23 - MB)));
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

// --- page-load hooks: tokens [t0, t0 + nt) of one page of one kv head ->
//     rows 0 .. nt-1 of Ks [t][d] (load_k) or Vs [t][d] (load_v), f32 at the
//     row strides LDK / LDV. A stream's values are its keys' first columns,
//     so its load_v loads nothing.

// Packed planes of one pool leaf [P, page, kv, *]
struct Planes {
  const int8_t* hi; const int32_t* lsb; const float* sc;
};

// K5p on AMS pages: a stream's planes restored to lattice values times
// scale; its values are its keys' first columns
template <int MB>
struct AmsStreamPages {
  Planes k;
  int hb, gw, ksh;
  static constexpr bool kPvBf16 = false;
  static constexpr bool kStream = true;

  template <int LD>
  __device__ __forceinline__ void restore(float* __restrict__ dst, const Planes& pl, int64_t pg,
                                          int t0, int nt, int page, int kv, int h,
                                          int hd) const {
    for (int i = threadIdx.x; i < nt * hd; i += blockDim.x) {
      const int t = i / hd, d = i - t * hd;
      const int64_t vec = (pg * page + t0 + t) * kv + h;
      const int byte = ((int)pl.hi[vec * hb + (d >> 1)]) & 0xFF;
      const int nib = (d & 1) ? ((byte >> 4) & 0xF) : (byte & 0xF);
      const int grp = d / ksh;
      const int bit = (pl.lsb[vec * gw + (grp >> 5)] >> (grp & 31)) & 1;
      dst[t * LD + d] = decode_e2<MB>((nib << 1) | bit) * pl.sc[vec];
    }
  }
  template <int LD>
  __device__ __forceinline__ void load_k(float* Ks, int64_t pg, int t0, int nt, int page,
                                         int kv, int h, int hd) const {
    restore<LD>(Ks, k, pg, t0, nt, page, kv, h, hd);
  }
  template <int LD>
  __device__ __forceinline__ void load_v(float*, int64_t, int, int, int, int, int, int) const {}
};

// K3 / K5p on bf16 pages [P, page, kv, hd], widened to f32 (exact)
template <bool STREAM>
struct Bf16Pages {
  const __nv_bfloat16* k; const __nv_bfloat16* v;   // v unused when STREAM
  static constexpr bool kPvBf16 = true;
  static constexpr bool kStream = STREAM;

  template <int LD>
  __device__ __forceinline__ static void widen(float* __restrict__ dst,
                                               const __nv_bfloat16* __restrict__ src,
                                               int64_t pg, int t0, int nt, int page, int kv,
                                               int h, int hd) {
    if ((hd & 7) == 0) {               // 16-byte loads: 8 bf16 per thread
      const int vpr = hd >> 3;         // vectors per row
      for (int i = threadIdx.x; i < nt * vpr; i += blockDim.x) {
        const int t = i / vpr, d = (i - t * vpr) << 3;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + ((pg * page + t0 + t) * kv + h) * (int64_t)hd + d);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(p2[j]);
          dst[t * LD + d + 2 * j] = f.x;
          dst[t * LD + d + 2 * j + 1] = f.y;
        }
      }
    } else {
      for (int i = threadIdx.x; i < nt * hd; i += blockDim.x) {
        const int t = i / hd, d = i - t * hd;
        dst[t * LD + d] =
            __bfloat162float(src[((pg * page + t0 + t) * kv + h) * (int64_t)hd + d]);
      }
    }
  }
  template <int LD>
  __device__ __forceinline__ void load_k(float* Ks, int64_t pg, int t0, int nt, int page,
                                         int kv, int h, int hd) const {
    widen<LD>(Ks, k, pg, t0, nt, page, kv, h, hd);
  }
  template <int LD>
  __device__ __forceinline__ void load_v(float* Vs, int64_t pg, int t0, int nt, int page,
                                         int kv, int h, int hd_v) const {
    if (!STREAM) widen<LD>(Vs, v, pg, t0, nt, page, kv, h, hd_v);
  }
};

// lane t's score of token t of a sub-tile of nt tokens in Ks, its key
// position kpos masked past the row's length len; -inf for lanes >= nt
template <int DPL, int LDK>
__device__ __forceinline__ float tile_scores(const float (&qr)[DPL], const float* Ks, int lane,
                                             int nt, int hd, int kpos, int len) {
  float my_s = 0.f;
  for (int t = 0; t < nt; ++t) {
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) part = fmaf(qr[j], Ks[t * LDK + d], part);
    }
    part = warp_sum(part);
    if (lane == t) my_s = part;
  }
  return (lane < nt) ? my_s + ((kpos < len) ? 0.f : NEG_BIG) : -INFINITY;
}

// acc = acc * corr + sum_t p_t v_t over the nt tokens of a sub-tile in Vs,
// p_t being lane t's p, rounded to bf16 first for bf16 pages (the PV
// product takes p in the pages' type)
template <int VPL, int LDV, bool PV_BF16>
__device__ __forceinline__ void accumulate(float (&acc)[VPL], float corr, float p,
                                           const float* Vs, int lane, int nt, int hd_v) {
  const float pv = PV_BF16 ? __bfloat162float(__float2bfloat16(p)) : p;
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] *= corr;
  for (int t = 0; t < nt; ++t) {
    const float pt = __shfl_sync(0xffffffffu, pv, t);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd_v) acc[j] = fmaf(pt, Vs[t * LDV + d], acc[j]);
    }
  }
}

// --- the shared online-softmax walk -----------------------------------------
template <int DPL, int VPL, class Pages>
__global__ void __launch_bounds__(PA_WARPS * 32)
paged_attention_kernel(const float* __restrict__ q, const Pages pages,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ lengths, float* __restrict__ out,
                       int kv, int R, int hd, int hd_v, int page, int MP, int c, int g,
                       int keep) {
  // a sub-tile in shared memory at compile-time strides: [PA_TILE][LDK]
  // keys, [PA_TILE][LDV] values (a stream's values are its keys' first
  // columns), then each warp's kept scores [keep]
  constexpr int LDK = 32 * DPL;
  constexpr int LDV = Pages::kStream ? LDK : 32 * VPL;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Pages::kStream ? smem : smem + PA_TILE * LDK;
  __shared__ int maxlen_s;
  // a pair pool's values are as wide as its keys
  if (!Pages::kStream) hd_v = hd;
  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.z * PA_WARPS + warp;
  const bool has_row = row < R;
  const int len = has_row ? lengths[(int64_t)b * c + row / g] : 0;

  if (threadIdx.x == 0) maxlen_s = 0;
  __syncthreads();
  if (lane == 0 && has_row && len > 0) atomicMax(&maxlen_s, len);
  __syncthreads();
  const int maxlen = min(maxlen_s, MP * page);
  const int npages = (maxlen + page - 1) / page;

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

  for (int i = 0; i < npages; ++i) {
    const int64_t pg = block_table[(int64_t)b * MP + i];
    // sub-tiles holding a key some row of the block can see (block-uniform)
    const int subs = min((page + PA_TILE - 1) / PA_TILE,
                         (maxlen - i * page + PA_TILE - 1) / PA_TILE);
    if (subs == 1) {                     // one pass: keys and values loaded once
      const int nt = min(PA_TILE, page);
      __syncthreads();                   // previous page fully consumed
      pages.template load_k<LDK>(Ks, pg, 0, nt, page, kv, h, hd);
      pages.template load_v<LDV>(Vs, pg, 0, nt, page, kv, h, hd_v);
      __syncthreads();
      if (has_row) {                     // warp-uniform
        const float s = tile_scores<DPL, LDK>(qr, Ks, lane, nt, hd, i * page + lane, len);
        const float m_new = fmaxf(fmaxf(m, warp_max(s)), NEG_CLAMP);
        const float p = (lane < nt) ? expf(s - m_new) : 0.f;
        const float corr = expf(m - m_new);
        l = l * corr + warp_sum(p);
        accumulate<VPL, LDV, Pages::kPvBf16>(acc, corr, p, Vs, lane, nt, hd_v);
        m = m_new;
      }
      continue;
    }
    // two passes: pass 1 takes every sub-tile's scores and the page's max
    // (scores of the first `keep` tokens kept per warp, the rest recomputed)
    float* Ss = smem + PA_TILE * (LDK + (Pages::kStream ? 0 : LDV)) + warp * keep;
    float s_max = -INFINITY;
    for (int t0 = 0; t0 < subs * PA_TILE; t0 += PA_TILE) {
      const int nt = min(PA_TILE, page - t0);
      __syncthreads();
      pages.template load_k<LDK>(Ks, pg, t0, nt, page, kv, h, hd);
      __syncthreads();
      if (has_row) {
        const float s = tile_scores<DPL, LDK>(qr, Ks, lane, nt, hd, i * page + t0 + lane, len);
        s_max = fmaxf(s_max, s);
        if (t0 < keep) Ss[t0 + lane] = s;
      }
    }
    const float m_new = fmaxf(fmaxf(m, warp_max(s_max)), NEG_CLAMP);
    const float corr = expf(m - m_new);
    // pass 2: p at the page's max and the PV product, sub-tile by sub-tile
    float p_sum = 0.f;
    for (int t0 = 0; t0 < subs * PA_TILE; t0 += PA_TILE) {
      const int nt = min(PA_TILE, page - t0);
      __syncthreads();
      if (Pages::kStream || t0 >= keep)
        pages.template load_k<LDK>(Ks, pg, t0, nt, page, kv, h, hd);
      pages.template load_v<LDV>(Vs, pg, t0, nt, page, kv, h, hd_v);
      __syncthreads();
      if (has_row) {
        const float s = t0 < keep ? Ss[t0 + lane]
                                  : tile_scores<DPL, LDK>(qr, Ks, lane, nt, hd,
                                                          i * page + t0 + lane, len);
        const float p = (lane < nt) ? expf(s - m_new) : 0.f;
        p_sum += warp_sum(p);
        accumulate<VPL, LDV, Pages::kPvBf16>(acc, t0 ? 1.f : corr, p, Vs, lane, nt, hd_v);
      }
    }
    l = l * corr + p_sum;
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

template <int DPL, int VPL, class Pages>
static int launch(const void* q, const Pages& pages, const void* block_table,
                  const void* lengths, void* out, int B, int kv, int R, int hd, int hd_v,
                  int page, int MP, int c, int g, void* stream) {
  if (B <= 0 || kv <= 0 || R <= 0) return (int)cudaSuccess;
  if (hd > 32 * DPL || hd_v > 32 * VPL || hd_v < 1 || hd_v > hd || page < 1)
    return (int)cudaErrorInvalidValue;
  // scores are kept only where a page takes more than one sub-tile
  const int keep = page > PA_TILE ? min((page + PA_TILE - 1) / PA_TILE * PA_TILE, PA_KEEP) : 0;
  const size_t smem = sizeof(float) * (PA_TILE * 32 * (DPL + (Pages::kStream ? 0 : VPL)) +
                                       PA_WARPS * keep);
  dim3 grid(B, kv, (R + PA_WARPS - 1) / PA_WARPS);
  paged_attention_kernel<DPL, VPL, Pages><<<grid, PA_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, pages, (const int32_t*)block_table, (const int32_t*)lengths,
      (float*)out, kv, R, hd, hd_v, page, MP, c, g, keep);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K2: the tokens of each (slot, kv head, row tile) split over a cluster
// ---------------------------------------------------------------------------
#define K2_WARPS 4
#define K2_THREADS (K2_WARPS * 32)
#define K2_TK 32                    // tokens per sub-tile: one per lane
#define K2_HDP 128                  // widest head (K2 refuses wider)
#define K2_LDX (K2_HDP + 4)         // f32 per restored row: float4 reads conflict-free
#define K2_HB 64                    // hi bytes of one token a stage holds (dims < 128)
#define K2_NS 3                     // stages of the raw-plane ring
#define K2_LDP (K2_TK + 4)          // f32 per p row

// The packed planes of one sub-tile of K and V: hi bytes, lsb words, scales
struct K2Stage {
  uint8_t hi[2][K2_TK][K2_HB];
  int32_t lsb[2][K2_TK][4];
  float sc[2][K2_TK];
};

template <int MB, int RT>
__global__ void __launch_bounds__(K2_THREADS)
k2_kernel(const float* __restrict__ q, const Planes kp, const Planes vp,
          const int32_t* __restrict__ block_table, const int32_t* __restrict__ lengths,
          float* __restrict__ out, int kv, int R, int hd, int hb, int gw, int ksh, int page,
          int MP, int c, int g, bool hi16) {
  constexpr int RPW = RT / K2_WARPS;      // score rows per warp
  constexpr int PV_UNROLL = RT > 8 ? 1 : 2;   // 16 rows x 2 steps of p in flight spill
  extern __shared__ __align__(16) unsigned char k2_smem[];
  K2Stage* stages = reinterpret_cast<K2Stage*>(k2_smem);                   // [K2_NS]
  float* Ks = reinterpret_cast<float*>(stages + K2_NS);                    // [32][K2_LDX]
  float* Vs = Ks + K2_TK * K2_LDX;                                         // [32][K2_LDX]
  float* qs = Vs + K2_TK * K2_LDX;                                         // [RT][K2_LDX]
  float* Ps = qs + RT * K2_LDX;                                            // [RT][K2_LDP]
  float* corr_s = Ps + RT * K2_LDP;                                        // [RT]
  float* m_s = corr_s + RT;                                                // [RT]
  float* l_s = m_s + RT;                                                   // [RT]
  float* lut = l_s + RT;                                                   // [32]
  int* lens = reinterpret_cast<int*>(lut + 32);                            // [RT]
  int64_t* vecs = reinterpret_cast<int64_t*>(lens + 16);                   // [NS][32]
  float* Osm = Ks;                                                         // [RT][K2_LDX]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (blockIdx.x / CL) * RT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  {                                     // q's loads and the lengths' in flight together
    float qv[RT];                       // thread: dim tid of every row
#pragma unroll
    for (int r = 0; r < RT; ++r)
      qv[r] = (row0 + r < R && tid < hd) ? q[(((int64_t)b * kv + h) * R + row0 + r) * hd + tid]
                                          : 0.f;
    if (tid < RT) {
      const int row = row0 + tid;
      lens[tid] = row < R ? lengths[(int64_t)b * c + row / g] : 0;
    }
    if (tid < 32) lut[tid] = decode_e2<MB>(tid);
#pragma unroll
    for (int r = 0; r < RT; ++r) qs[r * K2_LDX + tid] = qv[r];
  }
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int i = 0; i < RT; ++i) maxlen = max(maxlen, lens[i]);
  const int ntok = min(maxlen, MP * page);
  // this rank's tokens: a contiguous share of whole sub-tiles
  const int sh = ((ntok + CL - 1) / CL + K2_TK - 1) / K2_TK * K2_TK;
  const int lo = min(rank * sh, ntok), hi = min(lo + sh, ntok);
  const int nsub = (hi - lo + K2_TK - 1) / K2_TK;

  // the restore: thread (word w, tokens tq + 8 u) turns a 32-bit word of hi
  // nibbles (dims 8 w .. 8 w + 7) and their shared LSBs into 8 values
  const int w = tid & 15, tq = tid >> 4;
  const bool wact = 8 * w < hd;
  const int wsel = ((8 * w) / ksh) >> 5;                 // the lsb word of the first dim
  int rel[8];                                            // bit of each dim in the window
#pragma unroll
  for (int j = 0; j < 8; ++j) rel[j] = (8 * w + j) / ksh - 32 * wsel;
  const int hbytes = 4 * ((hd + 7) >> 3);                // hi bytes a token's dims need

  // threads 0-31: the page of token tid of sub-tile s (-1 past the share),
  // read from the block table one sub-tile before locate() needs it
  auto page_of = [&](int s) {
    const int tok = lo + s * K2_TK + tid;
    return (s < nsub && tok < hi) ? block_table[(int64_t)b * MP + tok / page] : -1;
  };
  // the pool rows of sub-tile s's tokens (-1 past the share)
  auto locate = [&](int s, int pg) {
    const int tok = lo + s * K2_TK + tid;
    vecs[(s % K2_NS) * K2_TK + tid] =
        pg >= 0 ? ((int64_t)pg * page + tok % page) * kv + h : (int64_t)-1;
  };
  // sub-tile s's planes -> stage s % K2_NS (zeros past the share); one
  // commit group per sub-tile
  auto fetch = [&](int s) {
    K2Stage& st = stages[s % K2_NS];
    const int64_t* vecs_s = vecs + (s % K2_NS) * K2_TK;
    if (hi16) {
      const int nch = (hbytes + 15) >> 4;
      for (int i = tid; i < 2 * K2_TK * nch; i += K2_THREADS) {
        const int pl = i / (K2_TK * nch), rem = i - pl * (K2_TK * nch);
        const int t = rem / nch, ch = rem - t * nch;
        const int64_t v = vecs_s[t];
        const int8_t* base = pl ? vp.hi : kp.hi;
        cp_async16(&st.hi[pl][t][16 * ch], v >= 0 ? base + v * hb + 16 * ch : base, v >= 0);
      }
    } else {                           // rows not 16-byte aligned: plain byte loads
      for (int i = tid; i < 2 * K2_TK * hbytes; i += K2_THREADS) {
        const int pl = i / (K2_TK * hbytes), rem = i - pl * (K2_TK * hbytes);
        const int t = rem / hbytes, by = rem - t * hbytes;
        const int64_t v = vecs_s[t];
        st.hi[pl][t][by] = (v >= 0 && by < hb) ? (uint8_t)(pl ? vp.hi : kp.hi)[v * hb + by] : 0;
      }
    }
    for (int i = tid; i < 2 * K2_TK * gw; i += K2_THREADS) {
      const int pl = i / (K2_TK * gw), rem = i - pl * (K2_TK * gw);
      const int t = rem / gw, j = rem - t * gw;
      const int64_t v = vecs_s[t];
      const int32_t* base = pl ? vp.lsb : kp.lsb;
      cp_async_bytes<4>(&st.lsb[pl][t][j], v >= 0 ? base + v * gw + j : base, v >= 0);
    }
    if (tid < 2 * K2_TK) {
      const int pl = tid >> 5, t = tid & 31;
      const int64_t v = vecs_s[t];
      const float* base = pl ? vp.sc : kp.sc;
      cp_async_bytes<4>(&st.sc[pl][t], v >= 0 ? base + v : base, v >= 0);
    }
    cp_async_commit();
  };

  int pg_next = -1;                    // threads 0-31: the page for the next locate()
  if (tid < K2_TK) {
    const int pg0 = page_of(0), pg1 = page_of(1);
    pg_next = page_of(2);
    locate(0, pg0);
    locate(1, pg1);
  }
  __syncthreads();
  fetch(0);
  fetch(1);

  float acc[RT];                       // thread: value dim tid of every row
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  float m[RPW], lpart[RPW];            // rows warp + 4 i; lpart: lane's keys only
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_CLAMP;
    lpart[i] = 0.f;
  }

  for (int s = 0; s < nsub; ++s) {
    cp_async_wait<K2_NS - 2>();
    __syncthreads();                   // sub-tile s landed; Ks, Vs and Ps are free
    {
      const K2Stage& st = stages[s % K2_NS];
      if (wact) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = tq + 8 * u;
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            const uint32_t word = *reinterpret_cast<const uint32_t*>(&st.hi[pl][t][4 * w]);
            const uint32_t w0 = (uint32_t)st.lsb[pl][t][wsel];
            const uint32_t w1 = wsel + 1 < gw ? (uint32_t)st.lsb[pl][t][wsel + 1] : 0u;
            const uint64_t win = ((uint64_t)w1 << 32) | w0;
            const float sc = st.sc[pl][t];
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int code = (int)(((word >> (4 * j)) & 15u) << 1) | (int)((win >> rel[j]) & 1u);
              v[j] = 8 * w + j < hd ? lut[code] * sc : 0.f;
            }
            float* dst = (pl ? Vs : Ks) + t * K2_LDX + 8 * w;
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
          }
        }
      }
    }
    if (tid < K2_TK) {
      locate(s + K2_NS - 1, pg_next);
      pg_next = page_of(s + K2_NS);
    }
    __syncthreads();                   // Ks, Vs and vecs ready; stage s is consumed
    fetch(s + K2_NS - 1);
    // scores: lane = token, warp w = rows w, w + 4, ..; every restored key
    // serves the warp's rows, its float4 loads shared by them
    {
      float sacc[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) sacc[i] = 0.f;
      const float* kr = Ks + lane * K2_LDX;
      for (int d = 0; d < hd; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4 q4 = *reinterpret_cast<const float4*>(qs + (warp + 4 * i) * K2_LDX + d);
          sacc[i] = fmaf(q4.x, k4.x, sacc[i]);
          sacc[i] = fmaf(q4.y, k4.y, sacc[i]);
          sacc[i] = fmaf(q4.z, k4.z, sacc[i]);
          sacc[i] = fmaf(q4.w, k4.w, sacc[i]);
        }
      }
      const int key = lo + s * K2_TK + lane;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + 4 * i;
        const float sv = key >= hi ? -INFINITY : sacc[i] + (key < lens[r] ? 0.f : NEG_BIG);
        const float m_new = fmaxf(fmaxf(m[i], warp_max(sv)), NEG_CLAMP);
        const float p = expf(sv - m_new);             // p stays f32 (pv_dtype = f32)
        const float cr = expf(m[i] - m_new);
        lpart[i] = lpart[i] * cr + p;
        m[i] = m_new;
        Ps[r * K2_LDP + lane] = p;
        if (lane == 0) corr_s[r] = cr;
      }
    }
    __syncthreads();                   // p and the rescales ready
    // p . v: thread = value dim tid, every row
    if (tid < hd) {
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] *= corr_s[r];
#pragma unroll PV_UNROLL
      for (int t4 = 0; t4 < K2_TK; t4 += 4) {
        const float v0 = Vs[t4 * K2_LDX + tid], v1 = Vs[(t4 + 1) * K2_LDX + tid];
        const float v2 = Vs[(t4 + 2) * K2_LDX + tid], v3 = Vs[(t4 + 3) * K2_LDX + tid];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(Ps + r * K2_LDP + t4);
          acc[r] = fmaf(p4.x, v0, acc[r]);
          acc[r] = fmaf(p4.y, v1, acc[r]);
          acc[r] = fmaf(p4.z, v2, acc[r]);
          acc[r] = fmaf(p4.w, v3, acc[r]);
        }
      }
    }
  }

  // this rank's (m, l, acc) -> shared memory; the ranks' partials merged in
  // rank order by the rank that finishes each output
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float l = warp_sum(lpart[i]);
    if (lane == 0) {
      m_s[warp + 4 * i] = m[i];
      l_s[warp + 4 * i] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // Ks is free: reuse it for acc
  if (tid < hd) {
#pragma unroll
    for (int r = 0; r < RT; ++r) Osm[r * K2_LDX + tid] = acc[r];
  }
  cluster.sync();
  const int nrow = min(RT, R - row0);
  for (int e = tid + rank * K2_THREADS; e < nrow * hd; e += CL * K2_THREADS) {
    const int r = e / hd, d = e - r * hd;
    float mq[8], lq[8], aq[8];          // every rank's partials loaded first
#pragma unroll
    for (int q2 = 0; q2 < 8; ++q2) {
      if (q2 < CL) {
        mq[q2] = cluster.map_shared_rank(m_s, q2)[r];
        lq[q2] = cluster.map_shared_rank(l_s, q2)[r];
        aq[q2] = cluster.map_shared_rank(Osm, q2)[r * K2_LDX + d];
      }
    }
    float mx = NEG_CLAMP;
#pragma unroll
    for (int q2 = 0; q2 < 8; ++q2)
      if (q2 < CL) mx = fmaxf(mx, mq[q2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < 8; ++q2) {
      if (q2 < CL) {
        const float wq = expf(mq[q2] - mx);
        num += wq * aq[q2];
        den += wq * lq[q2];
      }
    }
    out[(((int64_t)b * kv + h) * R + row0 + r) * hd + d] = num / fmaxf(den, 1e-20f);
  }
  cluster.sync();                      // no CTA leaves while its partials are read
}

template <int RT>
static size_t k2_smem_bytes() {
  return sizeof(K2Stage) * K2_NS + sizeof(float) * (2 * K2_TK * K2_LDX + RT * K2_LDX +
                                                    RT * K2_LDP + 3 * RT + 32 + 16) +
         sizeof(int64_t) * K2_TK * K2_NS;
}

template <int MB, int RT>
static int k2_launch_t(const void* q, Planes k, Planes v, const void* block_table,
                       const void* lengths, void* out, int B, int kv, int R, int hd, int hb,
                       int gw, int ksh, int page, int MP, int c, int g, int cluster, bool hi16,
                       void* stream) {
  auto kernel = k2_kernel<MB, RT>;
  const size_t smem = k2_smem_bytes<RT>();
  static bool ready = false;            // the kernel's attribute is set once
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * ((R + RT - 1) / RT), kv, B);
  cfg.blockDim = dim3(K2_THREADS, 1, 1);
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
      &cfg, kernel, (const float*)q, k, v, (const int32_t*)block_table,
      (const int32_t*)lengths, (float*)out, kv, R, hd, hb, gw, ksh, page, MP, c, g, hi16);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// 16-byte copies of the hi rows where every row is 16-byte aligned (hd 128
// at k = 2 and 4: 64 bytes), else byte loads (fp4.33's 66 bytes)
static bool k2_hi16(int hb, const void* khi, const void* vhi) {
  const uintptr_t a = (uintptr_t)khi | (uintptr_t)vhi;
  return hb % 16 == 0 && (a & 15) == 0;
}

static int k2_launch(int man_bits, int rows, Planes k, Planes v, const void* q,
                     const void* block_table, const void* lengths, void* out, int B, int kv,
                     int R, int hd, int hb, int gw, int ksh, int page, int MP, int c, int g,
                     int cluster, void* stream) {
  if (B <= 0 || kv <= 0 || R <= 0) return (int)cudaSuccess;
  if (hd < 1 || hd > K2_HDP || 2 * hb < hd || gw < 1 || gw > 4 || ksh < 1 || page < 1 ||
      MP < 1 || c < 1 || g < 1 || R != c * g || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  const bool hi16 = k2_hi16(hb, k.hi, v.hi);
#define K2_CASE(MB_, RT_)                                                                    \
  if (man_bits == MB_ && rows == RT_)                                                       \
    return k2_launch_t<MB_, RT_>(q, k, v, block_table, lengths, out, B, kv, R, hd, hb, gw, ksh, \
                                 page, MP, c, g, cluster, hi16, stream);
  K2_CASE(2, 8)
  K2_CASE(2, 16)
  K2_CASE(1, 8)
  K2_CASE(1, 16)
#undef K2_CASE
  return (int)cudaErrorInvalidValue;
}

static Planes planes(const void* hi, const void* lsb, const void* sc) {
  return Planes{(const int8_t*)hi, (const int32_t*)lsb, (const float*)sc};
}

// K2 takes heads up to 128 wide (the widest served GQA head), its row tile
// and cluster from kernels/tuning.plan_paged_attention; K3 heads up to 128;
// K5p streams up to 288 wide with values up to 256 (MiniCPM3-4B's 256 + 32)
extern "C" int paged_attention_ams(const void* q, const void* khi, const void* klsb,
                                   const void* ksc, const void* vhi, const void* vlsb,
                                   const void* vsc, const void* block_table,
                                   const void* lengths, void* out, int B, int kv, int R,
                                   int hd, int hb, int gw, int ksh, int man_bits, int page,
                                   int MP, int c, int g, int rows, int cluster, void* stream) {
  return k2_launch(man_bits, rows, planes(khi, klsb, ksc), planes(vhi, vlsb, vsc), q,
                   block_table, lengths, out, B, kv, R, hd, hb, gw, ksh, page, MP, c, g,
                   cluster, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* block_table, const void* lengths, void* out,
                                    int B, int kv, int R, int hd, int page, int MP, int c,
                                    int g, void* stream) {
  Bf16Pages<false> pages{(const __nv_bfloat16*)k, (const __nv_bfloat16*)v};
  return launch<4, 4>(q, pages, block_table, lengths, out, B, kv, R, hd, hd, page, MP, c, g,
                      stream);
}

extern "C" int paged_attention_stream_ams(const void* q, const void* hi, const void* lsb,
                                          const void* sc, const void* block_table,
                                          const void* lengths, void* out, int B, int kv,
                                          int R, int hd, int hd_v, int hb, int gw, int ksh,
                                          int man_bits, int page, int MP, int c, int g,
                                          void* stream) {
  const Planes k = planes(hi, lsb, sc);
  if (man_bits == 2)         // e2m2 codes
    return launch<9, 8>(q, AmsStreamPages<2>{k, hb, gw, ksh}, block_table, lengths, out, B, kv,
                        R, hd, hd_v, page, MP, c, g, stream);
  if (man_bits == 1)         // e2m1 codes
    return launch<9, 8>(q, AmsStreamPages<1>{k, hb, gw, ksh}, block_table, lengths, out, B, kv,
                        R, hd, hd_v, page, MP, c, g, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_attention_stream_bf16(const void* q, const void* k,
                                           const void* block_table, const void* lengths,
                                           void* out, int B, int kv, int R, int hd, int hd_v,
                                           int page, int MP, int c, int g, void* stream) {
  Bf16Pages<true> pages{(const __nv_bfloat16*)k, (const __nv_bfloat16*)k};
  return launch<9, 8>(q, pages, block_table, lengths, out, B, kv, R, hd, hd_v, page, MP, c, g,
                      stream);
}
