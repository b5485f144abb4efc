// K2, K3 and K5p: paged flash-decode over a page pool, one online-softmax
// body behind a page-load hook, as in the TPU template.
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
// Per (slot b, kv head h) the kernel walks block_table[b, i], loads each
// page's K and V into shared memory as f32 (AMS pages restore the packed
// planes - hi nibbles, shared-LSB bitplane, f32 scale per token and head - to
// exact lattice values; bf16 pages are widened with 16-byte loads, which is
// exact; a stream page is loaded once and its first hd_v columns are the
// values), and runs the online softmax of the reference: scores get an
// additive -2e30 mask past a row's length, the running max is clamped at
// -1e30, so masked scores give exp(...) == 0 exactly and a row of length 0
// ends as exact zeros; the output is acc / max(l, 1e-20). bf16 pages round p
// to bf16 at the running max before the PV product (l sums the unrounded p),
// as the template does with pv_dtype. Ragged chunks arrive folded: row r of
// the [R = c*g] query block belongs to query r / g (chunk-major), whose
// valid key count is lengths[b*c + r/g].
//
// Bound: each page is read once per (slot, head, row tile) and the work per
// byte is small, so K2/K3 are bound by device-memory bytes at decode; K5p
// shares one stream across 40 heads (rows = c * 40), so its bound is the
// operations, 2 * (hd + hd_v) per row and key.
// Design: one warp per folded query row (8 rows per block, so decode with
// g = 7 needs one block per (slot, head)); each lane holds hd/32 dims of q
// and hd_v/32 of the accumulator, compile-time per instantiation (4 / 4 up
// to 128 wide for K2/K3, 9 / 8 up to 288 / 256 for K5p). A page of any size
// is walked in sub-tiles of at most 32 tokens (lane t scores token t of a
// sub-tile). The running max advances once per page, as in the reference,
// so the walk takes two passes over a page wider than 32: the first loads
// each sub-tile's keys, keeps its scores (up to 256 tokens per warp in
// shared memory; past that they are recomputed in the second pass) and
// forms the page's max; the second loads each sub-tile's values and forms
// p at that max, so bf16 pages round p where the plain walk does. A page
// of at most 32 tokens (or whose visible keys fit one sub-tile) loads keys
// and values once, in one pass. Sub-tiles sit in dynamic shared memory as
// f32 rows at a compile-time stride, the widest row of the instantiation
// (runtime strides made K2/K3 slower on the card): 32 x 2 x 128 x 4 = 32 KB
// for a K/V pair, 32 x 288 x 4 = 36 KB for a stream, plus 8 KB of kept
// scores for pages wider than 32: under the 48 KB a launch gets without
// opting in. The block stops after the last page, and the last sub-tile,
// any of its rows can see: keys past every row's length contribute exact
// zeros in the reference, so skipping them is exact. Known weak spots: 8
// slots x 4 kv heads fill 32 of the H100's 132 SMs at GQA decode (a
// split-KV pass with an (m, l, acc) combine is later work), and K5p's row
// tiles (5 per slot at decode, 80 at chunk 16) each reload, and on AMS
// pages re-restore, every page, with scalar FMAs where the 40 heads on one
// stream want a tensor-core product.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// K2 / K5p on AMS pages: planes restored to lattice values times scale
template <int MB, bool STREAM>
struct AmsPages {
  Planes k, v;                        // v unused when STREAM
  int hb, gw, ksh;
  static constexpr bool kPvBf16 = false;
  static constexpr bool kStream = STREAM;

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
  __device__ __forceinline__ void load_v(float* Vs, int64_t pg, int t0, int nt, int page,
                                         int kv, int h, int hd_v) const {
    if (!STREAM) restore<LD>(Vs, v, pg, t0, nt, page, kv, h, hd_v);
  }
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

// AMS pages of e2m2 (man_bits 2) or e2m1 (man_bits 1) codes
template <int DPL, int VPL, bool STREAM>
static int launch_ams(int man_bits, Planes k, Planes v, int hb, int gw, int ksh, const void* q,
                      const void* block_table, const void* lengths, void* out, int B, int kv,
                      int R, int hd, int hd_v, int page, int MP, int c, int g, void* stream) {
  if (man_bits == 2)
    return launch<DPL, VPL>(q, AmsPages<2, STREAM>{k, v, hb, gw, ksh}, block_table, lengths,
                            out, B, kv, R, hd, hd_v, page, MP, c, g, stream);
  if (man_bits == 1)
    return launch<DPL, VPL>(q, AmsPages<1, STREAM>{k, v, hb, gw, ksh}, block_table, lengths,
                            out, B, kv, R, hd, hd_v, page, MP, c, g, stream);
  return (int)cudaErrorInvalidValue;
}

static Planes planes(const void* hi, const void* lsb, const void* sc) {
  return Planes{(const int8_t*)hi, (const int32_t*)lsb, (const float*)sc};
}

// K2 and K3 take heads up to 128 wide (the widest served GQA head); K5p
// streams up to 288 wide with values up to 256 (MiniCPM3-4B's 256 + 32)
extern "C" int paged_attention_ams(const void* q, const void* khi, const void* klsb,
                                   const void* ksc, const void* vhi, const void* vlsb,
                                   const void* vsc, const void* block_table,
                                   const void* lengths, void* out, int B, int kv, int R,
                                   int hd, int hb, int gw, int ksh, int man_bits, int page,
                                   int MP, int c, int g, void* stream) {
  return launch_ams<4, 4, false>(man_bits, planes(khi, klsb, ksc), planes(vhi, vlsb, vsc), hb,
                                 gw, ksh, q, block_table, lengths, out, B, kv, R, hd, hd, page,
                                 MP, c, g, stream);
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
  return launch_ams<9, 8, true>(man_bits, k, k, hb, gw, ksh, q, block_table, lengths, out, B,
                                kv, R, hd, hd_v, page, MP, c, g, stream);
}

extern "C" int paged_attention_stream_bf16(const void* q, const void* k,
                                           const void* block_table, const void* lengths,
                                           void* out, int B, int kv, int R, int hd, int hd_v,
                                           int page, int MP, int c, int g, void* stream) {
  Bf16Pages<true> pages{(const __nv_bfloat16*)k, (const __nv_bfloat16*)k};
  return launch<9, 8>(q, pages, block_table, lengths, out, B, kv, R, hd, hd_v, page, MP, c, g,
                      stream);
}
