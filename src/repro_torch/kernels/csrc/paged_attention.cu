// K2, K3 and K5p: paged flash-decode over a page pool, one online-softmax
// contract (the TPU template's) behind three kernels.
//
// Replaces src/repro/kernels/attention_template.py: fused_paged_attention
// (online_softmax_step, row_lengths, launched through _launch ->
// pallas_call) with
//   K2:  the _make_load_ams hook (restore_page): packed AMS pages (e2m2 or
//        e2m1 codes), `k2_kernel`;
//   K3:  the _load_pair hook with pv_dtype = the pool's bf16: bf16 pages,
//        `k3_kernel`;
//   K5p: the paged absorbed-MLA stream (value_slice): one stream pool whose
//        values are its first hd_v columns, on bf16 pages (_make_load_stream)
//        or on AMS pages (_make_load_ams with hd_v: only the K planes are
//        restored), `k5p_kernel<AMS>`.
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
// exact zeros, so a tile of rows stops after the last key any of them sees.
//
// All three split the tokens a tile of rows can see over a thread-block
// cluster of up to 8 CTAs (the portable size), each rank a contiguous share
// of whole 32-token tiles in rank order, any page size (a tile spans pages
// below 32 tokens, a page spans tiles above). Each rank ends with its own
// (m, l, acc); the ranks merge them in rank order through distributed
// shared memory with weights exp(m_r - m*) (deterministic, one launch).
//
// The page max on bf16 pages (K3, K5p bf16). The running max at page i is
// the clamped maximum of every score up to the end of page i (masked scores
// sit below the clamp), so one exchange per segment of tokens gives every
// rank the plain walk's m at each of its pages: a rank scores its share and
// keeps the scores, with each row's maxima per 8-key group and their prefix;
// it publishes its share's max and the max of its first page's part; after
// cluster.sync its base is the running max of the segments walked and the
// lower ranks' share maxima, on its last page also the first-page maxima of
// the higher ranks that share that page. m at a key's page is then the
// maximum of the base and its own prefix up to the page's last key in its
// share (px_* below), and bf16(p) is bit-equal to the plain walk's. A
// segment is as many whole pages as the cluster's score buffers hold (one
// segment at the served shapes). A page wider than that is walked in
// segments of its own; in its first the ranks also scan the rest of the
// page for its max (scores not kept: those keys are read twice), so every
// segment of it rounds p at the page's max.
// p . v runs on the tensor cores: each step of 64 keys takes m_step, the m
// of its last key, and weights a key of an earlier page by w = exp(m - m_step)
// <= 1; bf16(p) * w, an f32, enters mma.sync as three bf16 parts (the upper
// two only where some w < 1: exact products, f32 sums), and acc and l are
// rescaled by exp(m_prev - m_step) once per step.
//
// K3 (`paged_attention_bf16`, `k3_kernel`). Bound: at decode each key and
// value byte feeds 2 * 7 operations, so the bytes bound it; the first design
// (one warp per row, 8 slots x 4 kv heads = 32 CTAs at decode, every page
// widened to f32) reached 1/57 of that bound. Design: K4's machinery over
// pages. A cluster per (slot, kv head, tile of 16 folded rows, one m16 tile)
// splits the tokens (kernels/tuning.plan_paged_bf16_attention: 256 CTAs at
// decode) in segments and shares of the block table's tokens, each share
// cut at the tile's last visible token: the split of a row's tokens follows
// the block table, the page and the cluster (none of them B or the row
// tiles), and a row with no token in a share keeps its running max through
// the steps walked for the other rows, so a row gets the same bits whatever
// else the call holds; the pool rows of a share are looked up in the block table
// once per segment; K then V tiles of 32 keys stream through an 8-tile
// cp.async ring (every byte read once), scores once on tensor cores from
// f32 q split into three bf16 parts (one part where q holds bf16 values, as
// the paged path's scaled q does: the CTA tests it), kept in shared memory.
//
// K5p (`paged_attention_stream_bf16` / `_ams`, `k5p_kernel`). 40 heads on one
// stream of 256 + 32 columns (values its first 256): each key feeds 40 rows x
// 2 * (288 + 256) operations, so the operations bound it; the first design
// (5 row tiles of 8 per slot at decode, each reloading and on AMS pages
// re-restoring every page, scalar FMAs) reached 1/286 (bf16) and 1/440
// (AMS) of it. Design: K5's machinery over pages. One CTA holds 48 folded
// rows (all 40 heads of a slot at decode) with q's three bf16 parts in
// shared memory (read by ldmatrix); a cluster splits the tokens
// (tuning.plan_paged_mla_attention); a share of up to 128 keys stays
// resident in a 4-tile ring from the scores to p . v, each tile serving as
// K and V (longer lengths take more segments). bf16 pages arrive by 16-byte
// cp.async and take the page max above. AMS pages are restored once per CTA
// for all its rows, a 32-bit word of hi nibbles per thread with its LSBs
// from a 64-bit window of the lsb words, to their lattice values, which
// bf16 holds exactly; the token's scale multiplies the tensor-core score,
// and p * scale (p stays f32, each rank's own max) enters p . v as three
// bf16 parts.
//
// K2 (`paged_attention_ams`, `k2_kernel`). Bound: at decode each token and
// kv head is 144 bytes of planes feeding 7 rows x 4 * 128 f32 operations,
// so the f32 operations bound it, just above the bytes; the first design
// (the shared walk with a restore hook) ran 32 CTAs at decode, walked 64 pages
// one after another with no prefetch, restored element by element and
// reached 1/557 of that bound. Design:
//  * A cluster of up to 8 CTAs per (slot, kv head, tile of 8 or 16 folded
//    rows) splits each row's visible tokens [0, n) into K2_PARTS
//    contiguous shares of whole 32-token sub-tiles, a function of n alone
//    (kernels/tuning.paged_row_shares; the cluster from
//    kernels/tuning.plan_paged_attention): 8 slots x 4 kv heads at decode
//    run 256 CTAs. p stays f32 on AMS pages, so where the running max
//    advances changes only the f32 rounding: each rank keeps its own (m, l,
//    acc) per row, advancing m once per sub-tile, and the ranks merge them
//    in rank order through distributed shared memory (deterministic, one
//    launch). A rank walks the union of its rows' shares, each row seeing
//    only its own: the rows of a tile differ by the chunk's positions, so
//    the union is about one share. A row's bits then do not depend on the
//    other rows of its tile, the row tiles or the cluster: a row gets the
//    same result in a tick of any width.
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

#define NEG_BIG (-2e30f)
#define NEG_CLAMP (-1e30f)
#define MAX_CLUSTER 8               // the portable cluster size

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

// Packed planes of one pool leaf [P, page, kv, *]
struct Planes {
  const int8_t* hi; const int32_t* lsb; const float* sc;
};

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Launch ``kernel`` over ``grid`` in clusters of ``cluster`` CTAs along x;
// returns the launch's error, else cudaGetLastError()
template <typename... Params, typename... Args>
static int launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                            int cluster, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
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
#define K2_PARTS MAX_CLUSTER        // shares of a row's visible tokens

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
  // row r's share of its n visible tokens: part `rank` of K2_PARTS, whole
  // sub-tiles (the last cut at n); this rank walks the union of its rows'
  // shares, [lo, hi), and the warp's rows keep their own bounds
  auto share = [&](int r, int& a, int& e) {
    const int n = min(lens[r], MP * page);
    const int sh = ((n + K2_PARTS - 1) / K2_PARTS + K2_TK - 1) / K2_TK * K2_TK;
    a = min(rank * sh, n);
    e = min(a + sh, n);
  };
  int lo = MP * page, hi = 0;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    int a, e;
    share(i, a, e);
    if (e > a) {
      lo = min(lo, a);
      hi = max(hi, e);
    }
  }
  if (hi <= lo) lo = hi = 0;
  int row_lo[RPW], row_hi[RPW];        // rows warp + 4 i
#pragma unroll
  for (int i = 0; i < RPW; ++i) share(warp + 4 * i, row_lo[i], row_hi[i]);
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
        const float sv = key >= row_lo[i] && key < row_hi[i] ? sacc[i] : -INFINITY;
        const float m_new = fmaxf(fmaxf(m[i], warp_max(sv)), NEG_CLAMP);
        const float p = expf(sv - m_new);             // p stays f32 (pv_dtype = f32)
        const float cr = expf(m[i] - m_new);
        lpart[i] = fmaf(lpart[i], cr, p);
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
        num = fmaf(wq, aq[q2], num);
        den = fmaf(wq, lq[q2], den);
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
  return launch_clustered(kernel, dim3(cluster * ((R + RT - 1) / RT), kv, B), K2_THREADS, smem,
                          cluster, stream, (const float*)q, k, v, (const int32_t*)block_table,
                          (const int32_t*)lengths, (float*)out, kv, R, hd, hb, gw, ksh, page, MP,
                          c, g, hi16);
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
      MP < 1 || c < 1 || g < 1 || R != c * g || cluster > 8 ||
      cluster < min(K2_PARTS, (MP * page + K2_TK - 1) / K2_TK))   // a share without a rank
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

// ---------------------------------------------------------------------------
// The page max on bf16 pages, shared by K3 and K5p: segments, shares and the
// running max the plain walk rounds p at (see the header)
// ---------------------------------------------------------------------------
#define PX_TK 32                    // tokens per ring tile and per share unit

// Rank r's share [lo, hi) of the segment [s0, s1): whole 32-token tiles but
// the last, contiguous, in rank order (tuning.attention_shares)
__device__ __forceinline__ int2 px_share(int s0, int s1, int CL, int r) {
  const int sh = ((s1 - s0 + CL - 1) / CL + PX_TK - 1) / PX_TK * PX_TK;
  const int lo = min(s0 + r * sh, s1);
  return make_int2(lo, min(lo + sh, s1));
}

// One row's 8-key group maxima G[0 .. ng) -> their prefix maxima, in place
__device__ __forceinline__ void px_prefix(float* G, int ng) {
  float m = -INFINITY;
  for (int i = 0; i < ng; ++i) {
    m = fmaxf(m, G[i]);
    G[i] = m;
  }
}

// The max of one row's share scores S[0 .. e] (n keys in the share; S holds
// -inf past them), from its group prefix maxima GP
__device__ __forceinline__ float px_max_upto(const float* S, const float* GP, int e, int n) {
  const int gi = e >> 3;
  if ((e & 7) == 7 || e == n - 1) return GP[gi];
  float m = gi ? GP[gi - 1] : -INFINITY;
  for (int x = gi << 3; x <= e; ++x) m = fmaxf(m, S[x]);
  return m;
}

// The last share key of the page that holds share key j ([lo, hi) the share)
__device__ __forceinline__ int px_page_last(int lo, int hi, int j, int page) {
  return min(((lo + j) / page + 1) * page, hi) - 1 - lo;
}

// After the cluster barrier, for one row: the rank's base (``mrun``, the
// running max of the segments walked, and the lower ranks' share maxima),
// the base on its last page (also the first-page maxima of the higher ranks
// that share that page), and ``mrun`` past this segment. ``pub`` holds each
// rank's [2][rows] share and first-page maxima of this segment; the shares
// are those of [s0, s1), each cut at ``cut``.
__device__ __forceinline__ void px_exchange(cg::cluster_group& cluster, float* pub, int rows,
                                            int row, int rank, int CL, int s0, int s1, int cut,
                                            int2 share, int page, float& base, float& base_last,
                                            float& mrun) {
  float bs = mrun, all = mrun, hx = -INFINITY;
  const int pe = share.y > share.x ? ((share.y - 1) / page + 1) * page : 0;
  for (int q = 0; q < CL; ++q) {
    const float* pq = cluster.map_shared_rank(pub, q);
    const float smax = pq[row];
    all = fmaxf(all, smax);
    if (q < rank) {
      bs = fmaxf(bs, smax);
    } else if (q > rank) {
      const int2 sq = px_share(s0, s1, CL, q);
      if (sq.x < min(sq.y, cut) && sq.x < pe) hx = fmaxf(hx, pq[rows + row]);
    }
  }
  base = bs;
  base_last = fmaxf(bs, hx);
  mrun = all;
}

// The ranks' (m, l, acc) of a tile of rows -> its outputs: Osm [rows][ldo]
// holds each rank's acc, lsum / mfin its l and m per row; rank q finishes
// every CL-th run of THREADS (row, 4 dims) cells of the nrow x W outputs at
// ``orow`` (row stride W), loading the ranks' partials first and summing
// them in rank order with weights exp(m_r - m*) (deterministic). Starts and
// ends with a cluster barrier, so no CTA leaves while its partials are read.
template <int THREADS>
__device__ __forceinline__ void px_merge(cg::cluster_group& cluster, float* Osm, int ldo,
                                         float* lsum, float* mfin, float* __restrict__ orow,
                                         int nrow, int W, int rank, int CL) {
  cluster.sync();
  const int dq = (W + 3) >> 2;
  for (int e = threadIdx.x + rank * THREADS; e < nrow * dq; e += CL * THREADS) {
    const int r = e / dq, d = (e - r * dq) * 4;
    float4 part[MAX_CLUSTER];
    float lp[MAX_CLUSTER], mp[MAX_CLUSTER];
#pragma unroll
    for (int q2 = 0; q2 < MAX_CLUSTER; ++q2) {
      if (q2 < CL) {
        part[q2] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(Osm, q2) + r * ldo + d);
        lp[q2] = cluster.map_shared_rank(lsum, q2)[r];
        mp[q2] = cluster.map_shared_rank(mfin, q2)[r];
      }
    }
    float mx = NEG_CLAMP;
#pragma unroll
    for (int q2 = 0; q2 < MAX_CLUSTER; ++q2)
      if (q2 < CL) mx = fmaxf(mx, mp[q2]);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < MAX_CLUSTER; ++q2) {
      if (q2 < CL) {
        const float w = expf(mp[q2] - mx);
        sum.x += w * part[q2].x;
        sum.y += w * part[q2].y;
        sum.z += w * part[q2].z;
        sum.w += w * part[q2].w;
        l += w * lp[q2];
      }
    }
    const float den = fmaxf(l, 1e-20f);
    const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < W) orow[(int64_t)r * W + d + i] = sv[i] / den;
  }
  cluster.sync();
}


// ---------------------------------------------------------------------------
// K3: bf16 pages, the tokens of each (slot, kv head, 16-row tile) split over
// a cluster
// ---------------------------------------------------------------------------
#define K3_ROWS 16                  // folded query rows per CTA: one m16 tile
#define K3_TK 32                    // keys per ring tile: one n8 tile per warp
#define K3_WARPS 4
#define K3_THREADS (K3_WARPS * 32)
#define K3_HDP 128                  // widest head (K3 refuses wider)
#define K3_LDK (K3_HDP + 8)         // bf16 per smem key row: conflict-free fragments
#define K3_LDP (2 * K3_TK + 8)      // bf16 per smem p row: two tiles a step
#define K3_LDO (K3_HDP + 4)         // f32 per smem output row
#define K3_NS 8                     // ring slots of one 32-key K or V tile
#define K3_CAP_MAX 512              // widest share whose scores a CTA keeps
#define K3_SMALL 240                // f32 of per-row state

static size_t k3_smem_bytes(int cap) {
  return (size_t)K3_NS * K3_TK * K3_LDK * 2 + (size_t)K3_ROWS * (cap + 4) * 4 +
         (size_t)K3_ROWS * (cap / 8) * 4 + (size_t)3 * K3_ROWS * K3_LDP * 2 + (size_t)cap * 4 +
         K3_SMALL * 4;
}

// The pool token of key r of a tile: tk[r] (-1 past the share), or without
// ``tk`` the run of ``count`` tokens from ``first`` (a tile inside one page)
__device__ __forceinline__ int px_token(const int* tk, int first, int count, int r) {
  return tk ? tk[r] : (r < count ? first + r : -1);
}

// The 32 keys of a tile (pool tokens from `px_token`) of kv head h of a
// [P * page, kv, W] bf16 pool -> dst[key][K3_LDK], zeros past W and past
// the share: dims [0, K3_HDP) with 16-byte cp.async when ``vec``, [0, Wp)
// with plain loads otherwise.
__device__ __forceinline__ void k3_load_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ src,
                                             const int* tk, int first, int count, int kv, int h,
                                             int W, int Wp, bool vec) {
  if (vec) {
    // thread: dims d .. d+7 of keys r0, r0 + 8, r0 + 16, r0 + 24
    constexpr int CPR = K3_HDP / 8, RSTEP = K3_THREADS / CPR;
    const int r0 = threadIdx.x / CPR, d = (threadIdx.x % CPR) * 8;
#pragma unroll
    for (int u = 0; u < K3_TK / RSTEP; ++u) {
      const int r = r0 + RSTEP * u, tok = px_token(tk, first, count, r);
      const bool ok = tok >= 0 && d < W;
      cp_async16(dst + r * K3_LDK + d, ok ? src + ((int64_t)tok * kv + h) * W + d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < K3_TK * Wp; i += K3_THREADS) {
      const int r = i / Wp, d = i - r * Wp, tok = px_token(tk, first, count, r);
      dst[r * K3_LDK + d] = (tok >= 0 && d < W) ? src[((int64_t)tok * kv + h) * W + d]
                                                 : __float2bfloat16_rn(0.f);
    }
  }
}

__global__ void __launch_bounds__(K3_THREADS)
k3_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kpool,
          const __nv_bfloat16* __restrict__ vpool, const int32_t* __restrict__ block_table,
          const int32_t* __restrict__ lengths, float* __restrict__ out, int kv, int R, int hd,
          int page, int MP, int c, int g, int cap, int vec) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  const int lds = cap + 4, ldg = cap / 8;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(k3_smem);            // [NS][32][LDK]
  float* Ssm = reinterpret_cast<float*>(ring + K3_NS * K3_TK * K3_LDK);        // [16][lds]
  float* Gsm = Ssm + K3_ROWS * lds;                                             // [16][ldg]
  __nv_bfloat16* Psm = reinterpret_cast<__nv_bfloat16*>(Gsm + K3_ROWS * ldg);  // [3][16][LDP]
  int* toks = reinterpret_cast<int*>(Psm + 3 * K3_ROWS * K3_LDP);               // [cap]
  float* small = reinterpret_cast<float*>(toks + cap);
  float* pub = small;               // [2][2][16] share / first-page maxima, by segment parity
  float* base_s = small + 64;       // [16] the base of the rank's pages
  float* basel_s = small + 80;      // [16] the base of its last page
  float* mrun_s = small + 96;       // [16] the running max of the segments walked
  float* corr_s = small + 112;      // [16] exp(m_prev - m_step) of this step
  float* lsum = small + 128;        // [16] this CTA's l
  float* mfin = small + 144;        // [16] this CTA's m
  int* lens = reinterpret_cast<int*>(small + 160);   // [16]
  float* wmax = small + 176;        // [4][16] per warp: the max over a wide page's rest
  float* Osm = reinterpret_cast<float*>(ring);        // [16][K3_LDO] after the walk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (blockIdx.x / CL) * K3_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;

  // q's A fragments (rows gq, gq+8): the f32 loads are issued before the
  // lengths' barrier so their latencies overlap
  const int nks = (hd + 15) >> 4;
  float qraw[K3_HDP / 16][4][2];
  {
    const float* qb = q + (((int64_t)b * kv + h) * R) * hd;
#pragma unroll
    for (int ks = 0; ks < K3_HDP / 16; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {      // a0a1, a2a3, a4a5, a6a7
        const int row = row0 + gq + ((e & 1) ? 8 : 0);
        const int d = 16 * ks + 2 * t + ((e & 2) ? 8 : 0);
        qraw[ks][e][0] = (row < R && d < hd) ? qb[(int64_t)row * hd + d] : 0.f;
        qraw[ks][e][1] = (row < R && d + 1 < hd) ? qb[(int64_t)row * hd + d + 1] : 0.f;
      }
    }
  }
  if (tid < K3_ROWS) {
    const int row = row0 + tid;
    lens[tid] = row < R ? lengths[(int64_t)b * c + row / g] : 0;
    mrun_s[tid] = -INFINITY;
  }
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int i = 0; i < K3_ROWS; ++i) maxlen = max(maxlen, lens[i]);
  const int ntok = min(maxlen, MP * page);
  const int len_a = lens[gq], len_b = lens[gq + 8];        // the thread's score rows
  // three bf16 parts per k-step; one where q holds bf16 values (nq)
  uint32_t qa[3][K3_HDP / 16][4];
  int qfrac = 0;
#pragma unroll
  for (int ks = 0; ks < K3_HDP / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat16 p0[3], p1[3];
      split_bf16x3(qraw[ks][e][0], p0);
      split_bf16x3(qraw[ks][e][1], p1);
      qfrac |= (__bfloat16_as_ushort(p0[1]) | __bfloat16_as_ushort(p1[1])) & 0x7fff;
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) qa[pp][ks][e] = pack_bf16x2(p0[pp], p1[pp]);
    }
  }
  const int nq = __syncthreads_or(qfrac) ? 3 : 1;

  const int wk = 16 * nks;                                // key dims loaded (zeros past hd)
  const int wv = min(K3_HDP, ((hd + 31) >> 5) << 5);      // value dims loaded
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // the p-forming thread: row prow, keys pk .. pk+7 of a step; its part of
  // l and the rank's running max m of that row
  const int prow = tid >> 3, pk = (tid & 7) * 8;
  const float* Sr = Ssm + prow * lds;
  const float* Gr = Gsm + prow * ldg;
  float lpart = 0.f, mrow = NEG_CLAMP;

  const int seg_cap = CL * cap;                           // tokens the score buffers hold
  const bool wide = page > seg_cap;                       // a page wider than a segment
  const int tkeys = MP * page;                            // the block table's tokens
  const int len_p = lens[prow];                           // the p-forming thread's row
  int par = 0;
  for (int s0 = 0; s0 < ntok; par ^= 1) {
    // the segment and the rank's share follow the block table, the page and
    // the cluster alone; the share is cut at the tile's last visible token,
    // so a row's split never depends on the other rows of its tile
    const int pend = min((s0 / page + 1) * page, ntok);
    const int s1 = wide ? min(s0 + seg_cap, min((s0 / page + 1) * page, tkeys))
                        : min(s0 + seg_cap / page * page, tkeys);
    int2 share = px_share(s0, s1, CL, rank);
    share.y = min(share.y, ntok);
    share.x = min(share.x, share.y);
    const int lo = share.x, hi = share.y, n = hi - lo;
    const int ntile = (n + K3_TK - 1) / K3_TK;
    // the first segment of a wide page also takes the max over the rest of
    // the page, its scores not kept
    const int2 rest =
        wide && s0 % page == 0 && pend > s1 ? px_share(s1, pend, CL, rank) : make_int2(0, 0);
    const int nrest = (rest.y - rest.x + K3_TK - 1) / K3_TK;
    for (int j = tid; j < ntile * K3_TK; j += K3_THREADS) {
      const int key = lo + j;
      toks[j] = j < n ? block_table[(int64_t)b * MP + key / page] * page + key % page : -1;
    }
    // the segment's loads in the order they are used: items 0 .. ntile-1
    // the K tiles of pass 1, then the rest's nrest K tiles, then from v0 the
    // V tiles of pass 2; item i sits in ring slot i % K3_NS
    const int v0 = ntile + nrest, total = v0 + ntile;
    int issued = 0;
    auto tile = [&](int item) { return ring + (item % K3_NS) * K3_TK * K3_LDK; };
    // make items [.., u1] resident, after issuing up to u0 + K3_NS - 1
    auto acquire = [&](int u0, int u1) {
      __syncthreads();
      for (; issued < min(total, u0 + K3_NS); ++issued) {
        if (issued < ntile) {
          k3_load_tile(tile(issued), kpool, toks + issued * K3_TK, 0, 0, kv, h, hd, wk, vec);
        } else if (issued < v0) {           // a tile of the rest: inside one page
          const int p0 = rest.x + (issued - ntile) * K3_TK;
          const int first = block_table[(int64_t)b * MP + p0 / page] * page + p0 % page;
          k3_load_tile(tile(issued), kpool, nullptr, first, min(K3_TK, rest.y - p0), kv, h, hd,
                       wk, vec);
        } else {
          k3_load_tile(tile(issued), vpool, toks + (issued - v0) * K3_TK, 0, 0, kv, h, hd, wv,
                       vec);
        }
        cp_async_commit();
      }
      cp_async_wait_pending(issued - 1 - u1);
      __syncthreads();
    };
    // scores of a tile whose key 0 is key0, keys from kend on -inf (warp w:
    // keys 8w .. 8w+7): tile i of the share -> Ssm, and their 8-key group
    // maxima -> Gsm; i < 0 (the rest of a wide page) -> the maxima ra / rb
    float ra = -INFINITY, rb = -INFINITY;
    auto scores = [&](const __nv_bfloat16* Kt, int key0, int kend, int i) {
      float sp[6][4];
#pragma unroll
      for (int u = 0; u < 6; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[u][e] = 0.f;
      const __nv_bfloat16* kr = Kt + (8 * warp + gq) * K3_LDK + 2 * t;
#pragma unroll
      for (int ks = 0; ks < K3_HDP / 16; ++ks) {
        if (ks < nks) {
          const uint32_t b0r = *reinterpret_cast<const uint32_t*>(kr + 16 * ks);
          const uint32_t b1r = *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8);
#pragma unroll
          for (int pp = 0; pp < 3; ++pp)
            if (pp < nq) mma_bf16(sp[2 * pp + (ks & 1)], qa[pp][ks], b0r, b1r);
        }
      }
      float s[4];
      const int k0 = key0 + 8 * warp + 2 * t;            // key of s[0]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + (e & 1);
        const int len = (e & 2) ? len_b : len_a;
        const float v = ((sp[4][e] + sp[5][e]) + (sp[2][e] + sp[3][e])) + (sp[0][e] + sp[1][e]);
        s[e] = key >= kend ? -INFINITY : v + (key < len ? 0.f : NEG_BIG);
      }
      if (i < 0) {
        ra = fmaxf(ra, fmaxf(s[0], s[1]));
        rb = fmaxf(rb, fmaxf(s[2], s[3]));
        return;
      }
      const int j0 = k0 - lo;                            // share key of s[0]
      *reinterpret_cast<float2*>(Ssm + gq * lds + j0) = make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(Ssm + (gq + 8) * lds + j0) = make_float2(s[2], s[3]);
      float ga = fmaxf(s[0], s[1]), gb = fmaxf(s[2], s[3]);
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        ga = fmaxf(ga, __shfl_xor_sync(0xffffffffu, ga, o));
        gb = fmaxf(gb, __shfl_xor_sync(0xffffffffu, gb, o));
      }
      if (t == 0) {
        Gsm[gq * ldg + 4 * i + warp] = ga;
        Gsm[(gq + 8) * ldg + 4 * i + warp] = gb;
      }
    };

    // pass 1, two tiles a step: the share's scores and group maxima, then
    // the maxima of the rest of a wide page
    for (int i = 0; i < ntile; i += 2) {
      acquire(i, min(i + 1, ntile - 1));
      scores(tile(i), lo + i * K3_TK, hi, i);
      if (i + 1 < ntile) scores(tile(i + 1), lo + (i + 1) * K3_TK, hi, i + 1);
    }
    for (int i = 0; i < nrest; i += 2) {
      acquire(ntile + i, ntile + min(i + 1, nrest - 1));
      scores(tile(ntile + i), rest.x + i * K3_TK, rest.y, -1);
      if (i + 1 < nrest) scores(tile(ntile + i + 1), rest.x + (i + 1) * K3_TK, rest.y, -1);
    }
    if (wide) {                          // block-uniform
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        ra = fmaxf(ra, __shfl_xor_sync(0xffffffffu, ra, o));
        rb = fmaxf(rb, __shfl_xor_sync(0xffffffffu, rb, o));
      }
      if (t == 0) {
        wmax[warp * K3_ROWS + gq] = ra;
        wmax[warp * K3_ROWS + gq + 8] = rb;
      }
    }
    __syncthreads();
    if (tid < K3_ROWS) {                 // publish the share's and first page's maxima
      float* G = Gsm + tid * ldg;
      px_prefix(G, 4 * ntile);
      float smax = ntile ? G[4 * ntile - 1] : -INFINITY;
      if (wide) {
#pragma unroll
        for (int w = 0; w < K3_WARPS; ++w) smax = fmaxf(smax, wmax[w * K3_ROWS + tid]);
      }
      pub[par * 32 + tid] = smax;
      pub[par * 32 + 16 + tid] =
          n ? px_max_upto(Ssm + tid * lds, G, px_page_last(lo, hi, 0, page), n) : -INFINITY;
    }
    cluster.sync();
    if (tid < K3_ROWS) {
      float bs, bl, mr = mrun_s[tid];
      px_exchange(cluster, pub + par * 32, K3_ROWS, tid, rank, CL, s0, s1, ntok, share, page, bs,
                  bl, mr);
      // a wide page's max is known whole from its first segment on
      base_s[tid] = wide ? mr : bs;
      basel_s[tid] = wide ? mr : bl;
      mrun_s[tid] = mr;
    }
    __syncthreads();
    const float bse = base_s[prow], bsl = basel_s[prow];
    const int last_page = n ? (hi - 1) / page : -1;
    // the row's last share key: past it m stays the row's own (its later
    // keys are masked); a row with no key in the share keeps its m, so the
    // steps walked for the tile's other rows rescale it by exactly 1
    const int e_row = min(n, len_p - lo) - 1;
    // the plain walk's running max at the page whose last share key is e
    auto m_at = [&](int e) {
      if (e_row < 0) return mrow;
      e = min(e, e_row);
      const float bb = (lo + e) / page == last_page ? bsl : bse;
      return fmaxf(fmaxf(px_max_upto(Sr, Gr, e, n), bb), NEG_CLAMP);
    };

    // pass 2, two tiles a step: p = exp(s - m) at each key's page max, l +=
    // p w, acc += (bf16(p) w) . v, w = exp(m - m_step)
    for (int j = 0; j < ntile; j += 2) {
      const int nt2 = min(2, ntile - j);
      acquire(v0 + j, v0 + j + nt2 - 1);
      int pfrac = 0;
      {
        const int kb = j * K3_TK;
        const float mstep = m_at(px_page_last(lo, hi, min(kb + 2 * K3_TK, n) - 1, page));
        const float cr = expf(mrow - mstep);
        lpart *= cr;
        mrow = mstep;
        if ((tid & 7) == 0) corr_s[prow] = cr;
        __nv_bfloat16 pa[3][8];
        int e_prev = -1;
        float me = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int jj = kb + pk + x;
          float a = 0.f;
          if (jj < n) {
            const int e = px_page_last(lo, hi, jj, page);
            if (e != e_prev) {
              me = m_at(e);
              e_prev = e;
            }
            const float p = expf(Sr[jj] - me);
            const float w = expf(me - mstep);
            lpart += p * w;
            a = __bfloat162float(__float2bfloat16_rn(p)) * w;     // pv_dtype = bf16
          }
          __nv_bfloat16 ps[3];
          split_bf16x3(a, ps);
          pfrac |= (__bfloat16_as_ushort(ps[1]) | __bfloat16_as_ushort(ps[2])) & 0x7fff;
#pragma unroll
          for (int pp = 0; pp < 3; ++pp) pa[pp][x] = ps[pp];
        }
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) {
          uint4 w4;
          w4.x = pack_bf16x2(pa[pp][0], pa[pp][1]);
          w4.y = pack_bf16x2(pa[pp][2], pa[pp][3]);
          w4.z = pack_bf16x2(pa[pp][4], pa[pp][5]);
          w4.w = pack_bf16x2(pa[pp][6], pa[pp][7]);
          *reinterpret_cast<uint4*>(Psm + (pp * K3_ROWS + prow) * K3_LDP + pk) = w4;
        }
      }
      const int np = __syncthreads_or(pfrac) ? 3 : 1;     // p and the rescales ready
      {
        const float ca = corr_s[gq], cb = corr_s[gq + 8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] *= ca;
          acc[i][1] *= ca;
          acc[i][2] *= cb;
          acc[i][3] *= cb;
        }
      }
      const int d0 = 32 * warp;
      if (d0 < hd) {
        const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int kk = 0; kk < 2 * K3_TK / 16; ++kk) {
          if (kk < nt2 * (K3_TK / 16)) {
            // V rows 16 kk .. 16 kk + 15 of the step: tile kk / 2 of it
            const __nv_bfloat16* Vt = tile(v0 + j + (kk >> 1)) + ((kk & 1) * 16) * K3_LDK;
            uint32_t bv[2][4];
#pragma unroll
            for (int np2 = 0; np2 < 2; ++np2)
              ldmatrix_x4_trans(bv[np2],
                                Vt + ((mi & 1) * 8 + r8) * K3_LDK + d0 + 16 * np2 + (mi >> 1) * 8);
#pragma unroll
            for (int pp = 0; pp < 3; ++pp) {
              if (pp < np) {
                uint32_t a[4];
                const __nv_bfloat16* pr = Psm + (pp * K3_ROWS + gq) * K3_LDP + 16 * kk + 2 * t;
                a[0] = *reinterpret_cast<const uint32_t*>(pr);
                a[1] = *reinterpret_cast<const uint32_t*>(pr + 8 * K3_LDP);
                a[2] = *reinterpret_cast<const uint32_t*>(pr + 8);
                a[3] = *reinterpret_cast<const uint32_t*>(pr + 8 * K3_LDP + 8);
#pragma unroll
                for (int np2 = 0; np2 < 2; ++np2) {
                  mma_bf16(acc[2 * np2], a, bv[np2][0], bv[np2][1]);
                  mma_bf16(acc[2 * np2 + 1], a, bv[np2][2], bv[np2][3]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();                    // the ring, scores and token ids free for the next segment
    s0 = s1;
  }

  // this CTA's (m, l, acc) -> shared memory; the ranks' partials merged in
  // rank order by the rank that finishes each output
#pragma unroll
  for (int o = 1; o <= 4; o <<= 1) lpart += __shfl_xor_sync(0xffffffffu, lpart, o);
  if ((tid & 7) == 0) {
    lsum[prow] = lpart;
    mfin[prow] = mrow;
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free: reuse it for acc
  {
    const int d0 = 32 * warp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + 8 * i + 2 * t;
      *reinterpret_cast<float2*>(Osm + gq * K3_LDO + d) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(Osm + (gq + 8) * K3_LDO + d) = make_float2(acc[i][2], acc[i][3]);
    }
  }
  px_merge<K3_THREADS>(cluster, Osm, K3_LDO, lsum, mfin,
                       out + (((int64_t)b * kv + h) * R + row0) * hd, min(K3_ROWS, R - row0), hd,
                       rank, CL);
}

static int k3_launch(const void* q, const void* k, const void* v, const void* block_table,
                     const void* lengths, void* out, int B, int kv, int R, int hd, int page,
                     int MP, int c, int g, int cluster, int cap, void* stream) {
  if (B <= 0 || kv <= 0 || R <= 0) return (int)cudaSuccess;
  if (hd < 1 || hd > K3_HDP || page < 1 || MP < 1 || c < 1 || g < 1 || R != c * g ||
      cluster < 1 || cluster > MAX_CLUSTER || cap < K3_TK || cap % K3_TK || cap > K3_CAP_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k3_smem_bytes(cap);
  static size_t allowed = 48 * 1024;     // the kernel's dynamic shared-memory limit so far
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k3_smem_bytes(K3_CAP_MAX));
    if (e != cudaSuccess) return (int)e;
    allowed = k3_smem_bytes(K3_CAP_MAX);
  }
  const int vec = (hd & 7) == 0 && aligned16(k) && aligned16(v);
  return launch_clustered(k3_kernel, dim3(cluster * ((R + K3_ROWS - 1) / K3_ROWS), kv, B),
                          K3_THREADS, smem, cluster, stream, (const float*)q,
                          (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                          (const int32_t*)block_table, (const int32_t*)lengths, (float*)out, kv,
                          R, hd, page, MP, c, g, cap, vec);
}

// ---------------------------------------------------------------------------
// K5p: the absorbed-MLA stream over pages, 48 rows per CTA, the tokens of
// each (slot, row group) split over a cluster; values are the first hd_v
// columns of the key tiles
// ---------------------------------------------------------------------------
#define K5P_MT 3                    // m16 row tiles per CTA
#define K5P_ROWS (16 * K5P_MT)      // folded query rows per CTA (40 heads at decode)
#define K5P_WARPS 4
#define K5P_THREADS (K5P_WARPS * 32)
#define K5P_TK 32                   // keys per ring tile
#define K5P_HDP 288                 // widest stream (MiniCPM3-4B: 256 + 32)
#define K5P_HVP 256                 // widest value slice
#define K5P_LDK (K5P_HDP + 8)       // bf16 per smem key or q row: conflict-free ldmatrix
#define K5P_NS 4                    // ring slots: a share of up to 128 keys stays resident
#define K5P_CAP (K5P_NS * K5P_TK)   // keys of a rank's share in one segment
#define K5P_LDS (K5P_CAP + 4)       // f32 per score row
#define K5P_LDG (K5P_CAP / 8)       // f32 per group-max row
#define K5P_LDP (2 * K5P_TK + 8)    // bf16 per p row: two tiles a step
#define K5P_LDO (K5P_HVP + 4)       // f32 per output row
#define K5P_QB 9                    // q loads in flight per thread
#define K5P_RB 9                    // AMS words restored per thread in one batch
#define K5P_SMALL (15 * K5P_ROWS + 32)   // f32 of per-row state and the code table

static size_t k5p_smem_bytes() {
  return (size_t)3 * K5P_ROWS * K5P_LDK * 2 + (size_t)K5P_NS * K5P_TK * K5P_LDK * 2 +
         (size_t)K5P_ROWS * K5P_LDS * 4 + (size_t)K5P_ROWS * K5P_LDG * 4 +
         (size_t)3 * K5P_ROWS * K5P_LDP * 2 + (size_t)K5P_CAP * 4 * 2 + K5P_SMALL * 4;
}

// The 32 keys of a tile (pool tokens from `px_token`) of kv head h of a
// [P * page, kv, W] bf16 stream -> dst[key][K5P_LDK], zeros past W and past
// the share: all K5P_HDP dims with 16-byte cp.async when ``vec``, [0, Wp)
// with plain loads otherwise.
__device__ __forceinline__ void k5p_load_tile(__nv_bfloat16* dst,
                                              const __nv_bfloat16* __restrict__ src,
                                              const int* tk, int first, int count, int kv,
                                              int h, int W, int Wp, bool vec) {
  if (vec) {
    constexpr int CPR = K5P_HDP / 8;             // 16-byte chunks per row
    for (int i = threadIdx.x; i < K5P_TK * CPR; i += K5P_THREADS) {
      const int r = i / CPR, d = (i - r * CPR) * 8, tok = px_token(tk, first, count, r);
      const bool ok = tok >= 0 && d < W;
      cp_async16(dst + r * K5P_LDK + d, ok ? src + ((int64_t)tok * kv + h) * W + d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < K5P_TK * Wp; i += K5P_THREADS) {
      const int r = i / Wp, d = i - r * Wp, tok = px_token(tk, first, count, r);
      dst[r * K5P_LDK + d] = (tok >= 0 && d < W) ? src[((int64_t)tok * kv + h) * W + d]
                                                  : __float2bfloat16_rn(0.f);
    }
  }
}

// Tile keys with pool tokens tk[0 .. 31] from AMS planes -> their lattice
// values (bf16 holds them exactly) in dst[key][K5P_LDK], dims [0, Wp), zeros
// past hd and past the share; the token scales -> sc[0 .. 31]. A thread
// restores 32-bit words of hi nibbles (8 dims), their shared LSBs taken from
// a 64-bit window of the lsb words, through the code table lut; K5P_RB words'
// loads in flight at once. ``hi4``: hi rows are 4-byte aligned.
template <int MB>
__device__ __forceinline__ void k5p_restore_tile(__nv_bfloat16* dst, float* sc, const Planes pl,
                                                 const int* tk, int kv, int h, int hd, int Wp,
                                                 int hb, int gw, int ksh, const float* lut,
                                                 bool hi4) {
  const int nw = Wp >> 3;                          // words per key (Wp: whole k-steps)
  const int items = K5P_TK * nw;
  for (int i0 = threadIdx.x; i0 < items; i0 += K5P_RB * K5P_THREADS) {
    uint32_t word[K5P_RB], w0[K5P_RB], w1[K5P_RB];
#pragma unroll
    for (int u = 0; u < K5P_RB; ++u) {
      const int i = i0 + u * K5P_THREADS;
      word[u] = w0[u] = w1[u] = 0u;
      const int r = i / nw, w = i - r * nw;
      if (i < items && tk[r] >= 0 && 8 * w < hd) {
        const int64_t vec = (int64_t)tk[r] * kv + h;
        if (hi4) {
          word[u] = *reinterpret_cast<const uint32_t*>(pl.hi + vec * hb + 4 * w);
        } else {
#pragma unroll
          for (int by = 0; by < 4; ++by)
            if (4 * w + by < hb)
              word[u] |= ((uint32_t)(uint8_t)pl.hi[vec * hb + 4 * w + by]) << (8 * by);
        }
        const int wsel = ((8 * w) / ksh) >> 5;
        w0[u] = (uint32_t)pl.lsb[vec * gw + wsel];
        if (wsel + 1 < gw) w1[u] = (uint32_t)pl.lsb[vec * gw + wsel + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < K5P_RB; ++u) {
      const int i = i0 + u * K5P_THREADS;
      if (i < items) {
        const int r = i / nw, w = i - r * nw;
        const int wsel = ((8 * w) / ksh) >> 5;
        const uint64_t win = ((uint64_t)w1[u] << 32) | w0[u];
        __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 8 * w + j;
          const int bit = (int)((win >> (d / ksh - 32 * wsel)) & 1u);
          const int code = (int)(((word[u] >> (4 * j)) & 15u) << 1) | bit;
          v[j] = __float2bfloat16_rn(d < hd && tk[r] >= 0 ? lut[code] : 0.f);
        }
        uint4 w4;
        w4.x = pack_bf16x2(v[0], v[1]);
        w4.y = pack_bf16x2(v[2], v[3]);
        w4.z = pack_bf16x2(v[4], v[5]);
        w4.w = pack_bf16x2(v[6], v[7]);
        *reinterpret_cast<uint4*>(dst + r * K5P_LDK + 8 * w) = w4;
      }
    }
  }
  if (threadIdx.x < K5P_TK) {
    const int tok = tk[threadIdx.x];
    sc[threadIdx.x] = tok >= 0 ? pl.sc[(int64_t)tok * kv + h] : 0.f;
  }
}

// AMS: p stays f32 and the stream is AMS planes (`pl`, codes of MB mantissa
// bits); otherwise bf16 pages (`kpool`), p rounded at the page max
template <bool AMS, int MB>
__global__ void __launch_bounds__(K5P_THREADS, 1)
k5p_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kpool, const Planes pl,
           const int32_t* __restrict__ block_table, const int32_t* __restrict__ lengths,
           float* __restrict__ out, int kv, int R, int hd, int hd_v, int page, int MP, int c,
           int g, int hb, int gw, int ksh, int vec, int qvec) {
  extern __shared__ __align__(16) unsigned char k5p_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(k5p_smem);     // [3][48][LDK]
  __nv_bfloat16* ring = qs + 3 * K5P_ROWS * K5P_LDK;                   // [NS][32][LDK]
  float* Ssm = reinterpret_cast<float*>(ring + K5P_NS * K5P_TK * K5P_LDK);   // [48][LDS]
  float* Gsm = Ssm + K5P_ROWS * K5P_LDS;                                      // [48][LDG]
  __nv_bfloat16* Psm = reinterpret_cast<__nv_bfloat16*>(Gsm + K5P_ROWS * K5P_LDG);  // [3][48][LDP]
  int* toks = reinterpret_cast<int*>(Psm + 3 * K5P_ROWS * K5P_LDP);     // [CAP]
  float* scl = reinterpret_cast<float*>(toks + K5P_CAP);                // [CAP] AMS token scales
  float* small = scl + K5P_CAP;
  float* pub = small;                          // [2][2][48] share / first-page maxima
  float* base_s = small + 4 * K5P_ROWS;        // [48]
  float* basel_s = small + 5 * K5P_ROWS;       // [48]
  float* mrun_s = small + 6 * K5P_ROWS;        // [48]
  float* corr_s = small + 7 * K5P_ROWS;        // [48]
  float* lsum = small + 8 * K5P_ROWS;          // [48]
  float* mfin = small + 9 * K5P_ROWS;          // [48]
  int* lens = reinterpret_cast<int*>(small + 10 * K5P_ROWS);   // [48]
  float* wmax = small + 11 * K5P_ROWS;         // [4][48] per warp: the max over a wide page's rest
  float* lut = small + 15 * K5P_ROWS;          // [32] AMS code -> lattice value
  float* Osm = reinterpret_cast<float*>(ring);                // [48][K5P_LDO] after the walk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (blockIdx.x / CL) * K5P_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;

  if (tid < K5P_ROWS) {
    const int row = row0 + tid;
    lens[tid] = row < R ? lengths[(int64_t)b * c + row / g] : 0;
    mrun_s[tid] = -INFINITY;
  }
  if constexpr (AMS) {
    if (tid < 32) lut[tid] = decode_e2<MB>(tid);
  }
  const int nks = (hd + 15) >> 4;
  const int wk = 16 * nks;                   // key dims loaded (zeros past hd)
  // q -> three bf16 parts in shared memory, zeros past hd (up to whole
  // k-steps) and past R; K5P_QB loads in flight per thread
  int qfrac = 0;
  {
    const float* qb = q + ((int64_t)b * kv + h) * R * hd;
    const int per = qvec ? 4 : 1;                   // f32 per load
    const int nq = wk / per;                        // loads per row
    const int nitems = K5P_ROWS * nq;
    for (int e0 = tid; e0 < nitems; e0 += K5P_QB * K5P_THREADS) {
      float4 xv[K5P_QB];
#pragma unroll
      for (int u = 0; u < K5P_QB; ++u) {
        const int e = e0 + u * K5P_THREADS;
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
      for (int u = 0; u < K5P_QB; ++u) {
        const int e = e0 + u * K5P_THREADS;
        if (e < nitems) {
          const int r = e / nq, d = (e - r * nq) * per;
          const float x[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i < per) {
              __nv_bfloat16 pq[3];
              split_bf16x3(x[i], pq);
              qfrac |= __bfloat16_as_ushort(pq[1]) & 0x7fff;
#pragma unroll
              for (int pp = 0; pp < 3; ++pp) qs[(pp * K5P_ROWS + r) * K5P_LDK + d + i] = pq[pp];
            }
          }
        }
      }
    }
  }
  const int nq = __syncthreads_or(qfrac) ? 3 : 1;   // q's parts needed; lens ready
  int maxlen = 0;
#pragma unroll
  for (int i = 0; i < K5P_ROWS; ++i) maxlen = max(maxlen, lens[i]);
  const int ntok = min(maxlen, MP * page);
  int len_r[2 * K5P_MT];                     // the thread's score rows 16 mt + gq (+ 8)
#pragma unroll
  for (int j = 0; j < 2 * K5P_MT; ++j) len_r[j] = lens[16 * (j >> 1) + gq + 8 * (j & 1)];
  const bool hi4 = AMS && (hb & 3) == 0 && ((uintptr_t)pl.hi & 3) == 0;

  // p . v accumulator: warp w holds value dims [64 w, 64 w + 64) of all 48 rows
  float acc[K5P_MT][8][4];
#pragma unroll
  for (int mt = 0; mt < K5P_MT; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // the p-forming thread: rows prow + 16 mt, keys pk .. pk+7 of a step; its
  // part of l and the rank's running max m of those rows
  const int prow = tid >> 3, pk = (tid & 7) * 8;
  float lpart[K5P_MT], mrow[K5P_MT];
#pragma unroll
  for (int mt = 0; mt < K5P_MT; ++mt) {
    lpart[mt] = 0.f;
    mrow[mt] = NEG_CLAMP;
  }
  const int d0 = 64 * warp;

  // segments: on bf16 pages whole pages (the page max), or parts of a page
  // wider than the cluster's shares hold, whose shares then take two tiles
  // and leave two ring slots to the page's rest; on AMS pages any whole
  // tiles (p stays f32)
  const bool wide = !AMS && page > CL * K5P_CAP;
  const int seg_cap = CL * (wide ? K5P_CAP / 2 : K5P_CAP);
  int par = 0;
  for (int s0 = 0; s0 < ntok; par ^= 1) {
    const int pend = min((s0 / page + 1) * page, ntok);
    const int s1 = AMS ? min(s0 + seg_cap, ntok)
                       : wide ? min(s0 + seg_cap, pend) : min(s0 + seg_cap / page * page, ntok);
    const int2 share = px_share(s0, s1, CL, rank);
    const int lo = share.x, hi = share.y, n = hi - lo;
    const int ntile = (n + K5P_TK - 1) / K5P_TK;
    // the first segment of a wide page also takes the max over the rest of
    // the page, its scores not kept
    const int2 rest = wide && s0 % page == 0 ? px_share(s1, pend, CL, rank) : make_int2(0, 0);
    const int nrest = (rest.y - rest.x + K5P_TK - 1) / K5P_TK;
    for (int j = tid; j < ntile * K5P_TK; j += K5P_THREADS) {
      const int key = lo + j;
      toks[j] = j < n ? block_table[(int64_t)b * MP + key / page] * page + key % page : -1;
    }
    __syncthreads();                          // token ids ready
    auto tile = [&](int i) { return ring + i * (K5P_TK * K5P_LDK); };
    // the share's tiles: on bf16 pages all in flight at once (one commit
    // group each), on AMS pages restored now
    for (int i = 0; i < ntile; ++i) {
      if constexpr (AMS) {
        k5p_restore_tile<MB>(tile(i), scl + i * K5P_TK, pl, toks + i * K5P_TK, kv, h, hd, wk, hb,
                             gw, ksh, lut, hi4);
      } else {
        k5p_load_tile(tile(i), kpool, toks + i * K5P_TK, 0, 0, kv, h, hd, wk, vec);
        cp_async_commit();
      }
    }
    // scores of the nt2 tiles from ring slot i0 on, key0 their first key and
    // keys from kend on -inf (warp w: keys 16 w .. 16 w + 15, two n8 tiles):
    // ``keep``, share tiles -> Ssm and their 8-key group maxima -> Gsm; else
    // (the rest of a wide page) -> the thread's row maxima rmx
    float rmx[2 * K5P_MT];
#pragma unroll
    for (int j = 0; j < 2 * K5P_MT; ++j) rmx[j] = -INFINITY;
    auto scores = [&](int i0, int key0, int kend, int nt2, bool keep) {
      if (16 * warp >= nt2 * K5P_TK) return;                     // warp-uniform
      const __nv_bfloat16* kb = tile(i0 + (warp >> 1)) +
                                (16 * (warp & 1) + (lane & 7) + 8 * (lane >> 4)) * K5P_LDK +
                                8 * ((lane >> 3) & 1);
      const __nv_bfloat16* qa = qs + (lane & 15) * K5P_LDK + 8 * (lane >> 4);
      // one accumulator per q part, summed in a fixed order
      float sp[3][K5P_MT][2][4];
#pragma unroll
      for (int pp = 0; pp < 3; ++pp)
#pragma unroll
        for (int mt = 0; mt < K5P_MT; ++mt)
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[pp][mt][n2][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t bk[4];                      // b0, b1 of keys 0-7, then of keys 8-15
        ldmatrix_x4(bk, kb + 16 * ks);
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) {
          if (pp < nq) {
#pragma unroll
            for (int mt = 0; mt < K5P_MT; ++mt) {
              uint32_t a[4];
              ldmatrix_x4(a, qa + (pp * K5P_ROWS + 16 * mt) * K5P_LDK + 16 * ks);
              mma_bf16(sp[pp][mt][0], a, bk[0], bk[1]);
              mma_bf16(sp[pp][mt][1], a, bk[2], bk[3]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < K5P_MT; ++mt) {
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          const int k0 = key0 + 16 * warp + 8 * n2 + 2 * t;    // key of s[0]
          const int jk = k0 - lo;                               // its share key when kept
          float s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + (e & 1);
            const int len = len_r[2 * mt + (e >> 1)];
            float v = (sp[2][mt][n2][e] + sp[1][mt][n2][e]) + sp[0][mt][n2][e];
            if (AMS) v *= scl[jk + (e & 1)];                   // lattice . q times the scale
            s[e] = key >= kend ? -INFINITY : v + (key < len ? 0.f : NEG_BIG);
          }
          if (!keep) {
            rmx[2 * mt] = fmaxf(rmx[2 * mt], fmaxf(s[0], s[1]));
            rmx[2 * mt + 1] = fmaxf(rmx[2 * mt + 1], fmaxf(s[2], s[3]));
            continue;
          }
          float* sr = Ssm + (16 * mt + gq) * K5P_LDS + jk;
          *reinterpret_cast<float2*>(sr) = make_float2(s[0], s[1]);
          *reinterpret_cast<float2*>(sr + 8 * K5P_LDS) = make_float2(s[2], s[3]);
          float ga = fmaxf(s[0], s[1]), gb = fmaxf(s[2], s[3]);
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            ga = fmaxf(ga, __shfl_xor_sync(0xffffffffu, ga, o));
            gb = fmaxf(gb, __shfl_xor_sync(0xffffffffu, gb, o));
          }
          if (t == 0) {
            const int gi = (jk - 2 * t) >> 3;
            Gsm[(16 * mt + gq) * K5P_LDG + gi] = ga;
            Gsm[(16 * mt + gq + 8) * K5P_LDG + gi] = gb;
          }
        }
      }
    };

    // pass 1, two tiles a step: the share's scores, kept with the tiles;
    // then the rest of a wide page, a tile at a time through ring slots 2
    // and 3 (a wide page's shares hold two tiles)
    for (int i = 0; i < ntile; i += 2) {
      const int nt2 = min(2, ntile - i);
      if (!AMS) cp_async_wait_pending(ntile - i - nt2);
      __syncthreads();
      scores(i, lo + i * K5P_TK, hi, nt2, true);
    }
    auto load_rest = [&](int i) {
      const int p0 = rest.x + i * K5P_TK;
      const int first = block_table[(int64_t)b * MP + p0 / page] * page + p0 % page;
      k5p_load_tile(tile(2 + (i & 1)), kpool, nullptr, first, min(K5P_TK, rest.y - p0), kv, h,
                    hd, wk, vec);
      cp_async_commit();
    };
    if (nrest) load_rest(0);
    for (int i = 0; i < nrest; ++i) {
      if (i + 1 < nrest) load_rest(i + 1);     // its slot was read at step i - 1
      if (i + 1 < nrest)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      scores(2 + (i & 1), rest.x + i * K5P_TK, rest.y, 1, false);
      __syncthreads();
    }
    if (wide) {                          // block-uniform
#pragma unroll
      for (int j = 0; j < 2 * K5P_MT; ++j) {
        rmx[j] = fmaxf(rmx[j], __shfl_xor_sync(0xffffffffu, rmx[j], 1));
        rmx[j] = fmaxf(rmx[j], __shfl_xor_sync(0xffffffffu, rmx[j], 2));
      }
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < 2 * K5P_MT; ++j)
          wmax[warp * K5P_ROWS + 16 * (j >> 1) + gq + 8 * (j & 1)] = rmx[j];
      }
    }
    __syncthreads();
    if (tid < K5P_ROWS) {                // the share's and first page's maxima
      float* G = Gsm + tid * K5P_LDG;
      px_prefix(G, 4 * ntile);
      float smax = ntile ? G[4 * ntile - 1] : -INFINITY;
      if (wide) {
#pragma unroll
        for (int w = 0; w < K5P_WARPS; ++w) smax = fmaxf(smax, wmax[w * K5P_ROWS + tid]);
      }
      if (AMS) {                         // p stays f32: the rank's own max, no exchange
        const float m = fmaxf(mrun_s[tid], smax);
        base_s[tid] = basel_s[tid] = mrun_s[tid] = m;
      } else {
        pub[par * 2 * K5P_ROWS + tid] = smax;
        pub[par * 2 * K5P_ROWS + K5P_ROWS + tid] =
            n ? px_max_upto(Ssm + tid * K5P_LDS, G, px_page_last(lo, hi, 0, page), n)
              : -INFINITY;
      }
    }
    if (!AMS) {
      cluster.sync();
      if (tid < K5P_ROWS) {
        float bs, bl, mr = mrun_s[tid];
        px_exchange(cluster, pub + par * 2 * K5P_ROWS, K5P_ROWS, tid, rank, CL, s0, s1, s1,
                    share, page, bs, bl, mr);
        // a wide page's max is known whole from its first segment on
        base_s[tid] = wide ? mr : bs;
        basel_s[tid] = wide ? mr : bl;
        mrun_s[tid] = mr;
      }
    }
    __syncthreads();
    const int last_page = n ? (hi - 1) / page : -1;
    // the running max p is formed at for the page whose last share key is e
    // (AMS: the rank's max, the same for every key)
    auto m_at = [&](int r, int e) -> float {
      if constexpr (AMS) return fmaxf(base_s[r], NEG_CLAMP);
      const float bb = (lo + e) / page == last_page ? basel_s[r] : base_s[r];
      return fmaxf(fmaxf(px_max_upto(Ssm + r * K5P_LDS, Gsm + r * K5P_LDG, e, n), bb),
                   NEG_CLAMP);
    };

    // pass 2, two tiles a step from the resident tiles: p = exp(s - m), l +=
    // p w, acc += (weight) . v with weight = bf16(p) w on bf16 pages (w =
    // exp(m - m_step)), p times the token's scale on AMS pages
    for (int j = 0; j < ntile; j += 2) {
      const int nt2 = min(2, ntile - j);
      const int kb0 = j * K5P_TK;
      __syncthreads();                  // the previous step's p is consumed
      int pfrac = 0;
      const int elast = px_page_last(lo, hi, min(kb0 + 2 * K5P_TK, n) - 1, page);
#pragma unroll
      for (int mt = 0; mt < K5P_MT; ++mt) {
        const int r = prow + 16 * mt;
        const float* Sr = Ssm + r * K5P_LDS;
        const float mstep = m_at(r, elast);
        const float cr = expf(mrow[mt] - mstep);
        lpart[mt] *= cr;
        mrow[mt] = mstep;
        if ((tid & 7) == 0) corr_s[r] = cr;
        __nv_bfloat16 pa[3][8];
        int e_prev = -1;
        float me = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int jj = kb0 + pk + x;
          float a = 0.f;
          if (jj < n) {
            const int e = AMS ? elast : px_page_last(lo, hi, jj, page);
            if (e != e_prev) {
              me = m_at(r, e);
              e_prev = e;
            }
            const float p = expf(Sr[jj] - me);
            if constexpr (AMS) {
              lpart[mt] += p;
              a = p * scl[jj];                          // pv_dtype = f32
            } else {
              const float w = expf(me - mstep);
              lpart[mt] += p * w;
              a = __bfloat162float(__float2bfloat16_rn(p)) * w;     // pv_dtype = bf16
            }
          }
          __nv_bfloat16 ps[3];
          split_bf16x3(a, ps);
          pfrac |= (__bfloat16_as_ushort(ps[1]) | __bfloat16_as_ushort(ps[2])) & 0x7fff;
#pragma unroll
          for (int pp = 0; pp < 3; ++pp) pa[pp][x] = ps[pp];
        }
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) {
          uint4 w4;
          w4.x = pack_bf16x2(pa[pp][0], pa[pp][1]);
          w4.y = pack_bf16x2(pa[pp][2], pa[pp][3]);
          w4.z = pack_bf16x2(pa[pp][4], pa[pp][5]);
          w4.w = pack_bf16x2(pa[pp][6], pa[pp][7]);
          *reinterpret_cast<uint4*>(Psm + (pp * K5P_ROWS + r) * K5P_LDP + pk) = w4;
        }
      }
      const int np = __syncthreads_or(pfrac) ? 3 : 1;     // p and the rescales ready
#pragma unroll
      for (int mt = 0; mt < K5P_MT; ++mt) {
        const float ca = corr_s[16 * mt + gq], cb = corr_s[16 * mt + gq + 8];
#pragma unroll
        for (int n2 = 0; n2 < 8; ++n2) {
          acc[mt][n2][0] *= ca;
          acc[mt][n2][1] *= ca;
          acc[mt][n2][2] *= cb;
          acc[mt][n2][3] *= cb;
        }
      }
      if (d0 < hd_v) {
        const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int kk = 0; kk < 2 * K5P_TK / 16; ++kk) {
          if (kk < nt2 * (K5P_TK / 16)) {
            // V rows 16 kk .. 16 kk + 15 of the step: tile kk / 2 of it
            const __nv_bfloat16* Vt = tile(j + (kk >> 1)) + ((kk & 1) * 16) * K5P_LDK;
#pragma unroll
            for (int pp = 0; pp < 3; ++pp) {
              if (pp < np) {
                uint32_t a[K5P_MT][4];
#pragma unroll
                for (int mt = 0; mt < K5P_MT; ++mt)
                  ldmatrix_x4(a[mt], Psm + (pp * K5P_ROWS + 16 * mt + (lane & 15)) * K5P_LDP +
                                         16 * kk + 8 * (lane >> 4));
#pragma unroll
                for (int np4 = 0; np4 < 4; ++np4) {
                  if (d0 + 16 * np4 < hd_v) {
                    uint32_t bv[4];
                    ldmatrix_x4_trans(
                        bv, Vt + ((mi & 1) * 8 + r8) * K5P_LDK + d0 + 16 * np4 + (mi >> 1) * 8);
#pragma unroll
                    for (int mt = 0; mt < K5P_MT; ++mt) {
                      mma_bf16(acc[mt][2 * np4], a[mt], bv[0], bv[1]);
                      mma_bf16(acc[mt][2 * np4 + 1], a[mt], bv[2], bv[3]);
                    }
                  }
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();                  // the ring, scores and p are free for the next segment
    s0 = s1;
  }

  // this CTA's (m, l, acc) -> shared memory; the ranks' partials merged in
  // rank order by the rank that finishes each output
#pragma unroll
  for (int mt = 0; mt < K5P_MT; ++mt) {
#pragma unroll
    for (int o = 1; o <= 4; o <<= 1) lpart[mt] += __shfl_xor_sync(0xffffffffu, lpart[mt], o);
  }
  if ((tid & 7) == 0) {
#pragma unroll
    for (int mt = 0; mt < K5P_MT; ++mt) {
      lsum[prow + 16 * mt] = lpart[mt];
      mfin[prow + 16 * mt] = mrow[mt];
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: reuse it for acc
  if (d0 < hd_v) {
#pragma unroll
    for (int mt = 0; mt < K5P_MT; ++mt) {
#pragma unroll
      for (int n2 = 0; n2 < 8; ++n2) {
        float* o = Osm + (16 * mt + gq) * K5P_LDO + d0 + 8 * n2 + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[mt][n2][0], acc[mt][n2][1]);
        *reinterpret_cast<float2*>(o + 8 * K5P_LDO) = make_float2(acc[mt][n2][2], acc[mt][n2][3]);
      }
    }
  }
  px_merge<K5P_THREADS>(cluster, Osm, K5P_LDO, lsum, mfin,
                        out + (((int64_t)b * kv + h) * R + row0) * hd_v, min(K5P_ROWS, R - row0),
                        hd_v, rank, CL);
}

template <bool AMS, int MB>
static int k5p_launch_t(const void* q, const void* kpool, Planes pl, const void* block_table,
                        const void* lengths, void* out, int B, int kv, int R, int hd, int hd_v,
                        int page, int MP, int c, int g, int hb, int gw, int ksh, int cluster,
                        void* stream) {
  auto kernel = k5p_kernel<AMS, MB>;
  const size_t smem = k5p_smem_bytes();
  static bool ready = false;            // the kernel's attribute is set once
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int vec = !AMS && (hd & 7) == 0 && aligned16(kpool);
  const int qvec = (hd & 3) == 0 && aligned16(q);
  return launch_clustered(kernel, dim3(cluster * ((R + K5P_ROWS - 1) / K5P_ROWS), kv, B),
                          K5P_THREADS, smem, cluster, stream, (const float*)q,
                          (const __nv_bfloat16*)kpool, pl, (const int32_t*)block_table,
                          (const int32_t*)lengths, (float*)out, kv, R, hd, hd_v, page, MP, c, g,
                          hb, gw, ksh, vec, qvec);
}

static int k5p_check(int B, int kv, int R, int hd, int hd_v, int page, int MP, int c, int g,
                     int cluster) {
  if (hd < 1 || hd > K5P_HDP || hd_v < 1 || hd_v > K5P_HVP || hd_v > hd || page < 1 || MP < 1 ||
      c < 1 || g < 1 || R != c * g || cluster < 1 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// K2 takes heads up to 128 wide (the widest served GQA head), its row tile
// and cluster from kernels/tuning.plan_paged_attention; K3 heads up to 128,
// its cluster and score buffer from tuning.plan_paged_bf16_attention; K5p
// streams up to 288 wide with values up to 256 (MiniCPM3-4B's 256 + 32), its
// cluster from tuning.plan_paged_mla_attention. Arguments they do not take
// give cudaErrorInvalidValue.
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
                                    int g, int cluster, int cap, void* stream) {
  return k3_launch(q, k, v, block_table, lengths, out, B, kv, R, hd, page, MP, c, g, cluster,
                   cap, stream);
}

extern "C" int paged_attention_stream_ams(const void* q, const void* hi, const void* lsb,
                                          const void* sc, const void* block_table,
                                          const void* lengths, void* out, int B, int kv,
                                          int R, int hd, int hd_v, int hb, int gw, int ksh,
                                          int man_bits, int page, int MP, int c, int g,
                                          int cluster, void* stream) {
  if (B <= 0 || kv <= 0 || R <= 0) return (int)cudaSuccess;
  const int bad = k5p_check(B, kv, R, hd, hd_v, page, MP, c, g, cluster);
  if (bad) return bad;
  if (2 * hb < hd || gw < 1 || ksh < 1) return (int)cudaErrorInvalidValue;
  const Planes pl = planes(hi, lsb, sc);
  if (man_bits == 2)         // e2m2 codes
    return k5p_launch_t<true, 2>(q, nullptr, pl, block_table, lengths, out, B, kv, R, hd, hd_v,
                                 page, MP, c, g, hb, gw, ksh, cluster, stream);
  if (man_bits == 1)         // e2m1 codes
    return k5p_launch_t<true, 1>(q, nullptr, pl, block_table, lengths, out, B, kv, R, hd, hd_v,
                                 page, MP, c, g, hb, gw, ksh, cluster, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_attention_stream_bf16(const void* q, const void* k,
                                           const void* block_table, const void* lengths,
                                           void* out, int B, int kv, int R, int hd, int hd_v,
                                           int page, int MP, int c, int g, int cluster,
                                           void* stream) {
  if (B <= 0 || kv <= 0 || R <= 0) return (int)cudaSuccess;
  const int bad = k5p_check(B, kv, R, hd, hd_v, page, MP, c, g, cluster);
  if (bad) return bad;
  return k5p_launch_t<false, 0>(q, k, Planes{nullptr, nullptr, nullptr}, block_table, lengths,
                                out, B, kv, R, hd, hd_v, page, MP, c, g, 0, 1, 1, cluster,
                                stream);
}
