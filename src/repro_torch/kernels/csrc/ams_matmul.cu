// K1 and K1b: fused AMS-Quant dequantize + matmul.
//
// Replaces src/repro/kernels/ams_matmul.py: ams_matmul_padded ->
// _kernel_fp533 (K1: + _unpack_fp533, decode_codes_to_f32) and
// _kernel_planes (K1b: + _unpack_planes).
//
//   y[b, n] = (sum_k bf16(x[b, k]) * DeQ(W)[k, n]) * scale[n]
//
// K1: W is fp5.33-e2m3: each int32 word of hi[Kp/6, N] holds 6 consecutive
// K positions of one column (two 16-bit halves, each three 5-bit high parts
// plus the group's shared mantissa LSB at bit 15). K1b: the planes
// container, hi[Kp/PW, N] with PW = 32 / hi_bits codes per word and a
// separate lsb plane (see `PlanesDecode` and, for the schemes it does not
// take, `ams_matmul_planes_kernel` below).
//
// Bound: at decode (B = slots) the kernel streams 4/6 byte (fp4.25: 4.25/8)
// per weight once and does 2*B operations per weight, far below the H100's
// operations per byte, so it is bound by device-memory bytes; at prefill
// rows (B = slots * chunk = 128) the products approach the bf16
// tensor-core rate.
//
// Design (sm_90a), one kernel template `ams_matmul_mma_kernel` behind a
// decode hook per container (`Fp533Decode`; `PlanesDecode` for the planes
// of per_word 8, i.e. fp4.25, fp4.33, fp4.5 and fp4):
//  * Products on the tensor cores with swapped operands, as the TPU kernel
//    does a bf16 x bf16 -> f32 dot on the decoded lattice: mma.sync
//    m16n8k16 with A = 16 output columns x 16 K of the decoded weight and
//    B = 16 K x 8 rows of x, so 8 decode rows fill n = 8 exactly and 128
//    prefill rows take 16 n-tiles. Decoded values have at most 3 mantissa
//    bits and x is rounded to bf16, so every product is exact and the
//    result differs from the plain version only in the f32 order.
//  * The decode goes straight into A fragments (the hooks, described
//    there): 8 word rows are one k-group (48 K for fp533, 64 for the
//    planes); the thread with lane quad index t owns word rows 2t and 2t+1
//    of two adjacent columns. One 32-bit operation decodes two values of a
//    word into a bf16x2 (~16 instructions per fp533 word). The K order
//    inside the group is free as long as x's B fragments follow it; they
//    are permuted from shared loads with byte permutes.
//  * With one n-tile (decode) the k-steps of a group accumulate into
//    independent accumulator sets, so the mma.sync chain stays short.
//  * The card is filled at every projection shape by the plan of
//    kernels/tuning.plan_ams_matmul: tiles of 64 columns (32 for the
//    narrowest projections, 128 at 16 n-tiles, where one x tile then feeds
//    twice the columns) x 8*NT rows, K split on k-group boundaries over a
//    thread-block cluster of up to 8 CTAs. The CTAs' partial sums meet in
//    distributed shared memory; each rank finishes a share of the tile,
//    summing the ranks' partials in rank order (deterministic: no atomics),
//    and applies scale[n] once.
//  * Bytes in flight: a ring of 4 stages of word rows (with the planes,
//    the lsb rows they take their LSBs from: a rank whose split ends inside
//    an lsb row reads that row, as the next rank does) and x's matching K
//    slice, 16-byte cp.async for the weights (4 bytes at ragged N) and the
//    widest x copy its row stride allows; three stages stay in flight while
//    one is decoded (~48 KB per CTA at decode for fp533, ~54 KB for the
//    planes; 4 CTAs per SM).
// Shared-memory strides are padded so the fragment loads are free of bank
// conflicts (weight rows TN + 4 words, x rows = 16 (fp533) or 8 (planes)
// mod 64 bf16).
// Known limit: at decode the kernel is bound by instruction issue, not
// bytes: ~24 instructions per fp533 word (the decode, x's fragments, the
// copies), plus per-CTA fixed costs (the ring's prologue, the cluster
// reduction).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace cg = cooperative_groups;

// K1b's fixed tile (below)
#define K1_COLS 32
#define K1_WARPS 8
#define K1_ROWS 8
#define K1_CHUNK_WORDS 64

#define K1_STAGES 4

// The decode hooks: one k-group of kGroupWords packed word rows in shared
// memory -> the thread's A fragments of its kSteps k-steps, and x's
// 2 * kPerWord K positions of the thread -> the matching B fragments.
// kPerWord: K positions per word; kShare: K positions per shared-LSB group
// of a separate lsb plane that rides in the ring beside the word rows (0:
// none); kXMod: the x row stride mod 64 bf16 that keeps the fragment loads
// free of bank conflicts.
//
// fp533: the two 16-bit halves of a word have the same layout, so one
// 32-bit operation decodes value j of both halves at once, straight into a
// bf16x2 (K positions j and 3 + j of the word): for each half the bf16 bits
// S << 15 | (E << 3 | M) << 4 are 2^-126 times the e2m3 value (bias 1) for
// E > 0 and, as a subnormal bf16, for E = 0 alike; one bf16x2 multiply by
// 2^126 (exact: subnormals are kept) gives the values. The thread's 12 K
// positions (words W0 = 0..5 and W1 = 6..11) fill its k-step slots in the
// order 0 3 1 4 | 2 5 6 9 | 7 10 8 11, which x's B fragments follow.
struct Fp533Decode {
  static constexpr int kGroupWords = 8;
  static constexpr int kPerWord = 6;
  static constexpr int kSteps = 3;                  // 48 K per group
  static constexpr int kShare = 0;
  static constexpr int kXMod = 16;

  // {value j of half 0, value j of half 1} of word w, j = 0, 1, 2
  __device__ __forceinline__ static void word_pairs(uint32_t w, uint32_t* p) {
    const __nv_bfloat162 two126 = __halves2bfloat162(__ushort_as_bfloat16(0x7E80),
                                                     __ushort_as_bfloat16(0x7E80));
    const uint32_t lsb = (w >> 11) & 0x00100010u;          // shared LSB -> mantissa bit 0
    uint32_t r[3];
    r[0] = ((w << 5) & 0x01E001E0u) | ((w << 11) & 0x80008000u) | lsb;
    r[1] = (w & 0x01E001E0u) | ((w << 6) & 0x80008000u) | lsb;
    r[2] = ((w >> 5) & 0x01E001E0u) | ((w << 1) & 0x80008000u) | lsb;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&r[j]), two126);
      p[j] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }

  // ws: the group's first word row, ld: words per row, col: the thread's
  // first column (it owns col and col + 1, A rows g and g + 8); the lsb
  // arguments of the hook signature are unused (the LSB is in the word)
  __device__ __forceinline__ static void fragments(const uint32_t* ws, const uint32_t*, int ld,
                                                   int t, int col, int, int,
                                                   uint32_t (&a)[kSteps][4]) {
    const uint2 r0 = *reinterpret_cast<const uint2*>(ws + (2 * t) * ld + col);
    const uint2 r1 = *reinterpret_cast<const uint2*>(ws + (2 * t + 1) * ld + col);
    uint32_t c0[6], c1[6];               // per column: W0's pairs 0..2, W1's pairs 0..2
    word_pairs(r0.x, c0);
    word_pairs(r1.x, c0 + 3);
    word_pairs(r0.y, c1);
    word_pairs(r1.y, c1 + 3);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      a[s][0] = c0[2 * s];               // rows g (column col) and g + 8 (col + 1),
      a[s][1] = c1[2 * s];               // k slots 2t, 2t+1 and 2t+8, 2t+9
      a[s][2] = c0[2 * s + 1];
      a[s][3] = c1[2 * s + 1];
    }
  }

  // xr: x's 12 K positions of the thread (natural order, 8-byte aligned)
  __device__ __forceinline__ static void x_fragments(const __nv_bfloat16* xr,
                                                     uint32_t (&b)[kSteps][2]) {
    const uint2 q0 = *reinterpret_cast<const uint2*>(xr);
    const uint2 q1 = *reinterpret_cast<const uint2*>(xr + 4);
    const uint2 q2 = *reinterpret_cast<const uint2*>(xr + 8);
    // pairs of K positions: (0,3) (1,4) | (2,5) (6,9) | (7,10) (8,11)
    b[0][0] = __byte_perm(q0.x, q0.y, 0x7610);
    b[0][1] = __byte_perm(q0.x, q1.x, 0x5432);
    b[1][0] = __byte_perm(q0.y, q1.x, 0x7610);
    b[1][1] = __byte_perm(q1.y, q2.x, 0x7610);
    b[2][0] = __byte_perm(q1.y, q2.y, 0x5432);
    b[2][1] = __byte_perm(q2.x, q2.y, 0x7610);
  }
};

// planes with 4-bit hi fields (per_word 8): e2m2 codes whose mantissa LSB
// is shared by KS = 2, 3 or 4 K positions (fp4.5, fp4.33, fp4.25), or full
// e2m1 codes (KS = 1, fp4). Field j of a word (K position j) sits at bit
// 4j, so fields j and j + 4 are exactly 16 bits apart and one 32-bit
// shift-and-mask builds the bf16x2 of K positions j and j + 4: the field's
// low 3 bits (E and the top mantissa bit; e2m1: E and M) go to bf16 bits
// 6..8 and its sign to bit 15, the shared LSB (e2m2) to bit 5, so the bf16
// is S << 15 | (E << m | M) << (7 - m), 2^-126 times the value (bias 1 for
// both), normals and subnormals alike: one bf16x2 multiply by 2^126, as in
// fp533. The thread's 16 K positions (words W0 = 0..7 and W1 = 8..15) fill
// its k-step slots in the order 0 4 1 5 | 2 6 3 7 | 8 12 9 13 | 10 14 11 15.
// The LSB of K position p is bit (g & 31) of lsb row g >> 5, g = p / KS;
// a word's 8 positions take the bits from G0 = 8 kw / KS on (two bits of
// one lsb word for fp4.25, the same for the word's four pairs).
template <int KS>
struct PlanesDecode {
  static constexpr int kGroupWords = 8;
  static constexpr int kPerWord = 8;
  static constexpr int kSteps = 4;                  // 64 K per group
  static constexpr int kShare = KS > 1 ? KS : 0;
  static constexpr int kXMod = 8;

  // the lsb bits of word row kw (the lsb rows in shared memory start at
  // global row lr0) for columns col and col + 1, from group G0 = 8 kw / KS
  // on (b0, b1), and the word's first position's place in its group (ph)
  __device__ __forceinline__ static void lsb_bits(const uint32_t* ls, int ld, int col, int kw,
                                                  int lr0, uint32_t& b0, uint32_t& b1,
                                                  int& ph) {
    const int G0 = (8 * kw) / KS;
    ph = KS == 3 ? 8 * kw - KS * G0 : 0;             // 8 kw is a multiple of 2 and 4
    const int off = G0 & 31;
    const uint32_t* lr = ls + ((G0 >> 5) - lr0) * ld + col;
    const uint2 lo = *reinterpret_cast<const uint2*>(lr);
    b0 = lo.x >> off;
    b1 = lo.y >> off;
    if (KS == 3 && ((8 * kw + 7) / KS) >> 5 != G0 >> 5) {   // runs into the next lsb row
      const uint2 hi = *reinterpret_cast<const uint2*>(lr + ld);
      b0 |= hi.x << (32 - off);
      b1 |= hi.y << (32 - off);
    }
  }

  // {field j, field j + 4} of word w as bf16x2 values, j = 0..3
  __device__ __forceinline__ static void word_pairs(uint32_t w, uint32_t bits, int ph,
                                                    uint32_t* p) {
    const __nv_bfloat162 two126 = __halves2bfloat162(__ushort_as_bfloat16(0x7E80),
                                                     __ushort_as_bfloat16(0x7E80));
    uint32_t r[4];
    r[0] = ((w << 6) & 0x01C001C0u) | ((w << 12) & 0x80008000u);
    r[1] = ((w << 2) & 0x01C001C0u) | ((w << 8) & 0x80008000u);
    r[2] = ((w >> 2) & 0x01C001C0u) | ((w << 4) & 0x80008000u);
    r[3] = ((w >> 6) & 0x01C001C0u) | (w & 0x80008000u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (KS > 1)
        r[j] |= (((bits >> ((ph + j) / KS)) & 1u) << 5) |
                (((bits >> ((ph + j + 4) / KS)) & 1u) << 21);
      const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&r[j]), two126);
      p[j] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }

  // ws: the group's first word row (global row kw), ls: the stage's lsb
  // rows (global row lr0 first), ld: words per row, col: the thread's first
  // column (it owns col and col + 1)
  __device__ __forceinline__ static void fragments(const uint32_t* ws, const uint32_t* ls,
                                                   int ld, int t, int col, int kw, int lr0,
                                                   uint32_t (&a)[kSteps][4]) {
    const uint2 r0 = *reinterpret_cast<const uint2*>(ws + (2 * t) * ld + col);
    const uint2 r1 = *reinterpret_cast<const uint2*>(ws + (2 * t + 1) * ld + col);
    uint32_t l00 = 0u, l01 = 0u, l10 = 0u, l11 = 0u;      // [word row][column]
    int ph0 = 0, ph1 = 0;
    if constexpr (KS > 1) {
      lsb_bits(ls, ld, col, kw + 2 * t, lr0, l00, l01, ph0);
      lsb_bits(ls, ld, col, kw + 2 * t + 1, lr0, l10, l11, ph1);
    }
    uint32_t c0[8], c1[8];               // per column: W0's pairs 0..3, W1's pairs 0..3
    word_pairs(r0.x, l00, ph0, c0);
    word_pairs(r1.x, l10, ph1, c0 + 4);
    word_pairs(r0.y, l01, ph0, c1);
    word_pairs(r1.y, l11, ph1, c1 + 4);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      a[s][0] = c0[2 * s];
      a[s][1] = c1[2 * s];
      a[s][2] = c0[2 * s + 1];
      a[s][3] = c1[2 * s + 1];
    }
  }

  // xr: x's 16 K positions of the thread (natural order, 16-byte aligned)
  __device__ __forceinline__ static void x_fragments(const __nv_bfloat16* xr,
                                                     uint32_t (&b)[kSteps][2]) {
    const uint4 q0 = *reinterpret_cast<const uint4*>(xr);
    const uint4 q1 = *reinterpret_cast<const uint4*>(xr + 8);
    // pairs of K positions: (0,4) (1,5) | (2,6) (3,7) | (8,12) (9,13) | (10,14) (11,15)
    b[0][0] = __byte_perm(q0.x, q0.z, 0x5410);
    b[0][1] = __byte_perm(q0.x, q0.z, 0x7632);
    b[1][0] = __byte_perm(q0.y, q0.w, 0x5410);
    b[1][1] = __byte_perm(q0.y, q0.w, 0x7632);
    b[2][0] = __byte_perm(q1.x, q1.z, 0x5410);
    b[2][1] = __byte_perm(q1.x, q1.z, 0x7632);
    b[3][0] = __byte_perm(q1.y, q1.w, 0x5410);
    b[3][1] = __byte_perm(q1.y, q1.w, 0x7632);
  }
};

// The ring's layout per stage: RW word rows, LR lsb rows (the most a run of
// RW word rows starting on a group boundary can touch), then x's K slice
template <int WN, int NT, class Dec>
struct K1Shape {
  static constexpr int TN = 16 * WN;                         // columns per CTA
  static constexpr int BT = 8 * NT;                          // rows per CTA
  static constexpr int THREADS = 32 * WN;
  static constexpr int RW = NT >= 16 ? 8 : (NT >= 4 ? 16 : 32);   // word rows per stage
  static constexpr int LSB_K = 32 * (Dec::kShare ? Dec::kShare : 1);   // K per lsb row
  static constexpr int LR = Dec::kShare ? (RW * Dec::kPerWord + LSB_K - 1) / LSB_K + 1 : 0;
  static constexpr int WS = TN + 4;                          // words per smem weight row
  static constexpr int XK = RW * Dec::kPerWord;              // x's K positions per stage
  static constexpr int XS = XK + (((Dec::kXMod - XK) % 64) + 64) % 64;   // bf16 per x row
  static constexpr int STAGE_BYTES = (RW + LR) * WS * 4 + BT * XS * 2;
  static constexpr int RED_BYTES = TN * BT * 4;
  static constexpr int SMEM = (K1_STAGES * STAGE_BYTES > RED_BYTES) ? K1_STAGES * STAGE_BYTES
                                                                     : RED_BYTES;
};

template <int WN, int NT, int XV, class Dec>
__global__ void __launch_bounds__(32 * WN)
ams_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ hi,
                      const int32_t* __restrict__ lsb, const float* __restrict__ scale,
                      float* __restrict__ y, int B, int Kw, int N, int Lrows,
                      int split_words, int wvec) {
  using S = K1Shape<WN, NT, Dec>;
  constexpr int TN = S::TN, BT = S::BT, RW = S::RW, LR = S::LR, WS = S::WS, XS = S::XS;
  constexpr int NTH = S::THREADS, PW = Dec::kPerWord, KSTEPS = Dec::kSteps;
  extern __shared__ __align__(16) unsigned char k1_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x / CL) * TN;
  const int b0 = blockIdx.y * BT;
  const int k0 = rank * split_words;
  const int k1 = min(k0 + split_words, Kw);
  const int64_t Kx = (int64_t)Kw * PW;                       // x row stride
  const int nstage = k1 > k0 ? (k1 - k0 + RW - 1) / RW : 0;

  auto stage_w = [&](int st) {
    return reinterpret_cast<uint32_t*>(k1_smem + st * S::STAGE_BYTES);
  };
  auto stage_l = [&](int st) {
    return reinterpret_cast<uint32_t*>(k1_smem + st * S::STAGE_BYTES + RW * WS * 4);
  };
  auto stage_x = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(k1_smem + st * S::STAGE_BYTES + (RW + LR) * WS * 4);
  };
  // the lsb row of word row w's first K position
  auto lsb_row = [&](int w) { return LR ? (PW * w) / S::LSB_K : 0; };

  // The copies of a stage are fixed per thread, so their addresses are
  // worked out once: the weights' 16-byte copies (rows wr, wr + 8, ...,
  // columns wc .. wc+3) and x's copies of XV bytes. Up to 16 rows, a thread
  // keeps one row (row tid % BT, copies tid / BT, + NTH / BT, ... of its
  // XCPR), so a warp's copies cover a few rows' contiguous bytes; with more
  // rows, consecutive threads take consecutive copies of a row (tid, tid +
  // NTH, ... of the BT x XCPR).
  constexpr int WPR = TN / 4;                                // 16-byte copies per row
  const int wr = tid / WPR, wc = (tid % WPR) * 4;
  const bool wcol = n0 + wc < N;
  const int32_t* wbase = hi + (int64_t)(k0 + wr) * N + n0 + wc;
  constexpr int XPER = XV / 2;                               // bf16 per x copy
  constexpr int XCPR = RW * PW / XPER;                       // x copies per row
  constexpr int XSTEP = NTH / BT;                            // threads per x row
  constexpr int XCH = (XCPR + XSTEP - 1) / XSTEP;            // x copies per thread
  static_assert(BT <= NTH && NTH % BT == 0, "x rows per thread");
  const int xr = tid % BT, xc = tid / BT;
  const bool xrow = b0 + xr < B;
  const __nv_bfloat16* xbase = x + (int64_t)(xrow ? b0 + xr : 0) * Kx + xc * XPER;
  const int xdst = xr * XS + xc * XPER;

  // one stage: word rows [w0, w0 + RW) of the tile's columns, the lsb rows
  // they take their LSBs from, and x's K positions [PW w0, PW (w0 + RW)) of
  // the tile's rows; out of range -> zeros
  auto load = [&](int it) {
    const int slot = it % K1_STAGES;
    const int w0 = k0 + it * RW;
    uint32_t* ws = stage_w(slot);
    if (wvec == 16) {
      const int32_t* wp = wbase + (int64_t)it * RW * N;
#pragma unroll
      for (int u = 0; u < RW / 8; ++u) {
        const bool ok = (w0 + wr + 8 * u < k1) && wcol;
        cp_async16(ws + (wr + 8 * u) * WS + wc, ok ? (const void*)(wp + (int64_t)u * 8 * N)
                                                   : (const void*)hi, ok);
      }
    } else {
      for (int i = tid; i < RW * TN; i += NTH) {
        const int r = i / TN, c = i - r * TN;
        const bool ok = (w0 + r < k1) && (n0 + c < N);
        cp_async_bytes<4>(ws + r * WS + c,
                       ok ? (const void*)(hi + (int64_t)(w0 + r) * N + n0 + c) : (const void*)hi,
                       ok);
      }
    }
    if (LR) {
      uint32_t* ls = stage_l(slot);
      const int lr0 = lsb_row(w0);
      if (wvec == 16) {
        for (int i = tid; i < LR * WPR; i += NTH) {
          const int r = i / WPR, c = (i - r * WPR) * 4;
          const bool ok = (lr0 + r < Lrows) && (n0 + c < N);
          cp_async16(ls + r * WS + c,
                     ok ? (const void*)(lsb + (int64_t)(lr0 + r) * N + n0 + c)
                        : (const void*)lsb, ok);
        }
      } else {
        for (int i = tid; i < LR * TN; i += NTH) {
          const int r = i / TN, c = i - r * TN;
          const bool ok = (lr0 + r < Lrows) && (n0 + c < N);
          cp_async_bytes<4>(ls + r * WS + c,
                            ok ? (const void*)(lsb + (int64_t)(lr0 + r) * N + n0 + c)
                               : (const void*)lsb, ok);
        }
      }
    }
    const int kbeg = PW * w0, kend = PW * k1;
    if (BT <= 16) {
      __nv_bfloat16* xs = stage_x(slot) + xdst;
      const __nv_bfloat16* xp = xbase + kbeg;
#pragma unroll
      for (int u = 0; u < XCH; ++u) {
        const int c = xc + u * XSTEP;
        if (XCPR % XSTEP == 0 || c < XCPR) {
          const bool ok = xrow && (kbeg + c * XPER < kend);
          cp_async_bytes<XV>(xs + u * XSTEP * XPER,
                           ok ? (const void*)(xp + u * XSTEP * XPER) : (const void*)x, ok);
        }
      }
    } else {
      __nv_bfloat16* xs = stage_x(slot);
#pragma unroll
      for (int u = 0; u < (BT * XCPR + NTH - 1) / NTH; ++u) {
        const int i = tid + u * NTH;
        if ((BT * XCPR) % NTH == 0 || i < BT * XCPR) {
          const int r = i / XCPR, k = (i % XCPR) * XPER;
          const bool ok = (b0 + r < B) && (kbeg + k < kend);
          cp_async_bytes<XV>(xs + r * XS + k,
                           ok ? (const void*)(x + (b0 + r) * Kx + kbeg + k) : (const void*)x,
                           ok);
        }
      }
    }
  };

  // NA accumulator sets, one per k-step class (s % NA): with few n-tiles
  // this breaks the chain of dependent mma.sync through one accumulator
  constexpr int NA = NT == 1 ? KSTEPS : (NT == 2 ? 2 : 1);
  float acc[NA][NT][4];
#pragma unroll
  for (int u = 0; u < NA; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

#pragma unroll 1
  for (int it = 0; it < K1_STAGES - 1; ++it) {
    if (it < nstage) load(it);
    cp_async_commit();
  }
  for (int it = 0; it < nstage; ++it) {
    cp_async_wait<K1_STAGES - 2>();
    __syncthreads();                  // stage it landed; stage it - 1 fully read
    if (it + K1_STAGES - 1 < nstage) load(it + K1_STAGES - 1);
    cp_async_commit();
    const uint32_t* ws = stage_w(it % K1_STAGES);
    const uint32_t* ls = stage_l(it % K1_STAGES);
    const __nv_bfloat16* xs = stage_x(it % K1_STAGES);
    const int w0 = k0 + it * RW;
    const int lr0 = lsb_row(w0);
#pragma unroll
    for (int gr = 0; gr < RW / Dec::kGroupWords; ++gr) {
      if (w0 + gr * Dec::kGroupWords >= k1) break;
      uint32_t a[KSTEPS][4];
      Dec::fragments(ws + gr * Dec::kGroupWords * WS, ls, WS, t, warp * 16 + 2 * g,
                     w0 + gr * Dec::kGroupWords, lr0, a);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bx[KSTEPS][2];
        Dec::x_fragments(xs + (8 * j + g) * XS + gr * Dec::kGroupWords * PW + 2 * PW * t, bx);
#pragma unroll
        for (int s = 0; s < KSTEPS; ++s) mma_bf16(acc[s % NA][j], a[s], bx[s][0], bx[s][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: reuse it for the partials

  // partials red[col][row]: C row g <-> column 2g, row g + 8 <-> column 2g + 1
  float* red = reinterpret_cast<float*>(k1_smem);
  const int cl = warp * 16 + 2 * g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = acc[0][j][e];
#pragma unroll
      for (int u = 1; u < NA; ++u) v[e] += acc[u][j][e];
    }
    const int r = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(red + cl * BT + r) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(red + (cl + 1) * BT + r) = make_float2(v[2], v[3]);
  }
  cluster.sync();
  // rank q finishes every CL-th run of NTH (column, 4 rows) cells of the tile
  // (column fastest): all the ranks' partials loaded first, then summed in
  // rank order
  for (int e = tid + rank * NTH; e < TN * (BT / 4); e += CL * NTH) {
    const int r4 = e / TN, c = e - r4 * TN;
    float4 part[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < CL)
        part[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + c * BT +
                                                   4 * r4);
    float4 s = part[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      if (i < CL) {
        s.x += part[i].x;
        s.y += part[i].y;
        s.z += part[i].z;
        s.w += part[i].w;
      }
    }
    const int n = n0 + c;
    if (n < N) {
      const float sc = scale[n];
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = b0 + 4 * r4 + i;
        if (b < B) y[(int64_t)b * N + n] = sv[i] * sc;
      }
    }
  }
  cluster.sync();                     // no CTA leaves while its partials are read
}

template <int WN, int NT, int XV, class Dec>
static int launch_mma(const void* x, const void* hi, const void* lsb, const void* scale,
                      void* y, int B, int Kw, int N, int Lrows, int cluster, int split_words,
                      cudaStream_t stream) {
  using S = K1Shape<WN, NT, Dec>;
  auto kernel = ams_matmul_mma_kernel<WN, NT, XV, Dec>;
  static bool configured = false;         // once per instantiation
  if (S::SMEM > 48 * 1024 && !configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const bool w16 = N % 4 == 0 && (uintptr_t)hi % 16 == 0 &&
                   (S::LR == 0 || (uintptr_t)lsb % 16 == 0);
  const int wvec = w16 ? 16 : 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + S::TN - 1) / S::TN) * cluster, (B + S::BT - 1) / S::BT, 1);
  cfg.blockDim = dim3(S::THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const __nv_bfloat16*)x, (const int32_t*)hi, (const int32_t*)lsb,
      (const float*)scale, (float*)y, B, Kw, N, Lrows, split_words, wvec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x's copies: the widest of 16, 8 or 4 bytes its row stride (12 Kw bytes)
// and base allow
template <int WN, int NT>
static int launch_fp533_xv(const void* x, const void* hi, const void* scale, void* y, int B,
                           int Kw, int N, int cluster, int split_words, cudaStream_t s) {
  const uintptr_t xp = (uintptr_t)x;
  const int64_t row_bytes = (int64_t)Kw * 12;
  if (row_bytes % 16 == 0 && xp % 16 == 0)
    return launch_mma<WN, NT, 16, Fp533Decode>(x, hi, nullptr, scale, y, B, Kw, N, 0, cluster,
                                               split_words, s);
  if (row_bytes % 8 == 0 && xp % 8 == 0)
    return launch_mma<WN, NT, 8, Fp533Decode>(x, hi, nullptr, scale, y, B, Kw, N, 0, cluster,
                                              split_words, s);
  return launch_mma<WN, NT, 4, Fp533Decode>(x, hi, nullptr, scale, y, B, Kw, N, 0, cluster,
                                            split_words, s);
}

// A plan that does not cover Kw with k-group-aligned splits, one per rank,
// is refused
static bool bad_plan(int Kw, int cluster, int split_words) {
  return Kw < 1 || cluster < 1 || cluster > 8 || split_words < 1 || split_words % 8 ||
         (int64_t)cluster * split_words < Kw || (int64_t)(cluster - 1) * split_words >= Kw;
}

// the tiles tuning.plan_ams_matmul chooses: 32 or 64 columns up to 8
// n-tiles, 128 columns at 16
#define K1_TILES(LAUNCH)                                                                  \
  switch (tn * 100 + nt) {                                                                \
    case 3201: return LAUNCH(2, 1);                                                       \
    case 3202: return LAUNCH(2, 2);                                                       \
    case 3204: return LAUNCH(2, 4);                                                       \
    case 3208: return LAUNCH(2, 8);                                                       \
    case 6401: return LAUNCH(4, 1);                                                       \
    case 6402: return LAUNCH(4, 2);                                                       \
    case 6404: return LAUNCH(4, 4);                                                       \
    case 6408: return LAUNCH(4, 8);                                                       \
    case 12816: return LAUNCH(8, 16);                                                     \
    default: return (int)cudaErrorInvalidValue;                                           \
  }

// The plan (tn, nt, cluster, split_words) comes from
// kernels/tuning.plan_ams_matmul.
extern "C" int ams_matmul_fp533(const void* x, const void* hi, const void* scale, void* y,
                                int B, int Kw, int N, int tn, int nt, int cluster,
                                int split_words, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (bad_plan(Kw, cluster, split_words)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FP533_TILE(WN_, NT_) \
  launch_fp533_xv<WN_, NT_>(x, hi, scale, y, B, Kw, N, cluster, split_words, s)
  K1_TILES(FP533_TILE)
#undef FP533_TILE
}

template <int KS>
static int launch_planes_mma(const void* x, const void* hi, const void* lsb, const void* scale,
                             void* y, int B, int Kw, int N, int Lrows, int tn, int nt,
                             int cluster, int split_words, cudaStream_t s) {
#define PLANES_TILE(WN_, NT_)                                                               \
  launch_mma<WN_, NT_, 16, PlanesDecode<KS>>(x, hi, lsb, scale, y, B, Kw, N, Lrows, cluster, \
                                             split_words, s)
  K1_TILES(PLANES_TILE)
#undef PLANES_TILE
}

// K1b on the tensor cores: the planes of per_word 8 (4-bit hi fields) with
// k = 1 (e2m1 codes) or k = 2, 3, 4 (e2m2 codes, lsb [Lrows, N]); x's rows
// (16 Kw bytes) must start 16-byte aligned. The plan comes from
// kernels/tuning.plan_ams_matmul(container="planes").
extern "C" int ams_matmul_planes_mma(const void* x, const void* hi, const void* lsb,
                                     const void* scale, void* y, int B, int Kw, int N,
                                     int Lrows, int k, int tn, int nt, int cluster,
                                     int split_words, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (bad_plan(Kw, cluster, split_words) || (uintptr_t)x % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch_planes_mma<1>(x, hi, lsb, scale, y, B, Kw, N, Lrows, tn, nt, cluster,
                                        split_words, s);
    case 2: return launch_planes_mma<2>(x, hi, lsb, scale, y, B, Kw, N, Lrows, tn, nt, cluster,
                                        split_words, s);
    case 3: return launch_planes_mma<3>(x, hi, lsb, scale, y, B, Kw, N, Lrows, tn, nt, cluster,
                                        split_words, s);
    case 4: return launch_planes_mma<4>(x, hi, lsb, scale, y, B, Kw, N, Lrows, tn, nt, cluster,
                                        split_words, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K1b on CUDA cores: the planes container for the schemes `PlanesDecode`
// does not take (hi fields not 16 bits apart: per_word 4, 5 and 6, i.e.
// fp8, fp6-e2m3, fp6-e3m2, fp5-e2m2 and the planes of fp5.33-e2m3).
//
// hi[Kp/PW, N] packs PW = 32 / hi_bits codes of one column per int32 word
// (field j of word kw at bit j * hi_bits holds K position kw * PW + j);
// with k > 1 the field is the code's high part and lsb[Kp/(32k), N] holds
// one shared mantissa LSB per k-group, 32 groups per word (group g = kpos/k
// at bit g & 31 of row g >> 5). Codes are decoded with the generic
// sign/exponent/mantissa sequence of decode_codes_to_f32 for the format's
// (man_bits, exp_bits, bias): normals from their IEEE bits, subnormals as
// M * 2^(1 - bias - m). Every base format has at most 3 mantissa bits, so
// the values are exact in bf16 and bf16 x value is exact in f32: the kernel
// differs from its plain version only by summation order.
//
// Bound as K1: bytes at decode; CUDA-core FMAs at prefill rows. One block = 32 columns x 8 rows,
// warps take interleaved words of a K chunk, lane n reads hi[kw, n0 + n].
// The chunk's lsb words (one serves 32k K positions) are staged once per
// block in shared memory beside x.

#define K1B_LSB_ROWS 12   // lsb rows a chunk can touch (see the static_assert)

struct FpFormat {
  int man_bits, man_mask, exp_mask, sign_shift, norm_off;
  float sub_scale;  // 2^(1 - bias - man_bits)
};

__device__ __forceinline__ float decode_code(int code, const FpFormat& f) {
  const int M = code & f.man_mask;
  const int E = (code >> f.man_bits) & f.exp_mask;
  const float v = (E == 0) ? (float)M * f.sub_scale
                           : __int_as_float(((E + f.norm_off) << 23) | (M << (23 - f.man_bits)));
  return ((code >> f.sign_shift) & 1) ? -v : v;
}

template <int PW, int KS>
__global__ void __launch_bounds__(K1_WARPS * 32)
ams_matmul_planes_kernel(const __nv_bfloat16* __restrict__ x,
                         const int32_t* __restrict__ hi,
                         const int32_t* __restrict__ lsb,
                         const float* __restrict__ scale,
                         float* __restrict__ y, int B, int Kw, int N, int hb,
                         FpFormat fmt) {
  static_assert(KS == 1 || K1_CHUNK_WORDS * PW / (32 * KS) + 2 <= K1B_LSB_ROWS,
                "a chunk's lsb rows must fit the staging buffer");
  __shared__ float xs[K1_ROWS][K1_CHUNK_WORDS * PW];
  __shared__ uint32_t ls[K1B_LSB_ROWS][K1_COLS];
  __shared__ float red[K1_WARPS][K1_ROWS][K1_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * K1_COLS + lane;
  const int b0 = blockIdx.y * K1_ROWS;
  const int64_t Kp = (int64_t)Kw * PW;
  const uint32_t hmask = (1u << hb) - 1u;
  float acc[K1_ROWS];
#pragma unroll
  for (int r = 0; r < K1_ROWS; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < Kw; c0 += K1_CHUNK_WORDS) {
    const int cw = min(K1_CHUNK_WORDS, Kw - c0);
    const int ck = cw * PW;
    const int lr0 = (c0 * PW) / (32 * KS);
    __syncthreads();
    for (int i = threadIdx.x; i < K1_ROWS * ck; i += blockDim.x) {
      const int r = i / ck, kk = i - r * ck;
      const int b = b0 + r;
      xs[r][kk] = (b < B) ? __bfloat162float(x[(int64_t)b * Kp + (int64_t)c0 * PW + kk])
                          : 0.f;
    }
    if (KS > 1) {
      const int nl = ((c0 + cw) * PW - 1) / (32 * KS) - lr0 + 1;
      for (int i = threadIdx.x; i < nl * K1_COLS; i += blockDim.x) {
        const int r = i / K1_COLS, cc = i - r * K1_COLS;
        const int col = blockIdx.x * K1_COLS + cc;
        ls[r][cc] = (col < N) ? (uint32_t)lsb[(int64_t)(lr0 + r) * N + col] : 0u;
      }
    }
    __syncthreads();
    if (n < N) {
      for (int w = warp; w < cw; w += K1_WARPS) {
        const uint32_t word = (uint32_t)hi[(int64_t)(c0 + w) * N + n];
        const int kpos0 = (c0 + w) * PW;
        uint32_t lw0 = 0u, lw1 = 0u;
        int row0 = 0;
        if (KS > 1) {       // a word's fields span at most two lsb words
          row0 = (kpos0 / KS) >> 5;
          lw0 = ls[row0 - lr0][lane];
          lw1 = ls[(((kpos0 + PW - 1) / KS) >> 5) - lr0][lane];
        }
        float v[PW];
#pragma unroll
        for (int j = 0; j < PW; ++j) {
          int code = (int)((word >> (j * hb)) & hmask);
          if (KS > 1) {
            const int g = (kpos0 + j) / KS;
            const uint32_t lw = ((g >> 5) == row0) ? lw0 : lw1;
            code = (code << 1) | (int)((lw >> (g & 31)) & 1u);
          }
          v[j] = decode_code(code, fmt);
        }
#pragma unroll
        for (int r = 0; r < K1_ROWS; ++r) {
          const float* xr = &xs[r][w * PW];
#pragma unroll
          for (int j = 0; j < PW; ++j) acc[r] = fmaf(xr[j], v[j], acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < K1_ROWS; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = threadIdx.x / K1_COLS;
  const int c = threadIdx.x % K1_COLS;
  const int on = blockIdx.x * K1_COLS + c;
  const int ob = b0 + r;
  if (on < N && ob < B) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) s += red[w][r][c];
    y[(int64_t)ob * N + on] = s * scale[on];
  }
}

template <int PW, int KS>
static int launch_planes(const void* x, const void* hi, const void* lsb, const void* scale,
                         void* y, int B, int Kw, int N, int hb, FpFormat fmt,
                         cudaStream_t stream) {
  dim3 grid((N + K1_COLS - 1) / K1_COLS, (B + K1_ROWS - 1) / K1_ROWS);
  ams_matmul_planes_kernel<PW, KS><<<grid, K1_WARPS * 32, 0, stream>>>(
      (const __nv_bfloat16*)x, (const int32_t*)hi, (const int32_t*)lsb,
      (const float*)scale, (float*)y, B, Kw, N, hb, fmt);
  return (int)cudaGetLastError();
}

template <int PW>
static int launch_planes_k(int k, const void* x, const void* hi, const void* lsb,
                           const void* scale, void* y, int B, int Kw, int N, int hb,
                           FpFormat fmt, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_planes<PW, 1>(x, hi, lsb, scale, y, B, Kw, N, hb, fmt, stream);
    case 2: return launch_planes<PW, 2>(x, hi, lsb, scale, y, B, Kw, N, hb, fmt, stream);
    case 3: return launch_planes<PW, 3>(x, hi, lsb, scale, y, B, Kw, N, hb, fmt, stream);
    case 4: return launch_planes<PW, 4>(x, hi, lsb, scale, y, B, Kw, N, hb, fmt, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// per_word in {4, 5, 6} (per_word 8 goes through ams_matmul_planes_mma), k
// in {1, 2, 3, 4}; anything else is refused with cudaErrorInvalidValue (the
// Python wrapper checks first).
extern "C" int ams_matmul_planes(const void* x, const void* hi, const void* lsb,
                                 const void* scale, void* y, int B, int Kw, int N,
                                 int per_word, int hi_bits, int k, int man_bits,
                                 int exp_bits, int bias, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (hi_bits * per_word > 32) return (int)cudaErrorInvalidValue;
  FpFormat fmt;
  fmt.man_bits = man_bits;
  fmt.man_mask = (1 << man_bits) - 1;
  fmt.exp_mask = (1 << exp_bits) - 1;
  fmt.sign_shift = man_bits + exp_bits;
  fmt.norm_off = 127 - bias;
  fmt.sub_scale = ldexpf(1.0f, 1 - bias - man_bits);
  cudaStream_t s = (cudaStream_t)stream;
  switch (per_word) {
    case 4: return launch_planes_k<4>(k, x, hi, lsb, scale, y, B, Kw, N, hi_bits, fmt, s);
    case 5: return launch_planes_k<5>(k, x, hi, lsb, scale, y, B, Kw, N, hi_bits, fmt, s);
    case 6: return launch_planes_k<6>(k, x, hi, lsb, scale, y, B, Kw, N, hi_bits, fmt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
