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
// container, hi[Kp/PW, N] with PW = 32 / HB codes of HB bits per word (field
// j of word kw at bit HB * j holds K position PW * kw + j); with a shared
// LSB (k > 1) the field is the code's high part and lsb[Kp/(32k), N] holds
// one LSB per k-group (group g = position / k at bit g & 31 of row g >> 5).
//
// Bound: at decode (B = slots) the kernel streams HB/8 byte (fp533: 5.33/8;
// shared LSBs add 1/(8k)) per weight once and does 2*B operations per
// weight, far below the H100's operations per byte, so it is bound by
// device-memory bytes; at prefill rows (B = slots * chunk = 128) the
// products approach the bf16 tensor-core rate.
//
// Design (sm_90a), one kernel template `ams_matmul_mma_kernel` behind a
// decode hook per container: `Fp533Decode`, and `PlanesDecode<HB, KS, M>`
// for the planes of every hi width HB = 4..8, shared-LSB group KS = 1..4
// and base format of M mantissa bits (fp4.25 / 4.33 / 4.5 / fp4: HB 4; fp5
// and fp5.33 as planes: HB 5; fp6: HB 6; fp8: HB 8; the other base formats'
// layouts alike):
//  * Products on the tensor cores with swapped operands, as the TPU kernel
//    does a bf16 x bf16 -> f32 dot on the decoded lattice: mma.sync
//    m16n8k16 with A = 16 output columns x 16 K of the decoded weight and
//    B = 16 K x 8 rows of x, so 8 decode rows fill n = 8 exactly and 128
//    prefill rows take 16 n-tiles. Decoded values have at most 3 mantissa
//    bits and x is rounded to bf16, so every product is exact and the
//    result differs from the plain version only in the f32 order.
//  * The decode goes straight into A fragments (the hooks, described
//    there): a k-group is one block of 8 word rows (two for PW = 5, whose
//    two words hold 10 K, not a multiple of the 4 K a fragment takes per
//    column and k-step); the thread with lane quad index t owns word rows 2t
//    and 2t+1 of each block, of two adjacent columns. A few 32-bit
//    operations decode two values of a word into a bf16x2. The K order
//    inside the group is free as long as x's B fragments follow it; they are
//    permuted from shared loads with byte permutes (`x_pairs`).
//  * A row's sum has one association whatever the tile height: the
//    k-steps of each k-group chain into a fresh f32 part, added to the
//    row's sum in group order, and the K split comes from the plan's
//    one-row-tile cluster (kernels/tuning.plan_ams_matmul). So a row gets
//    the same bits in a tick of any width, and at decode the groups'
//    chains are independent, so the mma.sync chain stays short.
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
//    widest x copy its row stride allows (the planes take x's rows at a
//    stride of a multiple of 8 bf16, so 16 bytes; a copy that runs past the
//    split's last K position reads only up to it and zero-fills the rest);
//    three stages stay in flight while one is decoded (~48 KB per CTA at
//    decode for fp533, ~54 KB for the 4-bit planes; 4 CTAs per SM).
// Shared-memory strides are padded so the fragment loads are free of bank
// conflicts (weight rows TN + 4 words, x rows by each hook's kXMod).
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

#define K1_STAGES 4

// x global -> shared: XV bytes, of which the first `bytes` are read and the
// rest zero-filled (0: all zeros; src is then not read)
template <int XV>
__device__ __forceinline__ void cp_async_x(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (XV == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(XV), "r"(bytes));
}

// x's pairs of K positions for the pair order of the hooks below, from the
// thread's 2 * PW K positions of one block in natural order (xr: 16-byte
// aligned for PW 8 and 4, 8 for PW 6, 4 for PW 5): bf16x2 of (lo, hi)
template <int PW>
__device__ __forceinline__ void x_pairs(const __nv_bfloat16* xr, uint32_t* p) {
  if constexpr (PW == 8) {
    const uint4 q0 = *reinterpret_cast<const uint4*>(xr);
    const uint4 q1 = *reinterpret_cast<const uint4*>(xr + 8);
    // (0,4) (1,5) (2,6) (3,7) (8,12) (9,13) (10,14) (11,15)
    p[0] = __byte_perm(q0.x, q0.z, 0x5410);
    p[1] = __byte_perm(q0.x, q0.z, 0x7632);
    p[2] = __byte_perm(q0.y, q0.w, 0x5410);
    p[3] = __byte_perm(q0.y, q0.w, 0x7632);
    p[4] = __byte_perm(q1.x, q1.z, 0x5410);
    p[5] = __byte_perm(q1.x, q1.z, 0x7632);
    p[6] = __byte_perm(q1.y, q1.w, 0x5410);
    p[7] = __byte_perm(q1.y, q1.w, 0x7632);
  } else if constexpr (PW == 6) {
    const uint2 q0 = *reinterpret_cast<const uint2*>(xr);
    const uint2 q1 = *reinterpret_cast<const uint2*>(xr + 4);
    const uint2 q2 = *reinterpret_cast<const uint2*>(xr + 8);
    // (0,3) (1,4) (2,5) (6,9) (7,10) (8,11)
    p[0] = __byte_perm(q0.x, q0.y, 0x7610);
    p[1] = __byte_perm(q0.x, q1.x, 0x5432);
    p[2] = __byte_perm(q0.y, q1.x, 0x7610);
    p[3] = __byte_perm(q1.y, q2.x, 0x7610);
    p[4] = __byte_perm(q1.y, q2.y, 0x5432);
    p[5] = __byte_perm(q2.x, q2.y, 0x7610);
  } else if constexpr (PW == 5) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(xr);
    const uint32_t u0 = u[0], u1 = u[1], u2 = u[2], u3 = u[3], u4 = u[4];
    // (0,3) (1,4) (5,8) (6,9) (2,7)
    p[0] = __byte_perm(u0, u1, 0x7610);
    p[1] = __byte_perm(u0, u2, 0x5432);
    p[2] = __byte_perm(u2, u4, 0x5432);
    p[3] = __byte_perm(u3, u4, 0x7610);
    p[4] = __byte_perm(u1, u3, 0x7610);
  } else {
    static_assert(PW == 4, "x_pairs: PW in 4, 5, 6, 8");
    const uint4 q = *reinterpret_cast<const uint4*>(xr);
    // (0,2) (1,3) (4,6) (5,7)
    p[0] = __byte_perm(q.x, q.y, 0x5410);
    p[1] = __byte_perm(q.x, q.y, 0x7632);
    p[2] = __byte_perm(q.z, q.w, 0x5410);
    p[3] = __byte_perm(q.z, q.w, 0x7632);
  }
}

// The decode hooks: one k-group of kGroupWords packed word rows in shared
// memory -> the thread's A fragments of its kSteps k-steps, and x's K
// positions of the thread -> the matching B fragments. kPerWord: K
// positions per word; kShare: K positions per shared-LSB group of a
// separate lsb plane that rides in the ring beside the word rows (0: none);
// kXMod, kXPeriod: the x row stride mod kXPeriod bf16 that keeps the
// fragment loads free of bank conflicts.
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
  static constexpr int kXPeriod = 64;

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

  // xg: x's K positions of the group in the thread's row (8-byte aligned)
  __device__ __forceinline__ static void x_fragments(const __nv_bfloat16* xg, int t,
                                                     uint32_t (&b)[kSteps][2]) {
    uint32_t p[2 * kSteps];
    x_pairs<6>(xg + 12 * t, p);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      b[s][0] = p[2 * s];
      b[s][1] = p[2 * s + 1];
    }
  }
};

// The planes of HB-bit fields, PW = 32 / HB per word, shared-LSB group KS
// (1: whole codes), of the base format with M mantissa bits and HB - M - 1
// (KS = 1) or HB - M (KS > 1) exponent bits at the standard bias 2^(e-1) -
// 1. The value trick of fp533 holds for every base format: the bf16 bits
// S << 15 | (E << M | Mant) << (7 - M) are 2^-(127 - bias) times the code's
// value, normals and subnormals alike, so one bf16x2 multiply by
// 2^(127 - bias) gives two exact values. A field holds the code's magnitude
// E << M | Mant (KS = 1) or its high part (KS > 1, the LSB from the lsb
// plane) in its low HB - 1 bits and the sign above them. The format is a
// template constant, so every shift and mask is an immediate.
//  * Pairs 16 bits apart: field j pairs with field j + kLift. Where the two
//    are not 16 bits apart already (HB 4: fields j, j + 4; HB 8: j, j + 2)
//    one lift moves the fields from kLift on into the upper half at the
//    offsets of fields 0, 1, ... (HB 5: + 1 bit, as fp533's halves; HB 7:
//    + 2; HB 6: - 2, fields 3, 4 under fields 0, 1). Each pair is then two
//    shifts and two masks: the magnitudes to bf16 bit kDm, the signs to
//    15; with KS > 1 the pair's two LSBs to bit kDst. HB 6 leaves field 2,
//    which pairs with field 2 of the block's other word.
//  * Words per thread: the thread's two words of a block give 2 PW K
//    positions, PW pairs per column; a k-step takes two. PW 5 gives 5, so
//    its k-group is two blocks (16 word rows, 80 K, 5 k-steps).
//  * Shared LSBs: the LSB of K position p is bit (g & 31) of lsb row g >>
//    5, g = p / KS; a word's PW positions take the bits from G0 = PW kw / KS
//    on, the first at phase ph = PW kw - KS G0 of its group (0 wherever KS
//    divides PW), and may run into the next lsb row.
// The thread's pairs, per block of words W0 = 0..PW-1, W1 = PW..2PW-1 in
// x's order: W0's (j, j + kLift), W1's, then HB 6's (2, PW + 2); x's B
// fragments follow (`x_pairs`).
template <int HB, int KS, int M>
struct PlanesDecode {
  static constexpr int E = HB - M - (KS == 1 ? 1 : 0);      // exponent bits
  // the base formats of core/formats.py: e2m1, e2m2, e2m3, e3m2, e3m3, e4m3, e5m2
  static constexpr bool kFormat = HB >= 4 && HB <= 8 && KS >= 1 && KS <= 4 &&
                                  ((E == 2 && M >= 1 && M <= 3) || (E == 3 && M >= 2 && M <= 3) ||
                                   (E == 4 && M == 3) || (E == 5 && M == 2));
  static constexpr int kBias = kFormat ? (1 << (E - 1)) - 1 : 0;
  static constexpr int kDst = 7 - M;                         // bf16 bit of the mantissa LSB
  static constexpr int kDm = kDst + (KS > 1 ? 1 : 0);        // ... of the field's magnitude
  static constexpr uint32_t kMag2 = (((1u << (HB - 1)) - 1u) * 0x00010001u) << kDm;
  static constexpr int PW = 32 / HB;
  static constexpr int kPerWord = PW;
  static constexpr int kBlocks = PW == 5 ? 2 : 1;            // 8-row blocks per k-group
  static constexpr int kGroupWords = 8 * kBlocks;
  static constexpr int kSteps = kBlocks * PW / 2;
  static constexpr int kShare = KS > 1 ? KS : 0;
  static constexpr int kXMod = PW == 4 ? 32 : (PW == 6 ? 16 : 8);
  static constexpr int kXPeriod = PW == 5 ? 16 : 64;
  static constexpr int kLift = PW == 8 ? 4 : (PW == 4 ? 2 : 3);
  static constexpr int kShift = 16 - HB * kLift;             // the lift, in bits
  static constexpr int kPairs = PW - kLift;                  // pairs within a word
  static constexpr bool kPhased = KS > 1 && PW % KS != 0;
  static constexpr bool kMayCross = KS > 1 && !(PW % KS == 0 && 32 % (PW / KS) == 0);

  __device__ __forceinline__ static uint32_t lift(uint32_t w) {
    if constexpr (kShift == 0)
      return w;
    else if constexpr (kShift > 0)
      return (w & 0xFFFFu) | ((w << kShift) & 0xFFFF0000u);
    else
      return (w & 0xFFFFu) | ((w >> -kShift) & 0xFFFF0000u);
  }

  __device__ __forceinline__ static uint32_t shift(uint32_t v, int s) {   // s > 0: right
    return s >= 0 ? v >> s : v << -s;
  }

  // the bf16x2 bits (before the LSBs and the multiply) of the fields at
  // bits p and p + 16 of v (p is a constant once the callers' loops unroll)
  __device__ __forceinline__ static uint32_t pair_bits(uint32_t v, int p) {
    return (shift(v, p - kDm) & kMag2) | (shift(v, p + HB - 16) & 0x80008000u);
  }

  // the shared LSBs of the pair's positions ja (of a word with lsb bits ba
  // from its phase pha) and jb, at bf16 bits kDst and kDst + 16
  __device__ __forceinline__ static uint32_t lsb_pair(uint32_t ba, int pha, int ja, uint32_t bb,
                                                      int phb, int jb) {
    return (((ba >> ((pha + ja) / KS)) & 1u) | (((bb >> ((phb + jb) / KS)) & 1u) << 16)) << kDst;
  }

  // the lsb bits of word row kw (the lsb rows in shared memory start at
  // global row lr0) for columns col and col + 1, from group G0 = PW kw / KS
  // on (b0, b1), and the word's first position's place in its group (ph)
  __device__ __forceinline__ static void lsb_bits(const uint32_t* ls, int ld, int col, int kw,
                                                  int lr0, uint32_t& b0, uint32_t& b1,
                                                  int& ph) {
    const int G0 = (PW * kw) / KS;
    ph = kPhased ? PW * kw - KS * G0 : 0;
    const int off = G0 & 31;
    const uint32_t* lr = ls + ((G0 >> 5) - lr0) * ld + col;
    const uint2 lo = *reinterpret_cast<const uint2*>(lr);
    b0 = lo.x >> off;
    b1 = lo.y >> off;
    if (kMayCross && ((PW * kw + PW - 1) / KS) >> 5 != G0 >> 5) {   // runs into the next row
      const uint2 hi = *reinterpret_cast<const uint2*>(lr + ld);
      b0 |= hi.x << (32 - off);
      b1 |= hi.y << (32 - off);
    }
  }

  // the PW values of words w0 (row 2t of a block) and w1 (row 2t + 1) of one
  // column as bf16x2 pairs, in x's order
  __device__ __forceinline__ static void block_pairs(uint32_t w0, uint32_t w1, uint32_t b0,
                                                     uint32_t b1, int ph0, int ph1, uint32_t* p) {
    const __nv_bfloat16 m = __ushort_as_bfloat16((unsigned short)((254 - kBias) << 7));
    const __nv_bfloat162 mul = __halves2bfloat162(m, m);       // 2^(127 - bias)
    const uint32_t v0 = lift(w0), v1 = lift(w1);
    uint32_t r[PW];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      r[j] = pair_bits(v0, HB * j);
      r[kPairs + j] = pair_bits(v1, HB * j);
      if constexpr (KS > 1) {
        r[j] |= lsb_pair(b0, ph0, j, b0, ph0, j + kLift);
        r[kPairs + j] |= lsb_pair(b1, ph1, j, b1, ph1, j + kLift);
      }
    }
#pragma unroll
    for (int j = kPairs; j < kLift; ++j) {               // HB 6: field 2 of w0 and w1
      const uint32_t c = ((w0 >> (HB * j)) & 0xFFFFu) | ((w1 << (16 - HB * j)) & 0xFFFF0000u);
      r[kPairs + j] = pair_bits(c, 0);
      if constexpr (KS > 1) r[kPairs + j] |= lsb_pair(b0, ph0, j, b1, ph1, j);
    }
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&r[j]), mul);
      p[j] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }

  // ws: the group's first word row (global row kw), ls: the stage's lsb
  // rows (global row lr0 first), ld: words per row, col: the thread's first
  // column (it owns col and col + 1)
  __device__ __forceinline__ static void fragments(const uint32_t* ws, const uint32_t* ls,
                                                   int ld, int t, int col, int kw, int lr0,
                                                   uint32_t (&a)[kSteps][4]) {
    uint32_t c0[2 * kSteps], c1[2 * kSteps];      // per column: the group's pairs, x's order
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk) {
      const int r = 8 * blk + 2 * t;
      const uint2 r0 = *reinterpret_cast<const uint2*>(ws + r * ld + col);
      const uint2 r1 = *reinterpret_cast<const uint2*>(ws + (r + 1) * ld + col);
      uint32_t l00 = 0u, l01 = 0u, l10 = 0u, l11 = 0u;    // [word row][column]
      int ph0 = 0, ph1 = 0;
      if constexpr (KS > 1) {
        lsb_bits(ls, ld, col, kw + r, lr0, l00, l01, ph0);
        lsb_bits(ls, ld, col, kw + r + 1, lr0, l10, l11, ph1);
      }
      block_pairs(r0.x, r1.x, l00, l10, ph0, ph1, c0 + PW * blk);
      block_pairs(r0.y, r1.y, l01, l11, ph0, ph1, c1 + PW * blk);
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      a[s][0] = c0[2 * s];
      a[s][1] = c1[2 * s];
      a[s][2] = c0[2 * s + 1];
      a[s][3] = c1[2 * s + 1];
    }
  }

  // xg: x's K positions of the group in the thread's row (natural order)
  __device__ __forceinline__ static void x_fragments(const __nv_bfloat16* xg, int t,
                                                     uint32_t (&b)[kSteps][2]) {
    uint32_t p[2 * kSteps];
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk) x_pairs<PW>(xg + 8 * PW * blk + 2 * PW * t, p + PW * blk);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      b[s][0] = p[2 * s];
      b[s][1] = p[2 * s + 1];
    }
  }
};

// The ring's layout per stage: RW word rows (at least one k-group), LR lsb
// rows (the most a run of RW word rows starting on a group boundary can
// touch), then x's K slice
template <int WN, int NT, class Dec>
struct K1Shape {
  static constexpr int TN = 16 * WN;                         // columns per CTA
  static constexpr int BT = 8 * NT;                          // rows per CTA
  static constexpr int THREADS = 32 * WN;
  static constexpr int RW0 = NT >= 16 ? 8 : (NT >= 4 ? 16 : 32);
  static constexpr int RW = RW0 > Dec::kGroupWords ? RW0 : Dec::kGroupWords;   // word rows per stage
  static constexpr int LSB_K = 32 * (Dec::kShare ? Dec::kShare : 1);   // K per lsb row
  static constexpr int LR = Dec::kShare ? (RW * Dec::kPerWord + LSB_K - 1) / LSB_K + 1 : 0;
  static constexpr int WS = TN + 4;                          // words per smem weight row
  static constexpr int XK = RW * Dec::kPerWord;              // x's K positions per stage
  static constexpr int XS = XK + (((Dec::kXMod - XK) % Dec::kXPeriod) + Dec::kXPeriod) %
                                     Dec::kXPeriod;           // bf16 per x row
  static constexpr int STAGE_BYTES = (RW + LR) * WS * 4 + BT * XS * 2;
  static constexpr int RED_BYTES = TN * BT * 4;
  static constexpr int SMEM = (K1_STAGES * STAGE_BYTES > RED_BYTES) ? K1_STAGES * STAGE_BYTES
                                                                     : RED_BYTES;
};

// x [B, ldx] bf16 (K positions [0, PW Kw) of each row used), hi [Kw, N],
// lsb [Lrows, N] (with a shared LSB), scale [N] -> y [B, N] f32
template <int WN, int NT, int XV, class Dec>
__global__ void __launch_bounds__(32 * WN)
ams_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ hi,
                      const int32_t* __restrict__ lsb, const float* __restrict__ scale,
                      float* __restrict__ y, int B, int Kw, int N, int Lrows, int ldx,
                      int split_words, int wvec) {
  using S = K1Shape<WN, NT, Dec>;
  constexpr int TN = S::TN, BT = S::BT, RW = S::RW, LR = S::LR, WS = S::WS, XS = S::XS;
  constexpr int NTH = S::THREADS, PW = Dec::kPerWord, KSTEPS = Dec::kSteps;
  constexpr int GW = Dec::kGroupWords;
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
  const int64_t Kx = ldx;                                    // x row stride
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
  static_assert(RW % GW == 0 && (RW * PW) % XPER == 0, "a stage holds whole groups");
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
          const int n = xrow ? min(XPER, max(kend - kbeg - c * XPER, 0)) : 0;
          cp_async_x<XV>(xs + u * XSTEP * XPER, n ? (const void*)(xp + u * XSTEP * XPER)
                                                  : (const void*)x, 2 * n);
        }
      }
    } else {
      __nv_bfloat16* xs = stage_x(slot);
#pragma unroll
      for (int u = 0; u < (BT * XCPR + NTH - 1) / NTH; ++u) {
        const int i = tid + u * NTH;
        if ((BT * XCPR) % NTH == 0 || i < BT * XCPR) {
          const int r = i / XCPR, k = (i % XCPR) * XPER;
          const int n = b0 + r < B ? min(XPER, max(kend - kbeg - k, 0)) : 0;
          cp_async_x<XV>(xs + r * XS + k, n ? (const void*)(x + (b0 + r) * Kx + kbeg + k)
                                            : (const void*)x, 2 * n);
        }
      }
    }
  };

  // acc[j]: the tile's sums. Each k-group's k-steps chain into a fresh
  // part, added to acc[j] in group order: the same association at every NT,
  // and the parts of successive groups are independent chains
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

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
    for (int gr = 0; gr < RW / GW; ++gr) {
      if (w0 + gr * GW >= k1) break;
      uint32_t a[KSTEPS][4];
      Dec::fragments(ws + gr * GW * WS, ls, WS, t, warp * 16 + 2 * g, w0 + gr * GW, lr0, a);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bx[KSTEPS][2];
        Dec::x_fragments(xs + (8 * j + g) * XS + gr * GW * PW, t, bx);
#pragma unroll
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KSTEPS; ++s) mma_bf16(part, a[s], bx[s][0], bx[s][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
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
    const int r = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(red + cl * BT + r) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(red + (cl + 1) * BT + r) = make_float2(acc[j][2], acc[j][3]);
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
                      void* y, int B, int Kw, int N, int Lrows, int ldx, int cluster,
                      int split_words, cudaStream_t stream) {
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
      (const float*)scale, (float*)y, B, Kw, N, Lrows, ldx, split_words, wvec);
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
    return launch_mma<WN, NT, 16, Fp533Decode>(x, hi, nullptr, scale, y, B, Kw, N, 0, 6 * Kw,
                                               cluster, split_words, s);
  if (row_bytes % 8 == 0 && xp % 8 == 0)
    return launch_mma<WN, NT, 8, Fp533Decode>(x, hi, nullptr, scale, y, B, Kw, N, 0, 6 * Kw,
                                              cluster, split_words, s);
  return launch_mma<WN, NT, 4, Fp533Decode>(x, hi, nullptr, scale, y, B, Kw, N, 0, 6 * Kw,
                                            cluster, split_words, s);
}

// A plan that does not cover Kw with k-group-aligned splits (groups of
// `group` word rows), one per rank, is refused
static bool bad_plan(int Kw, int cluster, int split_words, int group) {
  return Kw < 1 || cluster < 1 || cluster > 8 || split_words < 1 || split_words % group ||
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

// Split build: kernels/build.py (`PARTS`) compiles this file in 6 units at
// once, -DK1_PART=0 .. 5, and links their objects into one library, where
// one unit of all ~250 kernel instantiations took minutes. Unit 0 holds the
// entry points and K1's 27 fp533 kernels, and sees `launch_planes_m` only
// declared, so it instantiates no planes hook; units 1-5 each instantiate
// the hooks of some (HB, KS) (`K1_HOOKS` below), about 45 kernels each.
// Without K1_PART one unit holds everything.
#ifdef K1_PART
#define K1_UNIT K1_PART
#else
#define K1_UNIT (-1)
#endif

#if K1_UNIT <= 0
// The plan (tn, nt, cluster, split_words) comes from
// kernels/tuning.plan_ams_matmul.
extern "C" int ams_matmul_fp533(const void* x, const void* hi, const void* scale, void* y,
                                int B, int Kw, int N, int tn, int nt, int cluster,
                                int split_words, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (bad_plan(Kw, cluster, split_words, 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FP533_TILE(WN_, NT_) \
  launch_fp533_xv<WN_, NT_>(x, hi, scale, y, B, Kw, N, cluster, split_words, s)
  K1_TILES(FP533_TILE)
#undef FP533_TILE
}
#endif  // K1_UNIT <= 0

template <int HB, int KS, int M>
static int launch_planes_mma(const void* x, const void* hi, const void* lsb, const void* scale,
                             void* y, int B, int Kw, int N, int Lrows, int ldx, int tn, int nt,
                             int cluster, int split_words, cudaStream_t s) {
  if constexpr (!PlanesDecode<HB, KS, M>::kFormat) {
    return (int)cudaErrorInvalidValue;
  } else {
#define PLANES_TILE(WN_, NT_)                                                                  \
  launch_mma<WN_, NT_, 16, PlanesDecode<HB, KS, M>>(x, hi, lsb, scale, y, B, Kw, N, Lrows,     \
                                                    ldx, cluster, split_words, s)
    K1_TILES(PLANES_TILE)
#undef PLANES_TILE
  }
}

#define PLANES_ARGS x, hi, lsb, scale, y, B, Kw, N, Lrows, ldx, tn, nt, cluster, split_words, s
#define PLANES_PARAMS                                                                        \
  int man_bits, const void *x, const void *hi, const void *lsb, const void *scale, void *y,    \
      int B, int Kw, int N, int Lrows, int ldx, int tn, int nt, int cluster, int split_words, \
      cudaStream_t s

template <int HB, int KS>
int launch_planes_m(PLANES_PARAMS);

#if K1_UNIT != 0
template <int HB, int KS>
int launch_planes_m(PLANES_PARAMS) {
  switch (man_bits) {
    case 1: return launch_planes_mma<HB, KS, 1>(PLANES_ARGS);
    case 2: return launch_planes_mma<HB, KS, 2>(PLANES_ARGS);
    case 3: return launch_planes_mma<HB, KS, 3>(PLANES_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// each unit's (HB, KS), five valid (KS, M) formats of 9 tiles in each
#define K1_HOOKS(HB, KS) template int launch_planes_m<HB, KS>(PLANES_PARAMS);
#if K1_UNIT == 1
K1_HOOKS(4, 1) K1_HOOKS(4, 2) K1_HOOKS(4, 3) K1_HOOKS(4, 4) K1_HOOKS(6, 2)
#elif K1_UNIT == 2
K1_HOOKS(5, 1) K1_HOOKS(5, 2) K1_HOOKS(5, 3)
#elif K1_UNIT == 3
K1_HOOKS(5, 4) K1_HOOKS(6, 1) K1_HOOKS(6, 3)
#elif K1_UNIT == 4
K1_HOOKS(7, 1) K1_HOOKS(7, 2) K1_HOOKS(7, 3)
#elif K1_UNIT == 5
K1_HOOKS(7, 4) K1_HOOKS(6, 4) K1_HOOKS(8, 1) K1_HOOKS(8, 2) K1_HOOKS(8, 3) K1_HOOKS(8, 4)
#endif
#undef K1_HOOKS
#endif  // K1_UNIT != 0

#if K1_UNIT <= 0
template <int HB>
static int launch_planes_k(int k, int man_bits, const void* x, const void* hi, const void* lsb,
                           const void* scale, void* y, int B, int Kw, int N, int Lrows, int ldx,
                           int tn, int nt, int cluster, int split_words, cudaStream_t s) {
  switch (k) {
    case 1: return launch_planes_m<HB, 1>(man_bits, PLANES_ARGS);
    case 2: return launch_planes_m<HB, 2>(man_bits, PLANES_ARGS);
    case 3: return launch_planes_m<HB, 3>(man_bits, PLANES_ARGS);
    case 4: return launch_planes_m<HB, 4>(man_bits, PLANES_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1b: the planes of hi_bits in 4..8 (per_word 8, 6, 5, 4, 4) with k = 1
// (whole codes) or k = 2, 3, 4 (lsb [Lrows, N]) of a base format of
// core/formats.py (man_bits mantissa bits, the standard bias: anything else
// is refused); x [B, ldx] bf16, K positions [0, per_word Kw) of each row
// read, ldx a multiple of 8 and the base 16-byte aligned. The plan comes
// from kernels/tuning.plan_ams_matmul(container="planes").
extern "C" int ams_matmul_planes_mma(const void* x, const void* hi, const void* lsb,
                                     const void* scale, void* y, int B, int Kw, int N,
                                     int Lrows, int ldx, int hi_bits, int k, int man_bits,
                                     int bias, int tn, int nt, int cluster, int split_words,
                                     void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const int e = hi_bits - man_bits - (k == 1 ? 1 : 0);
  if (hi_bits < 4 || hi_bits > 8 || e < 2 || e > 5 || bias != (1 << (e - 1)) - 1)
    return (int)cudaErrorInvalidValue;
  const int per_word = 32 / hi_bits;
  if (bad_plan(Kw, cluster, split_words, per_word == 5 ? 16 : 8) || (uintptr_t)x % 16 ||
      ldx % 8 || (int64_t)ldx < (int64_t)per_word * Kw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hi_bits) {
    case 4: return launch_planes_k<4>(k, man_bits, PLANES_ARGS);
    case 5: return launch_planes_k<5>(k, man_bits, PLANES_ARGS);
    case 6: return launch_planes_k<6>(k, man_bits, PLANES_ARGS);
    case 7: return launch_planes_k<7>(k, man_bits, PLANES_ARGS);
    case 8: return launch_planes_k<8>(k, man_bits, PLANES_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // K1_UNIT <= 0

#undef PLANES_ARGS
#undef PLANES_PARAMS
