// K1: fused AMS-Quant dequantize + matmul for the fp533 container.
//
// Replaces src/repro/kernels/ams_matmul.py: ams_matmul_padded ->
// _kernel_fp533 (+ _unpack_fp533, decode_codes_to_f32).
//
//   y[b, n] = (sum_k bf16(x[b, k]) * DeQ(W)[k, n]) * scale[n]
//
// W is fp5.33-e2m3: each int32 word of hi[Kp/6, N] holds 6 consecutive
// K positions of one column (two 16-bit halves, each three 5-bit high parts
// plus the group's shared mantissa LSB at bit 15).
//
// Bound: at decode (B = slots) the kernel streams 4/6 byte per weight once
// and does 2*B flops per weight, far below the H100's flops-per-byte
// balance, so it is bound by device-memory bytes. At prefill rows
// (B = slots * chunk) it does all of its FMAs on CUDA cores, not tensor
// cores, and becomes bound by those operations.
//
// Design: one block = 32 output columns x 8 rows of x. Each of the 8 warps
// walks a disjoint, interleaved subset of the packed K words; lane n of a
// warp reads hi[kw, n0 + n], so a warp reads 128 contiguous bytes per word
// row (coalesced in the [Kp/6, N] layout). x is staged in shared memory per
// chunk of K, rounded to bf16 by the wrapper and widened here to f32; all
// lanes read the same x element, a shared-memory broadcast. Each word is
// restored to six f32 values with the same SHIFT/AND/OR sequence as
// decode_codes_to_f32 (IEEE bit pattern for normals, exact M * 2^-3 for
// subnormals), so products bf16 x e2m3 are exact in f32 and the result
// differs from the reference only by summation order. The 8 warps' partial
// sums are reduced through shared memory and scaled once by scale[n].
// Known weak spots (left for later work): CUDA-core FMAs instead of
// tensor cores at prefill rows, and only N/32 blocks per row tile (16 for
// N = 512).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define K1_COLS 32
#define K1_WARPS 8
#define K1_ROWS 8
#define K1_CHUNK_WORDS 64

// e2m3, bias 1: code = S << 5 | E << 3 | M
__device__ __forceinline__ float decode_e2m3(int code) {
  const int M = code & 7;
  const int E = (code >> 3) & 3;
  const int S = (code >> 5) & 1;
  float v;
  if (E == 0) {
    v = (float)M * 0.125f;                          // M * 2^(1 - 1 - 3)
  } else {
    v = __int_as_float(((E - 1 + 127) << 23) | (M << 20));
  }
  return S ? -v : v;
}

__global__ void __launch_bounds__(K1_WARPS * 32)
ams_matmul_fp533_kernel(const __nv_bfloat16* __restrict__ x,
                        const int32_t* __restrict__ hi,
                        const float* __restrict__ scale,
                        float* __restrict__ y, int B, int Kw, int N) {
  __shared__ float xs[K1_ROWS][K1_CHUNK_WORDS * 6];
  __shared__ float red[K1_WARPS][K1_ROWS][K1_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * K1_COLS + lane;
  const int b0 = blockIdx.y * K1_ROWS;
  const int64_t Kp = (int64_t)Kw * 6;
  float acc[K1_ROWS];
#pragma unroll
  for (int r = 0; r < K1_ROWS; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < Kw; c0 += K1_CHUNK_WORDS) {
    const int cw = min(K1_CHUNK_WORDS, Kw - c0);
    const int ck = cw * 6;
    __syncthreads();
    for (int i = threadIdx.x; i < K1_ROWS * ck; i += blockDim.x) {
      const int r = i / ck, kk = i - r * ck;
      const int b = b0 + r;
      xs[r][kk] = (b < B) ? __bfloat162float(x[(int64_t)b * Kp + (int64_t)c0 * 6 + kk])
                          : 0.f;
    }
    __syncthreads();
    if (n < N) {
      for (int w = warp; w < cw; w += K1_WARPS) {
        const uint32_t word = (uint32_t)hi[(int64_t)(c0 + w) * N + n];
        float v[6];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int half = (int)((word >> (16 * h)) & 0xFFFFu);
          const int shared_bit = (half >> 15) & 1;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            v[3 * h + j] = decode_e2m3((((half >> (5 * j)) & 0x1F) << 1) | shared_bit);
        }
#pragma unroll
        for (int r = 0; r < K1_ROWS; ++r) {
          const float* xr = &xs[r][w * 6];
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[r] = fmaf(xr[j], v[j], acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < K1_ROWS; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  // 256 threads <-> 8 rows x 32 columns of output
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

extern "C" int ams_matmul_fp533(const void* x, const void* hi, const void* scale,
                                void* y, int B, int Kw, int N, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  dim3 grid((N + K1_COLS - 1) / K1_COLS, (B + K1_ROWS - 1) / K1_ROWS);
  dim3 block(K1_WARPS * 32);
  ams_matmul_fp533_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int32_t*)hi, (const float*)scale, (float*)y,
      B, Kw, N);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1b: the same product for the planes container (every scheme but fp5.33).
//
// Replaces src/repro/kernels/ams_matmul.py: ams_matmul_padded ->
// _kernel_planes (+ _unpack_planes, decode_codes_to_f32).
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
// Bound and design as K1: bytes at decode (fp4.25 reads 4.25/8 byte per
// weight), CUDA-core FMAs at prefill rows. One block = 32 columns x 8 rows,
// warps take interleaved words of a K chunk, lane n reads hi[kw, n0 + n].
// The chunk's lsb words (one serves 32k K positions, 16 hi rows for
// fp4.25) are staged once per block in shared memory beside x.

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

// per_word in {4, 5, 6, 8}, k in {1, 2, 3, 4}; anything else is refused
// with cudaErrorInvalidValue (the Python wrapper checks first).
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
    case 8: return launch_planes_k<8>(k, x, hi, lsb, scale, y, B, Kw, N, hi_bits, fmt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
