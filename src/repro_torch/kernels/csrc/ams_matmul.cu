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
