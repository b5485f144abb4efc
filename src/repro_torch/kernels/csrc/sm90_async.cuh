// Hopper building blocks shared by the kernels of this directory: cp.async
// copies into shared memory, their groups, and the bf16 tensor-core product
// mma.sync m16n8k16 with f32 accumulation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// 16 bytes global -> shared, or 16 zero bytes when !pred (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

// BYTES (4, 8 or 16) global -> shared, zeros when !pred
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, bool pred) {
  if constexpr (BYTES == 16) {
    cp_async16(dst, src, pred);
  } else {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(pred ? BYTES : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
