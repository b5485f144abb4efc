// XLA's CPU lowering of rsqrt, which the port copies on CPU tensors: torch has
// no operation with the same bits.
//
// xla_rsqrt_f32: XLA's CPU backend emits rsqrt as the hardware estimate (vrsqrtps, about
// 12 bits) refined by two Newton steps, y' = y + (-0.5 * y) * ((x * y) * y - 1),
// which its code generator contracts into two fused multiply-adds per step
// (e = fma(x * y, y, -1), y' = fma(-0.5 * y, e, y); the products x * y and
// -0.5 * y round on their own), and keeps the raw estimate where x is +-inf,
// +-0, a denormal or a negative normal (llvm.is.fpclass mask 764). The
// estimate is the CPU's own instruction, so computing it with the same
// instruction gives XLA's bits on that CPU.
// Build: g++ -O2 -mavx -mfma -ffp-contract=off -shared -fPIC.
#include <immintrin.h>
#include <cmath>
#include <cstdint>

static inline __m256 newton(__m256 x, __m256 y) {
  const __m256 neg_half = _mm256_set1_ps(-0.5f);
  const __m256 neg_one = _mm256_set1_ps(-1.0f);
  __m256 xy = _mm256_mul_ps(x, y);
  __m256 hy = _mm256_mul_ps(y, neg_half);
  __m256 e = _mm256_fmadd_ps(xy, y, neg_one);
  return _mm256_fmadd_ps(hy, e, y);
}

static inline bool keeps_estimate(float x) {
  switch (std::fpclassify(x)) {
    case FP_NAN: return false;
    case FP_INFINITE: return true;
    case FP_ZERO: return true;
    case FP_SUBNORMAL: return true;
    default: return std::signbit(x);   // negative normal
  }
}

extern "C" void xla_rsqrt_f32(const float* x, float* y, int64_t n) {
  alignas(32) float xb[8], est[8], ref[8];
  for (int64_t i = 0; i < n; i += 8) {
    int64_t m = n - i < 8 ? n - i : 8;
    for (int64_t j = 0; j < 8; ++j) xb[j] = j < m ? x[i + j] : 1.0f;
    __m256 xv = _mm256_load_ps(xb);
    __m256 y0 = _mm256_rsqrt_ps(xv);
    __m256 y2 = newton(xv, newton(xv, y0));
    _mm256_store_ps(est, y0);
    _mm256_store_ps(ref, y2);
    for (int64_t j = 0; j < m; ++j) y[i + j] = keeps_estimate(xb[j]) ? est[j] : ref[j];
  }
}
