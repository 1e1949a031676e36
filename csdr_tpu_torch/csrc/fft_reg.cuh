// Register-resident DFT pieces shared by the FFT kernels (fft_fir.cu,
// flagship_fused.cu): complex products, the 16th roots of unity as
// constants, and a radix-2 DFT of up to 16 points held in registers.
#pragma once

#include <cuda_runtime.h>

namespace csdr {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// e^{∓2πi e/16} (INV: +), folded to constants once the callers unroll
template <bool INV>
__device__ __forceinline__ float2 w16(int e) {
  const float c1 = 0.92387953251128674f, s1 = 0.38268343236508977f, h = 0.70710678118654752f;
  float2 w;
  switch (e & 15) {
    case 0: w = make_float2(1.f, 0.f); break;
    case 1: w = make_float2(c1, -s1); break;
    case 2: w = make_float2(h, -h); break;
    case 3: w = make_float2(s1, -c1); break;
    case 4: w = make_float2(0.f, -1.f); break;
    case 5: w = make_float2(-s1, -c1); break;
    case 6: w = make_float2(-h, -h); break;
    case 7: w = make_float2(-c1, -s1); break;
    case 8: w = make_float2(-1.f, 0.f); break;
    case 9: w = make_float2(-c1, s1); break;
    case 10: w = make_float2(-h, h); break;
    case 11: w = make_float2(-s1, c1); break;
    case 12: w = make_float2(0.f, 1.f); break;
    case 13: w = make_float2(s1, c1); break;
    case 14: w = make_float2(h, h); break;
    default: w = make_float2(c1, s1); break;
  }
  return INV ? cconj(w) : w;
}

// One radix-2 DIF stage of span 2·HALF over P points in registers, then
// the stages below it (templates, so every index is a constant and v stays
// in registers).
template <int P, int HALF, bool INV>
__device__ __forceinline__ void dif_stage(float2 (&v)[P]) {
#pragma unroll
  for (int g = 0; g < P; g += 2 * HALF) {
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float2 a = v[g + j], b = v[g + j + HALF];
      v[g + j] = make_float2(a.x + b.x, a.y + b.y);
      const float2 d = make_float2(a.x - b.x, a.y - b.y);
      const int e = j * (16 / (2 * HALF));  // W_{2 HALF}^j = W_16^e
      if (e == 0) v[g + j + HALF] = d;
      else if (e == 4) v[g + j + HALF] = INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
      else v[g + j + HALF] = cmul(d, w16<INV>(e));
    }
  }
  if constexpr (HALF > 1) dif_stage<P, HALF / 2, INV>(v);
}

// In-register DFT of P = 2^p points (P <= 16), radix-2 decimation in
// frequency: natural order in, bit-reversed order out (X[k] in v[rev(k)]).
// INV: the conjugate (unscaled inverse) DFT.
template <int P, bool INV>
__device__ __forceinline__ void dft_reg(float2 (&v)[P]) {
  if constexpr (P > 1) dif_stage<P, P / 2, INV>(v);
}

__host__ __device__ constexpr int rev4(int k) {
  return ((k & 1) << 3) | ((k & 2) << 1) | ((k & 4) >> 1) | ((k & 8) >> 3);
}

// k < P with its log2 P bits reversed (P <= 16)
__host__ __device__ constexpr int rev_bits(int k, int P) {
  return rev4(k) >> (P >= 16 ? 0 : P == 8 ? 1 : P == 4 ? 2 : 3);
}

}  // namespace csdr
