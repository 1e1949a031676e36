// Overlap-save FFT FIR for Hopper (sm_90a): real or complex taps over
// batched rows of real (float) or complex (float2) samples.
//
// Replaces the TPU kernel csdr_tpu/ops/pallas/fftfir.py fft_fir_valid (K6,
// pallas_call in _fft_fir).  Same semantics and segment boundaries: segments
// of S = 16384 samples start every hop = S - (K - 1) input samples, segment
// j's circular convolution with the taps is exact at positions [K - 1, S),
// which are outputs [j*hop, j*hop + hop) of the row; the input past the row
// end is zero.  Real input with real taps gives real output, anything else
// complex.
//
// What bounds it on this card.  Per segment two 16384-point complex FFTs
// (7 radix-4 stages each, ~1.1 MFLOP per FFT) and 128 KB + 128 KB of device
// traffic at most; per 2^23 input samples with the 1,826-tap SSB band-pass
// that is ~577 segments, ~1.3 GFLOP and ~130 MB: ~20 us of FLOPs at the
// FP32 peak against ~40 us of HBM.  What is left is shared-memory traffic
// (each stage reads and writes the whole segment) and the barrier between
// stages, so the design keeps the segment resident and touches device memory
// only to load it, to read H and the twiddles, and to write it back.
//
// Design.  The Pallas kernel factors the DFT into 128 x 128 matmuls because
// the MXU is its fast path; here one block of 1024 threads owns one
// (segment, row) and runs the FFTs in shared memory (the segment as float2,
// 128 KB, so the launch raises the dynamic shared-memory limit).  The
// forward transform is an in-place radix-4 decimation in frequency: natural
// order in, base-4 digit-reversed order out.  H is stored in that same
// digit-reversed order (with 1/S folded in), so the spectrum product needs
// no reordering, and the inverse runs the forward stages' exact inverses in
// reverse order (conjugated twiddles, then the conjugate radix-4 butterfly),
// digit-reversed in, natural order out.  Twiddles e^{-2 pi i k / S} and H
// come from float64 tables cast to float32 (the wrapper makes them), not
// from __sinf/__cosf.  No cuFFT.

#include <cuda_runtime.h>

namespace {

constexpr int kS = 16384;          // segment length, 4^7
constexpr int kThreads = 1024;     // threads per segment block
constexpr int kBfly = kS / 4;      // radix-4 butterflies per stage

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {  // a * conj(b)
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}
__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 mul_i(float2 a) { return make_float2(-a.y, a.x); }  // a * i

__device__ __forceinline__ float2 load_in(const float* xr, long long idx, long long lx) {
  return make_float2(idx < lx ? xr[idx] : 0.f, 0.f);
}
__device__ __forceinline__ float2 load_in(const float2* xr, long long idx, long long lx) {
  return idx < lx ? xr[idx] : make_float2(0.f, 0.f);
}
__device__ __forceinline__ void store_out(float* yr, long long o, float2 v) { yr[o] = v.x; }
__device__ __forceinline__ void store_out(float2* yr, long long o, float2 v) { yr[o] = v; }

// x: rows of lx = n + K - 1 samples; tw: e^{-2 pi i k / S}, k < S; H: the
// taps' S-point DFT / S in digit-reversed order; y: rows of n samples.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    fft_fir_segment(const TI* __restrict__ x, const float2* __restrict__ tw,
                    const float2* __restrict__ H, long long n, long long lx, int K, int hop,
                    TO* __restrict__ y) {
  extern __shared__ float2 s[];
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const long long start = (long long)blockIdx.x * hop;
  const TI* xr = x + row * lx;

  for (int i = tid; i < kS; i += kThreads) s[i] = load_in(xr, start + i, lx);
  __syncthreads();

  // forward: radix-4 DIF, sub-transform length L = 4Q from S down to 4;
  // butterfly (g, j) takes a_m = s[g·L + j + m·Q] and writes
  // y_m · W_L^{jm}, y_m = sum_l a_l · (-i)^{lm}
  for (int lq = 12; lq >= 0; lq -= 2) {
    const int Q = 1 << lq;
    const int step = kS >> (lq + 2);  // S / L: W_L^{jm} = tw[j·m·step]
    for (int b = tid; b < kBfly; b += kThreads) {
      const int j = b & (Q - 1);
      const int i = ((b >> lq) << (lq + 2)) + j;
      const float2 a0 = s[i], a1 = s[i + Q], a2 = s[i + 2 * Q], a3 = s[i + 3 * Q];
      const float2 b0 = add(a0, a2), b1 = sub(a0, a2);
      const float2 b2 = add(a1, a3), b3 = mul_i(sub(a1, a3));
      s[i] = add(b0, b2);
      s[i + Q] = cmul(sub(b1, b3), __ldg(&tw[j * step]));
      s[i + 2 * Q] = cmul(sub(b0, b2), __ldg(&tw[2 * j * step]));
      s[i + 3 * Q] = cmul(add(b1, b3), __ldg(&tw[3 * j * step]));
    }
    __syncthreads();
  }

  // the spectrum product, both in digit-reversed order
  for (int i = tid; i < kS; i += kThreads) s[i] = cmul(s[i], __ldg(&H[i]));
  __syncthreads();

  // inverse: each forward stage undone in reverse order, L from 4 up to S:
  // a_m = s[...] · conj(W_L^{jm}), then y_m = sum_l a_l · (+i)^{lm}
  for (int lq = 0; lq <= 12; lq += 2) {
    const int Q = 1 << lq;
    const int step = kS >> (lq + 2);
    for (int b = tid; b < kBfly; b += kThreads) {
      const int j = b & (Q - 1);
      const int i = ((b >> lq) << (lq + 2)) + j;
      const float2 a0 = s[i];
      const float2 a1 = cmul_conj(s[i + Q], __ldg(&tw[j * step]));
      const float2 a2 = cmul_conj(s[i + 2 * Q], __ldg(&tw[2 * j * step]));
      const float2 a3 = cmul_conj(s[i + 3 * Q], __ldg(&tw[3 * j * step]));
      const float2 b0 = add(a0, a2), b1 = sub(a0, a2);
      const float2 b2 = add(a1, a3), b3 = mul_i(sub(a1, a3));
      s[i] = add(b0, b2);
      s[i + Q] = add(b1, b3);
      s[i + 2 * Q] = sub(b0, b2);
      s[i + 3 * Q] = sub(b1, b3);
    }
    __syncthreads();
  }

  // overlap-save: positions [K - 1, S) are outputs start .. start + hop
  TO* yr = y + row * n;
  for (int i = K - 1 + tid; i < kS; i += kThreads) {
    const long long o = start + (i - (K - 1));
    if (o < n) store_out(yr, o, s[i]);
  }
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const void* tw, const void* H, long long n, long long lx,
                   int K, int hop, int nseg, int rows, void* y, cudaStream_t st) {
  const size_t smem = kS * sizeof(float2);
  const cudaError_t e =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(&fft_fir_segment<TI, TO>),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fft_fir_segment<TI, TO><<<dim3((unsigned)nseg, (unsigned)rows), kThreads, smem, st>>>(
      static_cast<const TI*>(x), static_cast<const float2*>(tw),
      static_cast<const float2*>(H), n, lx, K, hop, static_cast<TO*>(y));
  return cudaGetLastError();
}

}  // namespace

// One launch over `rows` rows and `nseg` segments on `stream`; returns
// cudaGetLastError().  complex_in: x is float2 rows, else float;
// complex_out: y is float2 rows, else float (only with real input and real
// taps).  hop = 16384 - (K - 1), nseg = ceil(n / hop).
extern "C" int csdr_fft_fir(int complex_in, int complex_out, const void* x, const void* tw,
                            const void* H, long long n, long long lx, int K, int hop, int nseg,
                            int rows, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (complex_in) return launch<float2, float2>(x, tw, H, n, lx, K, hop, nseg, rows, y, st);
  if (complex_out) return launch<float, float2>(x, tw, H, n, lx, K, hop, nseg, rows, y, st);
  return launch<float, float>(x, tw, H, n, lx, K, hop, nseg, rows, y, st);
}
