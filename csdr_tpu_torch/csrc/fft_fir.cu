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
// What bounds it on this card.  Per 2^23 complex samples with the 1,826-tap
// SSB band-pass the function must read 64 MB and write 64 MB: ~40 us of HBM
// at 3.35 TB/s; its ~577 segment FFT pairs are ~1.3 GFLOP, ~20 us at the
// 67 TFLOP/s FP32 peak.  Real x real halves both.  A transform that walks
// the segment through shared memory stage by stage is bound instead by
// shared-memory round trips and barriers, so this design keeps the points in
// registers and touches shared memory only to exchange them between passes.
//
// Design.  One block of 512 threads owns one segment (or, real x real,
// a pair of segments) of one row.  The S = 16 x 16 x 16 x 4-point DIF
// transform runs as four register passes of 1024 radix-16 butterflies (two
// per thread, 16 points in registers each); between them the threads
// exchange the segment through shared memory (3 exchanges per transform):
//   pass 1  butterfly r < 1024: DFT16 over x[r + 1024 m], straight from
//           global memory (coalesced), times W_16384^{r k}, to r + 1024 k;
//   pass 2  each 1024-block, r < 64:  DFT16 over stride 64, W_1024^{r k};
//   pass 3  each 64-block,   r < 4:   DFT16 over stride 4,  W_64^{r k};
//   pass 4  each thread's 16 consecutive points as four DFT4s.
// Position k1·1024 + k2·64 + k3·4 + k4 then holds X[k1 + 16 k2 + 256 k3 +
// 4096 k4]; H (the taps' DFT / S) is stored by the wrapper in that order,
// laid out [j][u] for point j of butterfly u so its loads coalesce.  The
// product happens in registers, the inverse undoes pass 4 in the same
// registers and then passes 3, 2, 1 (conjugate twiddles, conjugate DFT16),
// and pass 1's inverse stores straight to the output.  The exchange buffer
// is padded by one float2 per 16 (p + p/16), so no pass conflicts on banks.
// Twiddles: W^r and W^{4r} from sincospif (full precision; never
// __sinf/__cosf), the other powers by at most three products; the DFT16's
// own constants are compile-time.  Real x real: segments 2i and 2i+1 ride in
// the real and imaginary parts of one complex transform (real taps keep them
// apart), halving the FFTs; an odd count pairs the last with zeros.  No cuFFT.

#include <cuda_runtime.h>

#include "fft_reg.cuh"

namespace {

using namespace csdr;

constexpr int kS = 16384;                 // segment length
constexpr int kThreads = 512;             // threads per block (128 registers each)
constexpr int kBfly = kS / 16;            // radix-16 butterflies per pass
constexpr int kPer = kBfly / kThreads;    // butterflies per thread per pass
constexpr int kPadded = kS + kS / 16;     // exchange buffer, one pad per 16

enum Mode { kComplexIn = 0, kRealInComplexOut = 1, kRealPair = 2 };

__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

// v[i] *= W_N^{∓r·k(i)} with W_N = e^{-2πi/N}, N = 2/scale; k(i) = rev4(i)
// when OUT_REV (a DFT's outputs), else i.  W^r and W^{4r} come from
// sincospif, the rest by products.
template <bool INV, bool OUT_REV>
__device__ __forceinline__ void twiddle(float2 (&v)[16], int r, float scale) {
  float s, c;
  sincospif(-(float)r * scale, &s, &c);
  const float2 w1 = make_float2(c, INV ? -s : s);
  sincospif(-(float)(4 * r) * scale, &s, &c);
  const float2 w4 = make_float2(c, INV ? -s : s);
  const float2 w2 = cmul(w1, w1), w3 = cmul(w2, w1);
  float2 base = make_float2(1.f, 0.f);
#pragma unroll
  for (int hi = 0; hi < 4; ++hi) {  // k = 4·hi + lo
#pragma unroll
    for (int lo = 0; lo < 4; ++lo) {
      const int k = 4 * hi + lo;
      if (k == 0) continue;
      const float2 w = lo == 0 ? base : lo == 1 ? cmul(base, w1) : lo == 2 ? cmul(base, w2)
                                                                        : cmul(base, w3);
      const int i = OUT_REV ? rev4(k) : k;
      v[i] = cmul(v[i], w);
    }
    base = hi == 0 ? w4 : cmul(base, w4);
  }
}

// Forward passes 2 and 3 over shared memory, in place: butterfly u of a
// pass with sub-length N (1024 or 64) and stride N/16.
template <int N>
__device__ __forceinline__ void fwd_pass(float2* s, int u) {
  constexpr int st = N / 16;
  const int base = (u / st) * N, r = u % st;
  float2 v[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = s[pad(base + r + st * m)];
  dft_reg<16, false>(v);
  twiddle<false, true>(v, r, 2.f / N);
#pragma unroll
  for (int k = 0; k < 16; ++k) s[pad(base + r + st * k)] = v[rev4(k)];
}

template <int N>
__device__ __forceinline__ void inv_pass(float2* s, int u) {
  constexpr int st = N / 16;
  const int base = (u / st) * N, r = u % st;
  float2 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = s[pad(base + r + st * k)];
  twiddle<true, false>(v, r, 2.f / N);
  dft_reg<16, true>(v);
#pragma unroll
  for (int m = 0; m < 16; ++m) s[pad(base + r + st * m)] = v[rev4(m)];
}

__device__ __forceinline__ float2 load_pt(const float2* xr, long long i, long long lx) {
  return i < lx ? xr[i] : make_float2(0.f, 0.f);
}
__device__ __forceinline__ float load_pt(const float* xr, long long i, long long lx) {
  return i < lx ? xr[i] : 0.f;
}

// x: rows of lx = n + K - 1 samples; Ht: the taps' S-point DFT / S in the
// transform's output order, as [j][u]; y: rows of n samples.  A block owns
// segment blockIdx.x (MODE kRealPair: segments 2·blockIdx.x and +1).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    fft_fir_segment(const void* __restrict__ xv, const float2* __restrict__ Ht, long long n,
                    long long lx, int K, int hop, int nseg, void* __restrict__ yv) {
  extern __shared__ float2 s[];
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const int seg = MODE == kRealPair ? 2 * blockIdx.x : blockIdx.x;
  const long long start = (long long)seg * hop;
  const long long start2 = start + hop;  // kRealPair: the imaginary segment
  const bool has2 = MODE == kRealPair && seg + 1 < nseg;

  // pass 1: global → registers → shared
#pragma unroll
  for (int g = 0; g < kPer; ++g) {
    const int r = tid + g * kThreads;
    float2 v[16];
    if (MODE == kComplexIn) {
      const float2* xr = static_cast<const float2*>(xv) + row * lx;
#pragma unroll
      for (int m = 0; m < 16; ++m) v[m] = load_pt(xr, start + r + 1024 * m, lx);
    } else {
      const float* xr = static_cast<const float*>(xv) + row * lx;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        v[m].x = load_pt(xr, start + r + 1024 * m, lx);
        v[m].y = has2 ? load_pt(xr, start2 + r + 1024 * m, lx) : 0.f;
      }
    }
    dft_reg<16, false>(v);
    twiddle<false, true>(v, r, 2.f / kS);
#pragma unroll
    for (int k = 0; k < 16; ++k) s[pad(r + 1024 * k)] = v[rev4(k)];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kPer; ++g) fwd_pass<1024>(s, tid + g * kThreads);
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kPer; ++g) fwd_pass<64>(s, tid + g * kThreads);
  __syncthreads();

  // pass 4, the spectrum product and pass 4's inverse, in registers
#pragma unroll
  for (int g = 0; g < kPer; ++g) {
    const int u = tid + g * kThreads;
    float2 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = s[pad(16 * u + j)];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 a[4] = {v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]};
      dft_reg<4, false>(a);  // a[rev2(k)] = X[k]
      v[4 * q] = a[0]; v[4 * q + 1] = a[2]; v[4 * q + 2] = a[1]; v[4 * q + 3] = a[3];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = cmul(v[j], __ldg(&Ht[j * kBfly + u]));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 a[4] = {v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]};
      dft_reg<4, true>(a);
      v[4 * q] = a[0]; v[4 * q + 1] = a[2]; v[4 * q + 2] = a[1]; v[4 * q + 3] = a[3];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) s[pad(16 * u + j)] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kPer; ++g) inv_pass<64>(s, tid + g * kThreads);
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kPer; ++g) inv_pass<1024>(s, tid + g * kThreads);
  __syncthreads();

  // pass 1's inverse: shared → registers → global; overlap-save keeps
  // positions [K - 1, S), outputs start .. start + hop
#pragma unroll
  for (int g = 0; g < kPer; ++g) {
    const int r = tid + g * kThreads;
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = s[pad(r + 1024 * k)];
    twiddle<true, false>(v, r, 2.f / kS);
    dft_reg<16, true>(v);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int i = r + 1024 * m;
      if (i < K - 1) continue;
      const long long o = start + (i - (K - 1));
      const float2 val = v[rev4(m)];
      if (MODE == kRealPair) {
        float* yr = static_cast<float*>(yv) + row * n;
        if (o < n) yr[o] = val.x;
        if (has2 && o + hop < n) yr[o + hop] = val.y;
      } else if (o < n) {
        (static_cast<float2*>(yv) + row * n)[o] = val;
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const void* x, const void* Ht, long long n, long long lx, int K, int hop,
                   int nseg, int rows, void* y, cudaStream_t st) {
  const size_t smem = kPadded * sizeof(float2);
  const cudaError_t e =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(&fft_fir_segment<MODE>),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = MODE == kRealPair ? (nseg + 1) / 2 : nseg;
  fft_fir_segment<MODE><<<dim3((unsigned)blocks, (unsigned)rows), kThreads, smem, st>>>(
      x, static_cast<const float2*>(Ht), n, lx, K, hop, nseg, y);
  return cudaGetLastError();
}

}  // namespace

// One launch over `rows` rows and `nseg` segments on `stream`; returns
// cudaGetLastError().  complex_in: x is float2 rows, else float;
// complex_out: y is float2 rows, else float (only with real input and real
// taps, which pairs segments).  hop = 16384 - (K - 1), nseg = ceil(n / hop).
extern "C" int csdr_fft_fir(int complex_in, int complex_out, const void* x, const void* Ht,
                            long long n, long long lx, int K, int hop, int nseg, int rows,
                            void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (complex_in) return launch<kComplexIn>(x, Ht, n, lx, K, hop, nseg, rows, y, st);
  if (complex_out) return launch<kRealInComplexOut>(x, Ht, n, lx, K, hop, nseg, rows, y, st);
  return launch<kRealPair>(x, Ht, n, lx, K, hop, nseg, rows, y, st);
}
