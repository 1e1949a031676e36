// Causal valid FIR for Hopper (sm_90a): real float32 taps over batched rows
// of real (float) or complex (float2) samples.
//
// Replaces the TPU kernel csdr_tpu/ops/pallas/fir_kernel.py pallas_fir_valid
// (K5, pallas_call in _fir_rows).  For each row b:
//     y[b, i] = sum_k h[k] * x[b, i + K - 1 - k],   i < n,  row length n + K - 1,
// which, with the reversed taps g[p] = h[K - 1 - p], is the correlation
//     y[b, i] = sum_p g[p] * x[b, i + p].
// Complex rows are read as float2 (re, im) and filtered in one pass; the
// Pallas kernel splits them into two planes only because the MXU is real.
//
// What bounds it on this card.  Every output costs K FFMAs (2K for complex)
// and moves 8 B in and 8 B out (complex).  At 64 channels x 2^17 samples x
// 585 taps that is 9.8 G FFMA = 19.6 GFLOP, >= 0.29 ms at the 67 TFLOP/s
// FP32 peak, against 128 MB of traffic, ~38 us at 3.35 TB/s: FP32 FMA bounds
// it by ~8x.  So the design spends its effort on keeping the FMA pipes fed
// from registers, not on the memory side.
//
// Design.  The Toeplitz banks and the 128-lane rows of the Pallas kernel are
// the TPU's way onto its matrix unit and are dropped.  A block covers kTile
// consecutive outputs of one row (grid: output tiles x rows); the taps are
// swept in shared-memory chunks of kChunk, so any K works.  For each chunk
// the block stages its input window (kTile + chunk samples) and the chunk's
// reversed taps in shared memory.  Each thread owns kR consecutive outputs
// and keeps kR window samples in a register ring: per tap it loads ONE
// sample from shared memory and does kR (complex: 2kR) FMAs, the tap itself
// a broadcast read.  kR is odd, so the per-thread stride kR (floats, or
// float2 pairs) spreads a warp's loads over all 32 banks.  The outputs go
// back through shared memory and leave as coalesced runs.  Every product is
// an FP32 FFMA (no TF32, no tensor cores).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kR = 9;                       // outputs per thread (odd: no bank conflicts)
constexpr int kTile = kThreads * kR;        // outputs per block
constexpr int kChunk = 128 * kR;            // taps per shared-memory chunk (multiple of kR)
constexpr int kWin = kTile + kChunk;        // window samples per chunk

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float2 zero_of(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ void fma_into(float& acc, float c, float v) { acc = fmaf(c, v, acc); }
__device__ __forceinline__ void fma_into(float2& acc, float c, float2 v) {
  acc.x = fmaf(c, v.x, acc.x);
  acc.y = fmaf(c, v.y, acc.y);
}

// x: rows of lx = n + K - 1 samples; g: the K reversed taps; y: rows of n
// samples.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fir_valid_tile(const T* __restrict__ x, const float* __restrict__ g, long long n,
                   long long lx, int K, T* __restrict__ y) {
  __shared__ T s[kWin];
  __shared__ float gs[kChunk];
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const long long i0 = (long long)blockIdx.x * kTile;
  const T* xr = x + row * lx;
  const T zero = zero_of(T());

  T acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = zero;

  const int Kp = (K + kR - 1) / kR * kR;  // the taps padded with zeros to whole rings
  for (int pc = 0; pc < Kp; pc += kChunk) {
    const int kc = Kp - pc < kChunk ? Kp - pc : kChunk;  // a multiple of kR
    __syncthreads();  // the previous chunk's readers are done with s and gs
    // window s[j] = x[i0 + pc + j]; past the row's end it is zero (those
    // samples meet only padded zero taps or outputs >= n)
    for (int j = tid; j < kTile + kc; j += kThreads) {
      const long long idx = i0 + pc + j;
      s[j] = idx < lx ? xr[idx] : zero;
    }
    for (int j = tid; j < kc; j += kThreads) gs[j] = pc + j < K ? g[pc + j] : 0.f;
    __syncthreads();

    // output r of this thread at tap p needs w[r + p]; the ring buf holds
    // w[p0 + j'] in slot j' mod kR for j' in [q, q + kR) at step q
    const T* w = s + tid * kR;
    T buf[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) buf[r] = w[r];
    for (int p0 = 0; p0 < kc; p0 += kR) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const float c = gs[p0 + q];
#pragma unroll
        for (int r = 0; r < kR; ++r) fma_into(acc[r], c, buf[(r + q) % kR]);
        buf[q] = w[p0 + q + kR];  // max index kTile + kc - 1 < kWin
      }
    }
  }

  // outputs through shared memory (stride kR, conflict-free), then
  // coalesced stores of the tile's valid outputs
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kR; ++r) s[tid * kR + r] = acc[r];
  __syncthreads();
  T* yr = y + row * n;
  for (int j = tid; j < kTile; j += kThreads) {
    const long long o = i0 + j;
    if (o < n) yr[o] = s[j];
  }
}

}  // namespace

// One launch over `rows` rows on `stream`; returns cudaGetLastError().
// is_complex: x and y are float2 (complex64) rows, else float.  g holds the
// K reversed taps, g[p] = h[K - 1 - p].
extern "C" int csdr_fir_valid(int is_complex, const void* x, const void* g, long long n,
                              long long lx, int K, int rows, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)rows);
  if (is_complex) {
    fir_valid_tile<float2><<<grid, kThreads, 0, st>>>(static_cast<const float2*>(x),
                                                      static_cast<const float*>(g), n, lx, K,
                                                      static_cast<float2*>(y));
  } else {
    fir_valid_tile<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                     static_cast<const float*>(g), n, lx, K,
                                                     static_cast<float*>(y));
  }
  return cudaGetLastError();
}
