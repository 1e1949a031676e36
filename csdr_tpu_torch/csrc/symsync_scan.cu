// The closed-loop symbol synchronizer for Hopper (sm_90a): a Gardner timing
// detector and PI loop per output tick, one stream per row (channel).
//
// Replaces no Pallas kernel.  It replaces the lax.scan of
// csdr_tpu/models/symsync.py SymSyncScan.apply (sym_sync_r / sym_sync_c with
// mode="scan"): written as PyTorch ops the loop would be about ten launches
// per output.  For each row and output j, in float32:
//     pos = (start + j·half) + τ;  ipos = floor(pos);  frac = pos − ipos;
//     ph = clip(rint(frac·npfb), 0, npfb − 1);
//     y[j] = Σ_t xfull[s + t]·bank[ph, t],  s = clamp(wrap(ipos − mk), 0, L − W),
// W = 2mk + 1 taps, the window as lax.dynamic_slice takes it: a negative
// start wraps once (+ L), then the start is clamped; then on centre ticks
// (j even)
//     e = −clip(Re(edge·conj(y − prev)), −1, 1);  η += ki·e;
//     τ = (τ + kp·e) + η;  prev = y,
// and on the others edge = y.  (τ, η, prev, edge) come in and go out per
// row; the block applies the end-of-block wrap of τ.
//
// What bounds it on this card: not bytes (each input read once, each output
// written once: ~12 B per input sample) but the serial chain per output:
// the position from τ, a window load (L1/L2), W multiply-adds, a five-level
// shuffle reduction and the loop update, before the next output's position
// is known.
//
// Design: one warp per row, kWarps rows per block.  The bank (npfb × W
// float32; 20.7 KB at npfb 64, W 81) is staged in shared memory once per
// block.  Every lane holds the carry and computes the position itself;
// lane l takes taps l, l + 32, l + 64, …, in that order, and a fixed
// __shfl_xor_sync tree (16, 8, 4, 2, 1) sums the lanes, which leaves the
// same bits in every lane, so every lane applies the same loop update and
// no broadcast is needed.  The window is read from the row in device
// memory: consecutive outputs overlap by W − half samples, so it mostly
// hits L1.  Lane j % 32 keeps output j, and every 32 outputs the warp
// stores them coalesced.  Every product and sum is an explicit _rn
// intrinsic (no FMA contraction), rint rounds half to even as jnp.round,
// and a frac·npfb that rounds to npfb is clipped to npfb − 1 (it does not
// move to the next ipos).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // rows per block

struct Real {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T madd(T acc, T x, float b) {
    return __fadd_rn(acc, __fmul_rn(x, b));
  }
  static __device__ __forceinline__ T shfl_add(T v, int off) {
    return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  // edge·(y − prev)
  static __device__ __forceinline__ float ted(T edge, T y, T prev) {
    return __fmul_rn(edge, __fsub_rn(y, prev));
  }
};

struct Complex {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ T madd(T acc, T x, float b) {
    return make_float2(__fadd_rn(acc.x, __fmul_rn(x.x, b)), __fadd_rn(acc.y, __fmul_rn(x.y, b)));
  }
  static __device__ __forceinline__ T shfl_add(T v, int off) {
    return make_float2(__fadd_rn(v.x, __shfl_xor_sync(0xffffffffu, v.x, off)),
                       __fadd_rn(v.y, __shfl_xor_sync(0xffffffffu, v.y, off)));
  }
  // Re(edge·conj(d)), d = y − prev: er·dr + ei·di
  static __device__ __forceinline__ float ted(T edge, T y, T prev) {
    const float dr = __fsub_rn(y.x, prev.x), di = __fsub_rn(y.y, prev.y);
    return __fadd_rn(__fmul_rn(edge.x, dr), __fmul_rn(edge.y, di));
  }
};

template <typename K>
__global__ void __launch_bounds__(32 * kWarps) symsync_scan_rows(
    const typename K::T* __restrict__ xfull, long long L, int rows,
    const float* __restrict__ bank, int npfb, int W, int mk, long long nout, float start,
    float half, float kp, float ki, const float* __restrict__ tau_in,
    const float* __restrict__ eta_in, const typename K::T* __restrict__ prev_in,
    const typename K::T* __restrict__ edge_in, typename K::T* __restrict__ y,
    float* __restrict__ tau_out, float* __restrict__ eta_out, typename K::T* __restrict__ prev_out,
    typename K::T* __restrict__ edge_out) {
  using T = typename K::T;
  extern __shared__ float sbank[];
  for (int i = threadIdx.x; i < npfb * W; i += blockDim.x) sbank[i] = bank[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* x = xfull + row * L;
  T* yr = y + row * nout;
  float tau = tau_in[row], eta = eta_in[row];
  T prev = prev_in[row], edge = edge_in[row];
  const float npf = (float)npfb;
  T mine = K::zero();
  for (long long j = 0; j < nout; ++j) {
    const float pos = __fadd_rn(__fadd_rn(start, __fmul_rn((float)j, half)), tau);
    const float fl = floorf(pos);
    const float frac = __fsub_rn(pos, fl);
    int ph = (int)rintf(__fmul_rn(frac, npf));
    ph = ph < 0 ? 0 : (ph > npfb - 1 ? npfb - 1 : ph);
    long long s = (long long)fl - mk;
    if (s < 0) s += L;
    s = s < 0 ? 0 : (s > L - W ? L - W : s);
    const T* win = x + s;
    const float* b = sbank + ph * W;
    T acc = K::zero();
    for (int t = lane; t < W; t += 32) acc = K::madd(acc, win[t], b[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc = K::shfl_add(acc, off);
    if ((j & 1) == 0) {
      float e = K::ted(edge, acc, prev);
      e = -fminf(fmaxf(e, -1.0f), 1.0f);
      eta = __fadd_rn(eta, __fmul_rn(ki, e));
      tau = __fadd_rn(__fadd_rn(tau, __fmul_rn(kp, e)), eta);
      prev = acc;
    } else {
      edge = acc;
    }
    if ((int)(j & 31) == lane) mine = acc;
    if ((j & 31) == 31 || j == nout - 1) {
      const long long j0 = j & ~31LL;
      if (j0 + lane <= j) yr[j0 + lane] = mine;
    }
  }
  if (lane == 0) {
    tau_out[row] = tau;
    eta_out[row] = eta;
    prev_out[row] = prev;
    edge_out[row] = edge;
  }
}

template <typename K>
cudaError_t launch(const void* xfull, long long L, int rows, const void* bank, int npfb, int W,
                   int mk, long long nout, float start, float half, float kp, float ki,
                   const void* tau_in, const void* eta_in, const void* prev_in,
                   const void* edge_in, void* y, void* tau_out, void* eta_out, void* prev_out,
                   void* edge_out, cudaStream_t st) {
  using T = typename K::T;
  const size_t smem = sizeof(float) * (size_t)npfb * W;
  cudaError_t e = cudaFuncSetAttribute(&symsync_scan_rows<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
  symsync_scan_rows<K><<<grid, 32 * kWarps, smem, st>>>(
      static_cast<const T*>(xfull), L, rows, static_cast<const float*>(bank), npfb, W, mk, nout,
      start, half, kp, ki, static_cast<const float*>(tau_in), static_cast<const float*>(eta_in),
      static_cast<const T*>(prev_in), static_cast<const T*>(edge_in), static_cast<T*>(y),
      static_cast<float*>(tau_out), static_cast<float*>(eta_out), static_cast<T*>(prev_out),
      static_cast<T*>(edge_out));
  return cudaGetLastError();
}

}  // namespace

// One launch over `rows` rows of L = H + n samples on `stream`; returns the
// first CUDA error (0 when it launched).  is_complex: xfull, y, prev and edge
// are float2 (complex64), else float.  bank: (npfb, W) float32; tau, eta:
// (rows,) float32; y: (rows, nout).
extern "C" int csdr_symsync_scan(int is_complex, const void* xfull, long long L, int rows,
                                 const void* bank, int npfb, int W, int mk, long long nout,
                                 float start, float half, float kp, float ki, const void* tau_in,
                                 const void* eta_in, const void* prev_in, const void* edge_in,
                                 void* y, void* tau_out, void* eta_out, void* prev_out,
                                 void* edge_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_complex
                   ? launch<Complex>(xfull, L, rows, bank, npfb, W, mk, nout, start, half, kp, ki,
                                     tau_in, eta_in, prev_in, edge_in, y, tau_out, eta_out,
                                     prev_out, edge_out, st)
                   : launch<Real>(xfull, L, rows, bank, npfb, W, mk, nout, start, half, kp, ki,
                                  tau_in, eta_in, prev_in, edge_in, y, tau_out, eta_out, prev_out,
                                  edge_out, st));
}
