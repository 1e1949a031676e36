// Fused polyphase filterbank tail for Hopper (sm_90a): branch FIR over
// pre-shifted, frame-reversed panels -> DFT against a (column shard of the)
// DFT matrix -> optional per-channel FM demod.
//
// Replaces the TPU kernels csdr_tpu/ops/pallas/pfb_fused.py pfb_fm_fused
// (K3, DEMOD = true) and pfb_channelize_fused (K4, DEMOD = false).  Both
// take the panels vfull (F + H, nch) complex64, built by the caller from
// the NCO-shifted input (v[i, p] = xs[i·nch − p]) with H history frames in
// front: H = L for K3, whose extra frame feeds the demod's d[t−1], and
// H = L − 1 for K4.  taps (L, nch) float32, W (nch, ncho) complex64.  Out,
// channel-major: K3 audio (ncho, F) float32, K4 channels (ncho, F) complex64.
//
// What bounds it on this card.  Per frame the kernel reads nch complex
// samples (8·nch B) and writes ncho floats or complex; per frame it does
// 2·L·nch FIR FFMAs and 4·nch·ncho DFT FFMAs.  At nch = ncho = 64, per 2^23
// samples: 64 MB in, 32 MB (K3) or 64 MB (K4) out, ~30 us of HBM at
// 3.35 TB/s, against 4.3 GFLOP of DFT, ~65 us at the 67 TFLOP/s FP32 peak:
// arithmetic bounds it, and within the arithmetic, shared-memory reads.
//
// Design.  One block per tile of tileF frames; blocks share no state.  The
// Pallas kernels gather overlapping (tileF + H)-frame slabs only because a
// BlockSpec cannot overlap; here each block reads its tile and its H-frame
// halo straight from the panel into shared memory (rows f0 .. f0+tileF+H).
//   (1) branch FIR, one thread per (frame, branch):
//       U[t, p] = sum_l taps[l, p]·S[t + L − 1 − l, p], t < nout, where
//       nout = tileF + 1 for K3 (row 0 is the frame before the tile, so the
//       demod needs no state) and tileF for K4;
//   (2) DFT in FP32 FFMA, W held in shared memory, each thread kRows frames
//       of one channel k: one W[p, k] load feeds kRows complex FMAs, and the
//       U rows are broadcast across the warp (the lanes share the frames);
//       the rows D[t, k] go back into the panel's space, rows padded to
//       ncho + 1 so the column reads below do not share a bank;
//   (3) K3: d[t]·conj(d[t−1]) -> atan2f / (2π·kf); K4: D itself; written
//       channel-major with the lanes along frames, so each channel's tileF
//       outputs are one contiguous, coalesced run.
// No TF32 and no bf16 split: every product is an FP32 FMA, and the demod is
// atan2f (the Pallas kernels' bf16x3 DFT and polynomial atan2 exist because
// the MXU takes bf16 and Mosaic has no atan2).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per tile block
constexpr int kRows = 4;       // DFT frames per thread

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Layout {
  int H, nout, E, groups, ldd, region0;
  __host__ __device__ Layout(bool demod, int nch, int ncho, int L, int tileF) {
    H = L - 1 + (demod ? 1 : 0);
    nout = tileF + (demod ? 1 : 0);
    E = tileF + H;
    groups = ceil_div(nout, kRows);
    ldd = ncho + 1;
    region0 = E * nch > nout * ldd ? E * nch : nout * ldd;
  }
  // bytes: panel rows / D rows, U (groups·kRows rows), W, then the taps
  // (ops/cuda/pfb_fused.py _smem_bytes mirrors this)
  __host__ __device__ size_t smem(int nch, int ncho, int L) const {
    return ((size_t)region0 + (size_t)groups * kRows * nch + (size_t)nch * ncho) * sizeof(float2) +
           (size_t)L * nch * sizeof(float);
  }
};

template <bool DEMOD>
__global__ void __launch_bounds__(kThreads)
    pfb_tile(const float2* __restrict__ vfull, const float* __restrict__ taps_g,
             const float2* __restrict__ W_g, long long F, int nch, int ncho, int L, int tileF,
             float inv_kf, void* __restrict__ out) {
  extern __shared__ float2 smem[];
  const Layout lay(DEMOD, nch, ncho, L, tileF);
  float2* S = smem;                                    // panel rows, then D rows
  float2* U = S + lay.region0;                         // branch FIR outputs
  float2* Ws = U + (size_t)lay.groups * kRows * nch;   // (nch, ncho)
  float* taps = reinterpret_cast<float*>(Ws + (size_t)nch * ncho);
  const int tid = threadIdx.x;
  const long long f0 = (long long)blockIdx.x * tileF;

  for (int i = tid; i < L * nch; i += kThreads) taps[i] = taps_g[i];
  for (int i = tid; i < nch * ncho; i += kThreads) Ws[i] = W_g[i];
  const float2* src = vfull + f0 * nch;  // panel row f0 = the tile's first halo row
  for (int i = tid; i < lay.E * nch; i += kThreads) S[i] = src[i];
  __syncthreads();

  // (1) branch FIR; rows nout .. groups·kRows−1 are zero padding for (2)
  for (int i = tid; i < lay.groups * kRows * nch; i += kThreads) {
    const int t = i / nch, p = i - t * nch;
    float2 acc = make_float2(0.f, 0.f);
    if (t < lay.nout) {
      const float2* s = S + (size_t)(t + L - 1) * nch + p;
      for (int l = 0; l < L; ++l) {
        const float c = taps[l * nch + p];
        const float2 v = s[-(long long)l * nch];
        acc.x = fmaf(c, v.x, acc.x);
        acc.y = fmaf(c, v.y, acc.y);
      }
    }
    U[i] = acc;
  }
  __syncthreads();

  // (2) DFT: D[t, k] = sum_p U[t, p]·W[p, k], into S with row stride ldd
  for (int i = tid; i < lay.groups * ncho; i += kThreads) {
    const int g = i / ncho, k = i - g * ncho;
    const float2* u = U + (size_t)g * kRows * nch;
    float2 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int p = 0; p < nch; ++p) {
      const float2 w = Ws[p * ncho + k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float2 a = u[r * nch + p];
        acc[r].x = fmaf(a.x, w.x, fmaf(-a.y, w.y, acc[r].x));
        acc[r].y = fmaf(a.x, w.y, fmaf(a.y, w.x, acc[r].y));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = g * kRows + r;
      if (t < lay.nout) S[t * lay.ldd + k] = acc[r];
    }
  }
  __syncthreads();

  // (3) channel-major output, lanes along frames
  for (int i = tid; i < tileF * ncho; i += kThreads) {
    const int k = i / tileF, t = i - k * tileF;
    const long long o = (long long)k * F + f0 + t;
    if constexpr (DEMOD) {
      const float2 a = S[(t + 1) * lay.ldd + k], b = S[t * lay.ldd + k];
      const float cre = a.x * b.x + a.y * b.y;
      const float cim = a.y * b.x - a.x * b.y;
      static_cast<float*>(out)[o] = atan2f(cim, cre) * inv_kf;
    } else {
      static_cast<float2*>(out)[o] = S[t * lay.ldd + k];
    }
  }
}

template <bool DEMOD>
cudaError_t launch(const void* vfull, const void* taps, const void* W, long long F, int nch,
                   int ncho, int L, int tileF, float inv_kf, void* out, cudaStream_t st) {
  const size_t smem = Layout(DEMOD, nch, ncho, L, tileF).smem(nch, ncho, L);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(reinterpret_cast<const void*>(&pfb_tile<DEMOD>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  pfb_tile<DEMOD><<<(unsigned)(F / tileF), kThreads, smem, st>>>(
      static_cast<const float2*>(vfull), static_cast<const float*>(taps),
      static_cast<const float2*>(W), F, nch, ncho, L, tileF, inv_kf, out);
  return cudaGetLastError();
}

}  // namespace

// One launch of K3 (demod != 0: audio (ncho, F) float32) or K4 (demod == 0:
// channels (ncho, F) complex64) on `stream`; returns cudaGetLastError().
// Shapes: vfull (F + L + (demod ? 0 : −1), nch), tileF | F.
extern "C" int csdr_pfb_fused(int demod, const void* vfull, const void* taps, const void* W,
                              long long F, int nch, int ncho, int L, int tileF, float inv_kf,
                              void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return demod ? launch<true>(vfull, taps, W, F, nch, ncho, L, tileF, inv_kf, out, st)
               : launch<false>(vfull, taps, W, F, nch, ncho, L, tileF, inv_kf, out, st);
}
