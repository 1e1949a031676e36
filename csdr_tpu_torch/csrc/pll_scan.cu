// The stereo decoder's per-sample pilot PLL for Hopper (sm_90a): a
// second-order loop over each row of an analytic pilot, returning the
// regenerated 38 kHz subcarrier e^{2jθ[n]}.
//
// Replaces no Pallas kernel.  It replaces the lax.scan of
// csdr_tpu/models/stereo.py fms_pll_scan (StereoFMDecoder(pll_mode="scan"),
// the reference's liquid fmsPll): written as PyTorch ops the loop would be
// about ten launches per sample.  For each row and step n, in float32:
//     rot = e^{−jθ};  e = angle(p[n]·rot);  freq += β·e;
//     θ_out[n] = θ;   θ ← mod(((θ + ω) + freq) + α·e, 2π)   (floored mod)
// and sub38[n] = e^{2jθ_out[n]}; (θ, freq) come in and go out per row.
//
// What bounds it on this card: not bytes (12 B per sample; a 2^20-sample
// row moves 12 MB, ~4 us at 3.35 TB/s) but the serial chain of one step:
// sincosf → complex product → atan2f → three dependent adds → fmodf, each
// waiting on the last θ, some 100–200 dependent instructions per sample.
//
// Design: one warp per row.  The warp stages a chunk of kChunk samples of p
// into shared memory with coalesced loads, lane 0 runs the chunk's loop
// (the loads of p are off the dependent chain) and leaves θ in shared
// memory, then all lanes turn the chunk's θ into e^{2jθ} (sincosf in
// parallel) and store it coalesced.  Every product and sum is an explicit
// _rn intrinsic, so nothing is contracted to an FMA and the order is the
// JAX code's; sincosf and atan2f are the accurate library functions, not
// the __sinf / __cosf intrinsics; mod is fmodf plus 2π where the signs
// differ, as jnp.mod.  A simple kernel first: the PLL could instead be
// wrap(arg p − θ) after a parallel atan2 pass, in a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;                       // samples staged per chunk
constexpr float kTwoPi = 6.28318530717958647692f;  // np.float32(2π)

// jnp.mod / torch.remainder: fmodf, then + y where the signs differ.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = __fadd_rn(r, y);
  return r;
}

__global__ void __launch_bounds__(32) pll_scan_rows(
    const float2* __restrict__ p, long long n, const float* __restrict__ theta_in,
    const float* __restrict__ freq_in, float omega, float alpha, float beta,
    float2* __restrict__ sub, float* __restrict__ theta_out, float* __restrict__ freq_out) {
  __shared__ float2 ps[kChunk];
  __shared__ float th[kChunk];
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float2* pr = p + row * n;
  float2* sr = sub + row * n;
  float theta = theta_in[row], freq = freq_in[row];
  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    const int len = (int)(n - c0 < kChunk ? n - c0 : kChunk);
    for (int i = lane; i < len; i += 32) ps[i] = pr[c0 + i];
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < len; ++i) {
        float s, c;
        sincosf(theta, &s, &c);
        const float2 v = ps[i];
        // p·e^{−jθ} = (pr + j·pi)(c − j·s)
        const float re = __fadd_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s));
        const float im = __fsub_rn(__fmul_rn(v.y, c), __fmul_rn(v.x, s));
        const float e = atan2f(im, re);
        th[i] = theta;
        freq = __fadd_rn(freq, __fmul_rn(beta, e));
        theta = floor_mod(__fadd_rn(__fadd_rn(__fadd_rn(theta, omega), freq), __fmul_rn(alpha, e)),
                          kTwoPi);
      }
    }
    __syncwarp();
    for (int i = lane; i < len; i += 32) {
      float s, c;
      sincosf(__fmul_rn(2.0f, th[i]), &s, &c);
      sr[c0 + i] = make_float2(c, s);
    }
    __syncwarp();
  }
  if (lane == 0) {
    theta_out[row] = theta;
    freq_out[row] = freq;
  }
}

}  // namespace

// One launch over `rows` rows of n complex64 samples on `stream`; returns the
// first CUDA error (0 when it launched).  theta/freq in and out: (rows,)
// float32; sub: (rows, n) complex64.
extern "C" int csdr_pll_scan(const void* p, long long n, int rows, const void* theta_in,
                             const void* freq_in, float omega, float alpha, float beta, void* sub,
                             void* theta_out, void* freq_out, void* stream) {
  pll_scan_rows<<<rows, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(p), n, static_cast<const float*>(theta_in),
      static_cast<const float*>(freq_in), omega, alpha, beta, static_cast<float2*>(sub),
      static_cast<float*>(theta_out), static_cast<float*>(freq_out));
  return (int)cudaGetLastError();
}
