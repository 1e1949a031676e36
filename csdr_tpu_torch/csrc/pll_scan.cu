// The stereo decoder's per-sample pilot PLL for Hopper (sm_90a): a
// second-order loop over each row of an analytic pilot, returning the
// regenerated 38 kHz subcarrier e^{2jθ[n]}.
//
// Replaces no Pallas kernel.  It replaces the lax.scan of
// csdr_tpu/models/stereo.py fms_pll_scan (StereoFMDecoder(pll_mode="scan"),
// the reference's liquid fmsPll): written as PyTorch ops the loop would be
// about ten launches per sample.  It rests on angle(p·e^{−jθ}) =
// wrap(arg p − θ).  For each row, in float32:
//     φ[n] = atan2(Im p[n], Re p[n])                    (every n at once)
//     d = φ[n] − θ;  e = d ≤ −π ? d + 2π : d;  freq += β·e;
//     θ_out[n] = θ;  θ ← wrap2π(((θ + ω) + freq) + α·e)
//     sub38[n] = e^{2jθ_out[n]}                         (every n at once)
// where wrap2π(x) is x + 2π for x < 0, x − 2π for x ≥ 2π, else x.  On the
// loop's range these cheap forms are the floored mod and the angle exactly:
// d + 2π is exact for d in (−3π, −π] and x − 2π for x in [2π, 4π)
// (Sterbenz), and x + 2π for x in (−2π, 0) is the one rounding floor_mod
// makes.  Outside it, two rare branches keep the JAX semantics: where d is
// not in (−3π, π] (p = 0, flagged as φ = NaN, or a carried θ outside
// [0, 2π)) e is the angle of the rotated product, sincosf → complex
// product → atan2f, whose signed zeros give angle(0·e^{−jθ}) as JAX does;
// where x is not in (−2π, 4π) (a carried θ or freq far out) θ takes
// floor_mod, fmodf plus 2π where the signs differ, as jnp.mod.  (θ, freq)
// come in and go out per row.
//
// What bounds it on this card: not bytes (16 B per sample; a 2^20-sample
// row moves 16 MB, ~5 us at 3.35 TB/s) but the dependent chain of one step,
// θ → d → e → freq → θ: about ten adds, multiplies, compares and selects
// (θ + ω and α·e leave the chain).  Computing angle(p·e^{−jθ}) in the loop
// would put sincosf, a complex product, atan2f and fmodf on it, some 500
// cycles a sample.
//
// Design: one block of three warps per row over a ring of two chunks of
// kChunk samples in shared memory, one __syncthreads per chunk.  In step t
// warp 1 loads chunk t of p coalesced and writes its φ, lane 0 of warp 0
// runs the loop over chunk t − 1 and leaves its θ_out, and warp 2 turns
// chunk t − 2's θ_out into e^{2jθ} and stores it coalesced; the two side
// stages take a few µs per chunk against the loop's ~25, so they hide
// behind it.  Every product and sum is an explicit _rn intrinsic, so
// nothing is contracted to an FMA and the order is the JAX code's;
// sincosf and atan2f are the accurate library functions, not the __sinf /
// __cosf intrinsics.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;                         // samples per ring chunk
constexpr int kGroup = 32;                           // loop steps between branches
constexpr float kPi = 3.14159265358979323846f;       // np.float32(π)
constexpr float kTwoPi = 6.28318530717958647692f;    // np.float32(2π) = 2·kPi
constexpr float kThreePi = 9.42477796076937971538f;  // np.float32(3π)
constexpr float kFourPi = 12.5663706143591729538f;   // np.float32(4π) = 4·kPi

// jnp.mod / torch.remainder: fmodf, then + y where the signs differ.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = __fadd_rn(r, y);
  return r;
}

// x < y ? a : b and x >= y ? a : b as one compare and one select each
// (written in PTX: a conditional expression of the same kind compiles to
// branches, which stall the loop)
__device__ __forceinline__ float select_lt(float x, float y, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, %2;\n\tselp.f32 %0, %3, %4, p;\n\t}"
      : "=f"(r) : "f"(x), "f"(y), "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float select_ge(float x, float y, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, %2;\n\tselp.f32 %0, %3, %4, p;\n\t}"
      : "=f"(r) : "f"(x), "f"(y), "f"(a), "f"(b));
  return r;
}

// angle(p·e^{−jθ}), the product (pr + j·pi)(c − j·s) in the JAX order
__device__ __noinline__ float rotated_angle(float2 v, float theta) {
  float s, c;
  sincosf(theta, &s, &c);
  const float re = __fadd_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s));
  const float im = __fsub_rn(__fmul_rn(v.y, c), __fmul_rn(v.x, s));
  return atan2f(im, re);
}

// The loop over len samples with a branch per case, from (θ, freq); returns
// them after: φ from ph, θ_out to th, p read again only where e takes the
// rotated product.
__device__ __noinline__ float2 careful_steps(const float* ph, float* th, const float2* pc, int len,
                                             float omega, float alpha, float beta, float theta,
                                             float freq) {
  for (int i = 0; i < len; ++i) {
    const float d = __fsub_rn(ph[i], theta);
    float e;
    if (d > -kThreePi && d <= kPi) {
      e = d <= -kPi ? __fadd_rn(d, kTwoPi) : d;
    } else {
      e = rotated_angle(pc[i], theta);
    }
    th[i] = theta;
    freq = __fadd_rn(freq, __fmul_rn(beta, e));
    const float x = __fadd_rn(__fadd_rn(__fadd_rn(theta, omega), freq), __fmul_rn(alpha, e));
    if (x > -kTwoPi && x < kFourPi) {
      theta = x < 0.0f ? __fadd_rn(x, kTwoPi) : (x >= kTwoPi ? __fsub_rn(x, kTwoPi) : x);
    } else {
      theta = floor_mod(x, kTwoPi);
    }
  }
  return make_float2(theta, freq);
}

__global__ void __launch_bounds__(96) pll_scan_rows(
    const float2* __restrict__ p, long long n, const float* __restrict__ theta_in,
    const float* __restrict__ freq_in, float omega, float alpha, float beta,
    float2* __restrict__ sub, float* __restrict__ theta_out, float* __restrict__ freq_out) {
  __shared__ __align__(16) float phs[2][kChunk];
  __shared__ __align__(16) float ths[2][kChunk];
  const long long row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float2* pr = p + row * n;
  float2* sr = sub + row * n;
  float theta = theta_in[row], freq = freq_in[row];
  const long long chunks = (n + kChunk - 1) / kChunk;
  for (long long t = 0; t < chunks + 2; ++t) {
    if (warp == 1 && t < chunks) {
      // φ of chunk t; p = 0 is flagged as NaN, which sends the loop to the
      // rotated product
      const long long c0 = t * kChunk;
      const int len = (int)(n - c0 < kChunk ? n - c0 : kChunk);
      float* ph = phs[t & 1];
      for (int i = lane; i < len; i += 32) {
        const float2 v = pr[c0 + i];
        ph[i] = (v.x == 0.0f && v.y == 0.0f) ? __int_as_float(0x7fc00000) : atan2f(v.y, v.x);
      }
    } else if (warp == 0 && t >= 1 && t <= chunks && lane == 0) {
      const long long c0 = (t - 1) * kChunk;
      const int len = (int)(n - c0 < kChunk ? n - c0 : kChunk);
      const float* ph = phs[(t - 1) & 1];
      float* th = ths[(t - 1) & 1];
      int g = 0;
      // kGroup steps at a time without a branch: φ in registers, the cheap
      // wraps as selects, a flag where a step leaves their range; a flagged
      // group is run again from its start by careful_steps
      for (; g + kGroup <= len; g += kGroup) {
        float phv[kGroup], thv[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; u += 4) {
          const float4 q = *reinterpret_cast<const float4*>(ph + g + u);
          phv[u] = q.x;
          phv[u + 1] = q.y;
          phv[u + 2] = q.z;
          phv[u + 3] = q.w;
        }
        const float theta0 = theta, freq0 = freq;
        bool rare = false;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float d = __fsub_rn(phv[u], theta);
          rare |= !(d > -kThreePi && d <= kPi);
          const float e = select_lt(-kPi, d, d, __fadd_rn(d, kTwoPi));   // d ≤ −π: d + 2π
          thv[u] = theta;
          freq = __fadd_rn(freq, __fmul_rn(beta, e));
          const float x =
              __fadd_rn(__fadd_rn(__fadd_rn(theta, omega), freq), __fmul_rn(alpha, e));
          rare |= !(x > -kTwoPi && x < kFourPi);
          theta = select_lt(x, 0.0f, __fadd_rn(x, kTwoPi),
                            select_ge(x, kTwoPi, __fsub_rn(x, kTwoPi), x));
        }
        if (__builtin_expect(rare, 0)) {
          const float2 tf =
              careful_steps(ph + g, th + g, pr + c0 + g, kGroup, omega, alpha, beta, theta0, freq0);
          theta = tf.x;
          freq = tf.y;
        } else {
#pragma unroll
          for (int u = 0; u < kGroup; u += 4)
            *reinterpret_cast<float4*>(th + g + u) =
                make_float4(thv[u], thv[u + 1], thv[u + 2], thv[u + 3]);
        }
      }
      const float2 tf =
          careful_steps(ph + g, th + g, pr + c0 + g, len - g, omega, alpha, beta, theta, freq);
      theta = tf.x;
      freq = tf.y;
    } else if (warp == 2 && t >= 2) {
      const long long c0 = (t - 2) * kChunk;
      const int len = (int)(n - c0 < kChunk ? n - c0 : kChunk);
      const float* th = ths[(t - 2) & 1];
      for (int i = lane; i < len; i += 32) {
        float s, c;
        sincosf(__fmul_rn(2.0f, th[i]), &s, &c);
        sr[c0 + i] = make_float2(c, s);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
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
  pll_scan_rows<<<rows, 96, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(p), n, static_cast<const float*>(theta_in),
      static_cast<const float*>(freq_in), omega, alpha, beta, static_cast<float2*>(sub),
      static_cast<float*>(theta_out), static_cast<float*>(freq_out));
  return (int)cudaGetLastError();
}
