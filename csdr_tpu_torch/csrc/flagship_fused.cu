// Fused flagship chain for Hopper (sm_90a): DC blocker -> NCO pre-shift ->
// polyphase filterbank -> nch-point DFT -> per-channel FM demod.
//
// Replaces the TPU kernels csdr_tpu/ops/pallas/flagship_fused.py
// (flagship_fused_step, any nch) and flagship_fused_wide.py
// (flagship_fused_wide_step, nch | 64).  Both compute one function; they
// differ only in TPU lane layout, so one kernel family parameterised by nch
// covers them.  External semantics and state layout are flagship_fused's:
//   phase      float32 ()          NCO phase at the first sample of the block
//   hist       complex64 (L+1,nch) last L+1 DC-blocked, NCO-shifted frames
//   x_last     complex64 ()        last raw input sample
//   y_dc_last  complex64 ()        last DC-blocker output sample
//
// What bounds it on this card.  The function reads 2 B per cu8 sample (8 for
// complex64) and writes 4 B of audio per frame-channel: per 2^23 cu8 samples
// 50 MB, ~15 us at 3.35 TB/s.  Its least arithmetic is ~125 FLOP per sample
// (15-tap complex-by-real FIR 60, a 64-point FFT ~26, DC, NCO, u8 and demod
// ~40): ~1.05 GFLOP, ~16 us at the 67 TFLOP/s FP32 peak.  The earlier form
// of this kernel spent its time on a direct 64-term DFT per output with both
// operands in shared memory, and on a DC phase that wrote the shifted
// samples to a scratch buffer and read them back.
//
// Design.  The TPU grid runs in order, so the Pallas kernels carry the DC
// recurrence and the PFB history from tile to tile in VMEM/SMEM scratch.
// CUDA blocks run concurrently and in no order, so the carries are made
// explicit, in three launches:
//   (a1) dc_chunk     one block per chunk of C = tileF·nch samples: the chunk
//        is staged in shared memory (16 B loads where aligned), each thread
//        solves its spt-sample segment with zero carry, a block-wide
//        decay scan (r^spt per thread; warp shuffles) gives the chunk's zero-carry
//        end value and its zero-carry value at the halo start offset o_h
//        (the same offset in every chunk: o_h = −(L+1)·nch mod C).
//   (a2) carry_scan   one block: the chunk carries
//        g[k] = r^C·g[k-1] + w_end[k], seeded from y_dc_last, by the same
//        decay scan over 1024 threads of m chunks each.  Also writes the
//        new y_dc_last and phase.
//   (b)  channel_tile   a persistent walk: the grid is the blocks the card
//        holds at once (fewer where F is short), each owning a contiguous run
//        of tiles of TF frames (TF·nch ~ 4096 samples, TF a multiple of
//        tileF above L; the wrapper's channel_plan), which it walks in
//        order.  Only a run's first tile stages a halo (the L+1 frames
//        before it) and takes its DC carry as r^{o_h}·g[c] + partial[c] (or
//        y_dc_last and hist for the first frames); between tiles the block
//        keeps in shared memory the last L frames (the next tile's FIR
//        halo), the last DFT frame (the next tile's first demod input), the
//        DC output and the raw sample before the next tile.  The taps,
//        twiddles and NCO table load once per block.  While a tile runs its
//        DC, FIR, DFT and demod, the next tile's raw bytes are in flight
//        into a staging buffer (cp.async, 16 B), read when that tile
//        starts.  Per tile: the DC solves per-thread
//        segments with zero carry, a decay scan, then a replay of each
//        segment from its exact carry, rotated by the NCO (a 2·nch-entry
//        table indexed by sample position: the pre-shift −π(nch−1)/nch has
//        period 2·nch samples; cos/sin of a float64-made ramp plus the
//        carried phase).  No shifted samples leave the block.  Then the
//        permuted-tap branch FIR (u[i,p=(nch-q)%nch] = sum_J T^[J,q]·s[i-J,q]):
//        one thread per branch q walks kRun frames with the window in a
//        register ring (no moves), one shared-memory load per step of
//        complex-by-real MACs.  Then the DFT d[i,k] = sum_q u^[i,q]·e^{-j2πkq/nch}:
//        for nch = P·G a power of two <= 64, G lanes per frame each run a
//        P-point FFT in registers and a radix-G pass across the lanes with
//        __shfl_xor_sync; for any other nch a direct DFT blocked as 2
//        channels x 4 frames per thread.  Last the conjugate-product demod
//        with atan2_poly, written channel-major (nch, F).
// No TF32, no bf16 split: every product is an FP32 FMA.  Every power of r
// comes from a float64 host table or argument.

#include <cuda_runtime.h>

#include "fft_reg.cuh"
#include "mma_bf16x3.cuh"

namespace {

using namespace csdr;

constexpr int kScanThreads = 1024;    // threads of the one-block carry scan
constexpr int kChannelThreads = 256;  // threads per channel-tile block
constexpr int kRun = 16;              // frames per FIR thread (a power of two)
constexpr int kSeg = 16;              // samples per thread of a later tile's register DC
constexpr float kTwoPi = 6.28318530717958647692f;

enum InputMode { kComplex = 0, kU8Interleaved = 1, kU8Planes = 2 };

// sample planes in shared memory, padded one float per 32
__host__ __device__ constexpr int pidx(int p) { return p + (p >> 5); }
__host__ __device__ constexpr int plane_len(int count) {
  return (count + (count >> 5) + 2) & ~1;
}
// U row stride: odd for one lane per frame, nch + 4 when G lanes share one
__host__ __device__ constexpr int u_ld(int nch) {
  return (nch == 32 || nch == 64) ? nch + 4 : nch + 1;
}

// S's row stride and the column of branch q.  Where a row holds several
// 16-sample segments (nch a multiple of 16 above 16), the columns skip 4
// entries every 16 and the stride is 1 mod 16 (float2 units): the 16
// threads of a half-warp that write 4 frames × 4 segments (the DC replay)
// or 4 frames × 4 lanes (the DFT) then fall in 16 distinct bank pairs.
__host__ __device__ constexpr bool s_skew(int nch) { return nch % kSeg == 0 && nch > kSeg; }
__host__ __device__ constexpr int s_col(int nch, int q) {
  return s_skew(nch) ? q + 4 * (q >> 4) : q;
}
__host__ __device__ constexpr int s_ld(int nch) {
  return s_skew(nch) ? ((s_col(nch, nch - 1) + 16) & ~15) + 1 : nch + 1;
}

// the NCO table's 2·nch entries, padded one per 16 (entry k at k + k/16):
// the 16-sample segments of a warp's threads start 16 entries apart
__host__ __device__ constexpr int rot_at(int k) { return k + (k >> 4); }
__host__ __device__ constexpr int rot_len(int nch) { return rot_at(2 * nch - 1) + 1; }

// channel_tile's shared memory, in this order: the staging buffer of the
// next tile's raw bytes (vec only: one plane of TF·nch samples, two for u8
// planes), then in float2 units the X planes of a run's first range
// (halo + tile + the sample before) aliased by U, the frames S, the NCO
// table, the twiddles, and last the taps (floats).
struct ChannelLayout {
  int pre_bytes, pl, a_len, s_len;
  size_t bytes;
  __host__ __device__ ChannelLayout(int mode, int nch, int L, int TF, int vec) {
    const int per = mode == kComplex ? 8 : mode == kU8Interleaved ? 2 : 1;
    const int planes = mode == kU8Planes ? 2 : 1;
    pre_bytes = vec ? (planes * TF * nch * per + 15) & ~15 : 0;
    pl = plane_len((TF + L + 1) * nch + 1);
    const int u_len = (TF + 1) * u_ld(nch);
    a_len = pl > u_len ? pl : u_len;
    s_len = (TF + L + 1) * s_ld(nch);
    bytes = (size_t)pre_bytes +
            sizeof(float2) * ((size_t)a_len + s_len + rot_len(nch) + nch) +
            sizeof(float) * (size_t)(L + 1) * nch;
  }
};

// cu8 byte v (< 256) as v·(1/127.5) − 1: the float 2^23 + v, exact, less
// 2^23 gives v without an I2F (a quarter-rate conversion); u8b takes byte
// j of w by one PRMT
__device__ __forceinline__ float u8v(float v) { return v * (1.0f / 127.5f) - 1.0f; }
__device__ __forceinline__ float u8f(unsigned v) {
  return u8v(__int_as_float(0x4B000000u | v) - 8388608.f);
}
__device__ __forceinline__ float u8b(unsigned w, int j) {
  return u8v(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + j)) - 8388608.f);
}

// atan2(y, x) for finite x, y without a branch: t = min/max of |x|, |y|,
// atan(t) = t·P(t²) on [0, 1] (P of degree 8, fitted to 8.4e-8 rad in
// float32), then the octant.  Within 3e-7 rad of atan2f; atan2f's own
// division and special-case paths took most of the demod's time.  Signed
// zeros give atan2's results (±0, ±π); a pair whose larger magnitude is
// below FLT_MIN (denormal) counts as zero.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float atan2_poly(float y, float x) {
  constexpr float kAtan[9] = {0.99999988079071045f,  -0.33332598209381104f, 0.19985906779766083f,
                              -0.14161224663257599f, 0.10498932003974915f,  -0.07234829664230347f,
                              0.03978092223405838f,  -0.014401184394955635f, 0.002456683199852705f};
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float t = mx >= 1.17549435e-38f ? mn * rcp_approx(mx) : 0.f;
  const float s = t * t;
  float p = kAtan[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) p = fmaf(p, s, kAtan[i]);
  float a = t * p;
  if (ay > ax) a = 1.57079632679489662f - a;
  if (signbit(x)) a = 3.14159265358979324f - a;
  return copysignf(a, y);
}

__device__ __forceinline__ float2 load_sample(int mode, const void* x0, const void* x1,
                                              long long s) {
  if (mode == kComplex) return reinterpret_cast<const float2*>(x0)[s];
  if (mode == kU8Interleaved) {
    const uchar2 v = reinterpret_cast<const uchar2*>(x0)[s];
    return make_float2(u8f(v.x), u8f(v.y));
  }
  return make_float2(u8f(reinterpret_cast<const unsigned char*>(x0)[s]),
                     u8f(reinterpret_cast<const unsigned char*>(x1)[s]));
}

// Samples s0 .. s0+count-1 (of device or shared memory) into planes Xr/Xi
// at off .. off+count-1, all threads of the block.  vec: 16-byte loads (the
// wrapper checks that the pointers are 16-byte aligned and that s0 and
// count are multiples of 16).
__device__ __forceinline__ void stage(int mode, const void* x0, const void* x1, long long s0,
                                      int count, bool vec, float* Xr, float* Xi, int off) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (!vec) {  // kBatch loads in flight per thread, then their stores
    constexpr int kBatch = 8;
    for (int i0 = t; i0 < count; i0 += kBatch * nt) {
      float2 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (i0 + j * nt < count) v[j] = load_sample(mode, x0, x1, s0 + i0 + j * nt);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (i0 + j * nt < count) {
          Xr[pidx(off + i0 + j * nt)] = v[j].x;
          Xi[pidx(off + i0 + j * nt)] = v[j].y;
        }
    }
    return;
  }
  if (mode == kComplex) {  // 2 samples per float4
    const float4* p = reinterpret_cast<const float4*>(reinterpret_cast<const float2*>(x0) + s0);
    for (int i = t; i < count / 2; i += nt) {
      const float4 v = p[i];
      Xr[pidx(off + 2 * i)] = v.x; Xi[pidx(off + 2 * i)] = v.y;
      Xr[pidx(off + 2 * i + 1)] = v.z; Xi[pidx(off + 2 * i + 1)] = v.w;
    }
  } else if (mode == kU8Interleaved) {  // 8 samples per 16 bytes
    const uint4* p = reinterpret_cast<const uint4*>(reinterpret_cast<const uchar2*>(x0) + s0);
    for (int i = t; i < count / 8; i += nt) {
      const uint4 v = p[i];
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = off + 8 * i + 2 * j;
        Xr[pidx(o)] = u8b(w[j], 0); Xi[pidx(o)] = u8b(w[j], 1);
        Xr[pidx(o + 1)] = u8b(w[j], 2); Xi[pidx(o + 1)] = u8b(w[j], 3);
      }
    }
  } else {  // 16 samples per 16 bytes of each plane
    const uint4* pr =
        reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(x0) + s0);
    const uint4* pi =
        reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(x1) + s0);
    for (int i = t; i < count / 16; i += nt) {
      const uint4 a = pr[i], b = pi[i];
      const unsigned wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        Xr[pidx(off + 16 * i + j)] = u8b(wa[j / 4], j % 4);
        Xi[pidx(off + 16 * i + j)] = u8b(wb[j / 4], j % 4);
      }
    }
  }
}

// dst[i] = src[i], i < count, by all threads of the block, four loads in
// flight per thread
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* __restrict__ src, int count) {
  constexpr int kB = 4;
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < count; i0 += kB * nt) {
    T v[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j)
      if (i0 + j * nt < count) v[j] = src[i0 + j * nt];
#pragma unroll
    for (int j = 0; j < kB; ++j)
      if (i0 + j * nt < count) dst[i0 + j * nt] = v[j];
  }
}

// In-place inclusive scan sc[t] <- sum_{j<=t} pw[t-j]·sc[j] over blockDim.x
// entries, where pw[d] = a^d for the block's uniform per-entry decay a
// (pw holds at least min(blockDim.x, 32) + 1 entries).  Warp shuffles scan
// each warp, one thread chains the warp totals, three barriers in all.
__device__ __forceinline__ void decay_scan(float2* sc, const float* __restrict__ pw) {
  __shared__ float2 ws[32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, nw = (blockDim.x + 31) >> 5;
  const int live = min(32, (int)blockDim.x - 32 * w);
  const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
  float2 v = sc[t];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ox = __shfl_up_sync(mask, v.x, d), oy = __shfl_up_sync(mask, v.y, d);
    if (lane >= d) {
      const float p = pw[d];
      v.x = fmaf(p, ox, v.x);
      v.y = fmaf(p, oy, v.y);
    }
  }
  if (lane == live - 1) ws[w] = v;
  __syncthreads();
  if (t == 0) {
    const float p = nw > 1 ? pw[32] : 0.f;
    for (int k = 1; k < nw; ++k) ws[k] = make_float2(fmaf(p, ws[k - 1].x, ws[k].x),
                                                     fmaf(p, ws[k - 1].y, ws[k].y));
  }
  __syncthreads();
  if (w > 0) {
    const float p = pw[lane + 1];
    v.x = fmaf(p, ws[w - 1].x, v.x);
    v.y = fmaf(p, ws[w - 1].y, v.y);
  }
  sc[t] = v;
  __syncthreads();
}

// The exclusive decay scan of one value a thread, in thread order, in
// registers: returns sum_{j<t} pw[t−1−j]·v_j, where pw[d] = a^d (at least
// 33 entries).  Warp shuffles scan each warp; one barrier publishes the warp
// totals, which every thread combines itself.  blockDim.x: a multiple of 32.
__device__ __forceinline__ float2 decay_prefix(float2 v, const float* __restrict__ pw) {
  __shared__ float2 wt[32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ox = __shfl_up_sync(0xffffffffu, v.x, d), oy = __shfl_up_sync(0xffffffffu, v.y, d);
    if (lane >= d) {
      const float p = pw[d];
      v.x = fmaf(p, ox, v.x);
      v.y = fmaf(p, oy, v.y);
    }
  }
  if (lane == 31) wt[w] = v;
  __syncthreads();
  const float p32 = pw[32], pl = pw[lane + 1];
  float2 P = make_float2(0.f, 0.f);  // the inclusive scan at the end of warp w − 1
  for (int u = 0; u < w; ++u) {
    const float2 o = wt[u];
    P = make_float2(fmaf(p32, P.x, o.x), fmaf(p32, P.y, o.y));
  }
  const float2 inc = make_float2(fmaf(pl, P.x, v.x), fmaf(pl, P.y, v.y));
  float2 ex = make_float2(__shfl_up_sync(0xffffffffu, inc.x, 1),
                          __shfl_up_sync(0xffffffffu, inc.y, 1));
  return lane == 0 ? P : ex;
}

// The DC blocker y = r·y + g·(x − x_prev) over planes entries b+1 .. b+len
// (entry b is the sample before) from carry y; `rec` receives y after `at`
// samples (0 < at <= len), if any.
__device__ __forceinline__ float2 dc_run(const float* Xr, const float* Xi, int b, int len,
                                         float r, float g, float2 y, int at, float2& rec) {
  float xr = Xr[pidx(b)], xi = Xi[pidx(b)];
#pragma unroll 4
  for (int i = 1; i <= len; ++i) {
    const float vr = Xr[pidx(b + i)], vi = Xi[pidx(b + i)];
    y.x = r * y.x + g * (vr - xr);
    y.y = r * y.y + g * (vi - xi);
    xr = vr;
    xi = vi;
    if (i == at) rec = y;
  }
  return y;
}

// (a1) Grid: one block per chunk of C = blockDim.x·spt samples.  Shared
// memory: two planes of C+1 samples, then blockDim.x scan entries.
__global__ void dc_chunk(int mode, const void* __restrict__ x0, const void* __restrict__ x1,
                         int spt, float r, float g, const float* __restrict__ pow_thr,
                         const float2* __restrict__ xlast_in, int vec, int o_h, float r_loc,
                         float2* __restrict__ chunk_end, float2* __restrict__ partial) {
  extern __shared__ float sm[];
  const int t = threadIdx.x, C = blockDim.x * spt;
  const int pl = plane_len(C + 1);
  float* Xr = sm;
  float* Xi = sm + pl;
  float2* sc = reinterpret_cast<float2*>(sm + 2 * pl);
  const long long c0 = (long long)blockIdx.x * C;
  if (t == 0) {
    const float2 xp = c0 == 0 ? *xlast_in : load_sample(mode, x0, x1, c0 - 1);
    Xr[0] = xp.x;
    Xi[0] = xp.y;
  }
  stage(mode, x0, x1, c0, C, vec != 0, Xr, Xi, 1);
  __syncthreads();

  // zero-carry solve of this thread's segment; thread o_h / spt also keeps
  // its value after o_h % spt samples
  const int th = o_h / spt, loc = o_h - th * spt;
  float2 rec = make_float2(0.f, 0.f);
  sc[t] = dc_run(Xr, Xi, t * spt, spt, r, g, make_float2(0.f, 0.f), t == th ? loc : 0, rec);
  __syncthreads();
  decay_scan(sc, pow_thr);
  if (t == blockDim.x - 1) chunk_end[blockIdx.x] = sc[t];
  // the chunk's zero-carry value after o_h samples (0 when o_h = 0)
  if (t == th) {
    float2 p = rec;
    if (t > 0) {
      p.x += r_loc * sc[t - 1].x;
      p.y += r_loc * sc[t - 1].y;
    }
    partial[blockIdx.x] = p;
  }
}

// (a2) One block of kScanThreads threads; thread t owns chunks [t·m, t·m+m).
__global__ void carry_scan(const float2* __restrict__ chunk_end, int n_chunks, int m, float rC,
                           const float* __restrict__ pow_blk,  // r^(C·m·j), j = 0..kScanThreads
                           const float2* __restrict__ ydc_in, float2* __restrict__ chunk_in,
                           float2* __restrict__ ydc_out, const float* __restrict__ phase_in,
                           float phase_inc, float* __restrict__ phase_out) {
  __shared__ float2 sc[kScanThreads];
  const int t = threadIdx.x;
  const int k0 = min(t * m, n_chunks);
  const int k1 = min(k0 + m, n_chunks);
  float2 e = make_float2(0.f, 0.f);
  for (int k = k0; k < k1; ++k) {
    const float2 w = chunk_end[k];
    e.x = rC * e.x + w.x;
    e.y = rC * e.y + w.y;
  }
  sc[t] = e;
  __syncthreads();
  decay_scan(sc, pow_blk);

  const float2 y0 = *ydc_in;
  const float pt = pow_blk[t];
  float2 G = make_float2(pt * y0.x, pt * y0.y);
  if (t > 0) {
    G.x += sc[t - 1].x;
    G.y += sc[t - 1].y;
  }
  for (int k = k0; k < k1; ++k) {
    chunk_in[k] = G;
    const float2 w = chunk_end[k];
    G.x = rC * G.x + w.x;
    G.y = rC * G.y + w.y;
  }
  if (k0 < k1 && k1 == n_chunks) *ydc_out = G;
  if (t == 0) *phase_out = fmodf(*phase_in + phase_inc, kTwoPi);
}

// the 16-byte chunks of samples s0 .. s0+count-1 of each input plane into
// the staging buffer pre (plane 1 at pre + plane_bytes), all threads of the
// block, in flight until cp_async_wait; the wrapper's vec rule makes s0 and
// count multiples of 16 samples and the planes 16-byte aligned
__device__ __forceinline__ void prefetch(int mode, const void* x0, const void* x1, long long s0,
                                         int count, unsigned char* pre, int plane_bytes) {
  const int per = mode == kComplex ? 8 : mode == kU8Interleaved ? 2 : 1;
  const int chunks = count * per / 16;
  const unsigned char* src = static_cast<const unsigned char*>(x0) + s0 * per;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async<16>(pre + 16 * i, src + 16 * i, true);
  if (mode == kU8Planes) {
    const unsigned char* src1 = static_cast<const unsigned char*>(x1) + s0;
    for (int i = threadIdx.x; i < chunks; i += blockDim.x)
      cp_async<16>(pre + plane_bytes + 16 * i, src1 + 16 * i, true);
  }
  cp_async_commit();
}

// sample j of the staging buffer (plane 1, u8 planes only, at pre + plane)
__device__ __forceinline__ float2 staged(int mode, const unsigned char* pre, int plane, int j) {
  if (mode == kComplex) return reinterpret_cast<const float2*>(pre)[j];
  if (mode == kU8Interleaved) {
    const uchar2 v = reinterpret_cast<const uchar2*>(pre)[j];
    return make_float2(u8f(v.x), u8f(v.y));
  }
  return make_float2(u8f(pre[j]), u8f(pre[plane + j]));
}

// samples b .. b+len−1 of the staging buffer into v[0 .. len): 16-byte
// loads when len = kSeg (b is then a multiple of 16)
__device__ __forceinline__ void staged_seg(int mode, const unsigned char* pre, int plane, int b,
                                           int len, float2 (&v)[kSeg]) {
  if (len == kSeg) {
    if (mode == kU8Interleaved) {
      const uint4* p = reinterpret_cast<const uint4*>(pre + 2 * b);
      const uint4 a = p[0], c = p[1];
      const unsigned w[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[2 * j] = make_float2(u8b(w[j], 0), u8b(w[j], 1));
        v[2 * j + 1] = make_float2(u8b(w[j], 2), u8b(w[j], 3));
      }
      return;
    }
    if (mode == kU8Planes) {
      const uint4 a = *reinterpret_cast<const uint4*>(pre + b);
      const uint4 c = *reinterpret_cast<const uint4*>(pre + plane + b);
      const unsigned wa[4] = {a.x, a.y, a.z, a.w}, wc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = make_float2(u8b(wa[j / 4], j % 4), u8b(wc[j / 4], j % 4));
      return;
    }
    const float4* p = reinterpret_cast<const float4*>(pre + 8 * b);
#pragma unroll
    for (int j = 0; j < kSeg / 2; ++j) {
      const float4 a = p[j];
      v[2 * j] = make_float2(a.x, a.y);
      v[2 * j + 1] = make_float2(a.z, a.w);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j)
    if (j < len) v[j] = staged(mode, pre, plane, b + j);
}

// (b) A persistent walk over runs of tiles: block b owns tiles [b·run,
// min(b·run + run, ceil(F/TF))) of TF frames each (the last tile of the
// block may be short) and writes their audio[k, f].  P, G: nch = P·G a
// power of two <= 64 (G lanes per frame, P points each); P = 0: any nch,
// direct DFT.  Shared memory: see ChannelLayout.  S row j holds frame
// f0 − (L+1) + j of the tile at f0; after the DFT its rows 0..nf hold the
// DFT of frames f0 − 1 .. f0 + nf − 1.  U row t is frame f0 − 1 + t.  A run's
// first tile computes U and the DFT from row 0 (the frame before the tile);
// a later tile finds the DFT of that frame in S row 0 and its FIR halo in
// rows 1..L, both carried from the tile before, and starts at row 1.
template <int P, int G>
__global__ void __launch_bounds__(kChannelThreads, 2)
    channel_tile(int mode, const void* __restrict__ x0, const void* __restrict__ x1, int nch,
                 int L, int TF, int run, int C, int spt_a, int spt_b, int vec, float r, float g,
                 const float* __restrict__ pow_rep,  // r^(spt_a·t), then r^(spt_b·t), t <= 256
                 const float2* __restrict__ chunk_in, const float2* __restrict__ partial,
                 float r_oh, const float* __restrict__ phase_in, const float* __restrict__ ramp2,
                 const float2* __restrict__ hist_in, const float2* __restrict__ xlast_in,
                 const float2* __restrict__ ydc_in, const float* __restrict__ taps_hat,
                 const float2* __restrict__ twiddle, long long F, float inv_kf,
                 float* __restrict__ audio, float2* __restrict__ hist_out,
                 float2* __restrict__ xlast_out) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __shared__ float2 carry[2];  // the last raw sample and the DC output at it
  const ChannelLayout lay(mode, nch, L, TF, vec);
  unsigned char* pre = smem_bytes;
  float2* A = reinterpret_cast<float2*>(smem_bytes + lay.pre_bytes);
  float* Xr = reinterpret_cast<float*>(A);
  float* Xi = Xr + lay.pl;
  float2* U = A;
  float2* S = A + lay.a_len;
  float2* rot = S + lay.s_len;
  float2* tw = rot + rot_len(nch);
  float* taps = reinterpret_cast<float*>(tw + nch);
  const int ld = s_ld(nch), ldU = u_ld(nch);
  const bool skew = s_skew(nch);
  auto col = [skew](int q) { return skew ? q + 4 * (q >> 4) : q; };
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long n = F * nch;
  const long long tiles = (F + TF - 1) / TF;
  const long long t_first = (long long)blockIdx.x * run;
  const long long t_last = min(t_first + run, tiles) - 1;
  const int pre_plane = TF * nch;  // bytes between the u8 planes' staging

  // --- the run's first range: raw samples [s_r − 1, e) of its halo and
  // first tile, and the carry entering s_r
  long long f0 = t_first * TF;
  int nf = (int)min((long long)TF, F - f0);
  const long long s_h = (f0 - (L + 1)) * nch;  // halo start
  const long long s_r = s_h > 0 ? s_h : 0;
  int R = (int)((f0 + nf) * nch - s_r);
  float2 y0;
  if (s_h <= 0) {
    y0 = *ydc_in;
  } else {
    const long long c = s_h / C;
    const float2 gi = chunk_in[c], pa = partial[c];
    y0 = make_float2(r_oh * gi.x + pa.x, r_oh * gi.y + pa.y);
  }
  // the first kIn·blockDim raw samples go in flight before the tables load,
  // so their latencies overlap
  constexpr int kIn = 12;
  {
    float2 xin[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j)
      if (tid + j * nt < R) xin[j] = load_sample(mode, x0, x1, s_r + tid + j * nt);
    if (tid == 0) {
      const float2 xp = s_r == 0 ? *xlast_in : load_sample(mode, x0, x1, s_r - 1);
      Xr[0] = xp.x;
      Xi[0] = xp.y;
    }
    copy_in(taps, taps_hat, (L + 1) * nch);
    copy_in(tw, twiddle, nch);
    const float ph = *phase_in;
    for (int k = tid; k < 2 * nch; k += nt) {
      float sn, cs;
      sincosf(ramp2[k] + ph, &sn, &cs);
      rot[rot_at(k)] = make_float2(cs, sn);
    }
#pragma unroll
    for (int j = 0; j < kIn; ++j)
      if (tid + j * nt < R) {
        Xr[pidx(1 + tid + j * nt)] = xin[j].x;
        Xi[pidx(1 + tid + j * nt)] = xin[j].y;
      }
  }
  if (R > kIn * nt) stage(mode, x0, x1, s_r + kIn * nt, R - kIn * nt, false, Xr, Xi, 1 + kIn * nt);
  // frames before the stream's first sample (rows < L + 1 − f0) come from hist
  const int h_rows = (int)max(0LL, min((long long)(nf + L + 1), L + 1 - f0));
  for (int i = tid; i < h_rows * nch; i += nt) {
    const int row = i / nch, q = i - row * nch;
    S[row * ld + col(q)] = hist_in[(f0 + row) * nch + q];
  }
  __syncthreads();

  for (long long ti = t_first;; ++ti) {
    const bool first = ti == t_first, more = ti < t_last;
    const long long s0 = first ? s_r : f0 * nch;  // X[1 + j] is sample s0 + j
    const int E = nf + L + 1;                     // S rows of this tile
    const int u0 = first ? 0 : 1;                 // first U / DFT row computed

    // DC: zero-carry segments, a scan, then the replay from the exact
    // carry, rotated by the NCO, into S.  A later tile with staged bytes
    // keeps its segment in registers: read once from the staging buffer,
    // solved with zero carry in place, then y = y_zero + r^(i+1)·carry.
    // Otherwise the segments are read and replayed from the X planes.
    const bool regs = vec && !first && spt_b <= kSeg;
    const int spt = first ? spt_a : spt_b;
    const float* pw = pow_rep + (first ? 0 : kChannelThreads + 1);
    if (!first) y0 = carry[1];
    const int b = min(tid * spt, R), len = min(spt, R - b);
    float2 v[kSeg], xl = make_float2(0.f, 0.f), e;
    if (regs) {
      staged_seg(mode, pre, pre_plane, b, len, v);
      float2 xp = b == 0 ? carry[0] : staged(mode, pre, pre_plane, b - 1);
      float2 y = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kSeg; ++i)
        if (i < len) {
          y.x = r * y.x + g * (v[i].x - xp.x);
          y.y = r * y.y + g * (v[i].y - xp.y);
          xp = v[i];
          v[i] = y;
        }
      xl = xp;
      e = y;
    } else {
      float2 unused;
      e = dc_run(Xr, Xi, b, len, r, g, make_float2(0.f, 0.f), 0, unused);
      if (len > 0) xl = make_float2(Xr[pidx(b + len)], Xi[pidx(b + len)]);
    }
    e = decay_prefix(e, pw);
    {
      const float pt = pw[tid];
      float2 y = make_float2(fmaf(pt, y0.x, e.x), fmaf(pt, y0.y, e.y));
      const long long s = s0 + b;
      int k = (int)(s % (2 * nch));
      int q = (int)(s % nch);
      int row = (int)(s / nch - (f0 - (L + 1)));
      auto put = [&](float2 yv) {
        const float2 c = rot[rot_at(k)];  // multiply by e^{−jθ}
        S[row * ld + col(q)] = make_float2(yv.x * c.x + yv.y * c.y, yv.y * c.x - yv.x * c.y);
        if (++k == 2 * nch) k = 0;
        if (++q == nch) {
          q = 0;
          ++row;
        }
      };
      if (regs && len == kSeg && nch % kSeg == 0) {
        // the segment is 16 columns of one row and 16 entries of one
        // 16-entry group of the NCO table: constant offsets
        float2* dst = S + row * ld + col(q);
        const float2* rk = rot + rot_at(k);
        float2 cy = y;
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          cy.x *= r;
          cy.y *= r;
          y = make_float2(v[i].x + cy.x, v[i].y + cy.y);
          const float2 c = rk[i];
          dst[i] = make_float2(y.x * c.x + y.y * c.y, y.y * c.x - y.x * c.y);
        }
      } else if (regs) {
        float2 cy = y;
#pragma unroll
        for (int i = 0; i < kSeg; ++i)
          if (i < len) {
            cy.x *= r;
            cy.y *= r;
            y = make_float2(v[i].x + cy.x, v[i].y + cy.y);
            put(y);
          }
      } else {
        float xr = Xr[pidx(b)], xi = Xi[pidx(b)];
#pragma unroll 4
        for (int i = 1; i <= len; ++i) {
          const float vr = Xr[pidx(b + i)], vi = Xi[pidx(b + i)];
          y.x = r * y.x + g * (vr - xr);
          y.y = r * y.y + g * (vi - xi);
          xr = vr;
          xi = vi;
          put(y);
        }
      }
      if (len > 0 && b + len == R) {  // the carries into the next tile
        carry[0] = xl;
        carry[1] = y;
        if (s0 + R == n) *xlast_out = xl;
      }
    }
    __syncthreads();
    // the next tile's raw bytes go in flight: every thread has read its
    // segment of the staging buffer (before the scan's barrier)
    if (vec && more)
      prefetch(mode, x0, x1, (f0 + TF) * nch, (int)min((long long)TF, F - f0 - TF) * nch, pre,
               pre_plane);

    // the new hist is frames F−L−1 .. F−1 (rows >= F − f0); each frame is
    // written once, by the tile that owns it (frames before the stream: by
    // the run at frame 0)
    const int o_row = (int)max(0LL, min((long long)E, F - f0));
    for (int i = tid; i < (E - o_row) * nch; i += nt) {
      const int row = o_row + i / nch, q = i % nch;
      const long long fr = f0 - (L + 1) + row;
      if (fr >= f0 || (f0 == 0 && fr < 0))
        hist_out[(fr - (F - L - 1)) * nch + q] = S[row * ld + col(q)];
    }

    // --- branch FIR: U rows u0..nf from S rows u0..nf+L; a thread walks
    // kRun frames of one branch, its window a register ring: at tap J,
    // win[(p − J) mod kRun] holds S row t0 + p + L − J
    const int runs = (nf + 1 - u0 + kRun - 1) / kRun;
    for (int it = tid; it < nch * runs; it += nt) {
      const int q = it % nch, t0 = u0 + (it / nch) * kRun, qc = col(q);
      float2 win[kRun], acc[kRun];
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        const int row = t0 + p + L;
        win[p] = row < E ? S[row * ld + qc] : make_float2(0.f, 0.f);
        acc[p] = make_float2(0.f, 0.f);
      }
      float c = taps[q];
      for (int J0 = 0; J0 <= L; J0 += kRun) {
#pragma unroll
        for (int jj = 0; jj < kRun; ++jj) {
          const int J = J0 + jj;
          if (J > L) break;
          // tap J + 1 and window row t0 + L − J − 1 load before tap J's MACs
          float cn = 0.f;
          float2 nx = make_float2(0.f, 0.f);
          if (J < L) {
            cn = taps[(J + 1) * nch + q];
            nx = S[(t0 + L - J - 1) * ld + qc];
          }
#pragma unroll
          for (int p = 0; p < kRun; ++p) {
            const float2 w = win[(p - jj) & (kRun - 1)];
            acc[p].x = fmaf(c, w.x, acc[p].x);
            acc[p].y = fmaf(c, w.y, acc[p].y);
          }
          win[(kRun - 1 - jj) & (kRun - 1)] = nx;
          c = cn;
        }
      }
#pragma unroll
      for (int p = 0; p < kRun; ++p)
        if (t0 + p <= nf) U[(t0 + p) * ldU + q] = acc[p];
    }
    __syncthreads();

    // --- DFT over branches into S rows u0..nf: d[t,k] = sum_q U[t,q]·W^{kq}
    if (P > 0) {
      constexpr int PP = P > 0 ? P : 1;
      const int l = tid % G;
      for (int base = u0; base <= nf; base += kChannelThreads / G) {  // uniform
        const int t = base + tid / G;
        const bool ok = t <= nf;
        float2 v[PP];
#pragma unroll
        for (int m = 0; m < PP; ++m) v[m] = ok ? U[t * ldU + l + G * m] : make_float2(0.f, 0.f);
        dft_reg<PP, false>(v);  // v[rev(k1)] = sum_m u[l + G m]·W_P^{m k1}
        if (G > 1) {
#pragma unroll
          for (int k1 = 1; k1 < PP; ++k1)
            v[rev_bits(k1, PP)] = cmul(v[rev_bits(k1, PP)], tw[l * k1]);
#pragma unroll
          for (int i = 0; i < PP; ++i) {  // radix-G across the lanes
            float2 a = v[i];
            if (G == 4) {
              float2 o = make_float2(__shfl_xor_sync(0xffffffffu, a.x, 2),
                                     __shfl_xor_sync(0xffffffffu, a.y, 2));
              a = (l & 2) ? make_float2(o.x - a.x, o.y - a.y) : make_float2(a.x + o.x, a.y + o.y);
              if (l == 3) a = make_float2(a.y, -a.x);  // × −i
            }
            const float2 o = make_float2(__shfl_xor_sync(0xffffffffu, a.x, 1),
                                         __shfl_xor_sync(0xffffffffu, a.y, 1));
            v[i] = (l & 1) ? make_float2(o.x - a.x, o.y - a.y) : make_float2(a.x + o.x, a.y + o.y);
          }
        }
        // lane l holds k2 = rev(l) over G: d[k1 + P·k2]
        const int k2 = G == 4 ? ((l & 1) << 1) | (l >> 1) : l;
        if (ok) {
          float2* d = S + t * ld + col(PP * k2);  // k1 < PP <= 16: one skew a lane
#pragma unroll
          for (int k1 = 0; k1 < PP; ++k1) d[k1] = v[rev_bits(k1, PP)];
        }
      }
    } else {
      constexpr int KB = 2, FB = 4;
      const int nkb = (nch + KB - 1) / KB, nfb = (nf + 1 - u0 + FB - 1) / FB;
      for (int it = tid; it < nkb * nfb; it += nt) {
        const int k0 = (it % nkb) * KB, t0 = u0 + (it / nkb) * FB;
        int kk[KB], idx[KB];
        float2 acc[KB][FB];
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          kk[i] = k0 + i < nch ? k0 + i : 0;
          idx[i] = 0;
#pragma unroll
          for (int j = 0; j < FB; ++j) acc[i][j] = make_float2(0.f, 0.f);
        }
        for (int q = 0; q < nch; ++q) {
          float2 u[FB];
#pragma unroll
          for (int j = 0; j < FB; ++j)
            u[j] = t0 + j <= nf ? U[(t0 + j) * ldU + q] : make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            const float2 w = tw[idx[i]];
#pragma unroll
            for (int j = 0; j < FB; ++j) {
              acc[i][j].x = fmaf(u[j].x, w.x, fmaf(-u[j].y, w.y, acc[i][j].x));
              acc[i][j].y = fmaf(u[j].x, w.y, fmaf(u[j].y, w.x, acc[i][j].y));
            }
            idx[i] += kk[i];
            if (idx[i] >= nch) idx[i] -= nch;
          }
        }
#pragma unroll
        for (int i = 0; i < KB; ++i)
#pragma unroll
          for (int j = 0; j < FB; ++j)
            if (k0 + i < nch && t0 + j <= nf) S[(t0 + j) * ld + col(k0 + i)] = acc[i][j];
      }
    }
    __syncthreads();

    // --- FM demod: arg(d[t]·conj(d[t−1])) / (2π·kf), channel-major out;
    // output i = k·nf + t, a warp's outputs consecutive frames of a channel.
    // Where nf divides the block, a thread keeps its frame t and steps the
    // channels; else it steps (k, t) by nt without a division per output.
    {
      const int dk = nt / nf, dt = nt - dk * nf;
      int k = tid / nf, t = tid - k * nf;
      if (dt == 0) {
        const float2* pa = S + (t + 1) * ld;
        const float2* pb = S + t * ld;
        float* out = audio + (long long)k * F + f0 + t;
        const long long step = (long long)dk * F;
#pragma unroll 4
        for (; k < nch; k += dk, out += step) {
          const float2 a = pa[col(k)], b2 = pb[col(k)];
          *out = atan2_poly(a.y * b2.x - a.x * b2.y, a.x * b2.x + a.y * b2.y) * inv_kf;
        }
      } else {
        while (k < nch) {
          const float2 a = S[(t + 1) * ld + col(k)], b2 = S[t * ld + col(k)];
          audio[(long long)k * F + f0 + t] =
              atan2_poly(a.y * b2.x - a.x * b2.y, a.x * b2.x + a.y * b2.y) * inv_kf;
          k += dk;
          t += dt;
          if (t >= nf) {
            t -= nf;
            ++k;
          }
        }
      }
    }
    if (!more) break;
    __syncthreads();

    // --- into the next tile: S rows nf..nf+L (the last DFT frame, then the
    // FIR halo) move to rows 0..L (nf = TF > L: the ranges do not overlap),
    // and its raw samples into X, the sample before from the carry
    for (int i = tid; i < (L + 1) * ld; i += nt) S[i] = S[nf * ld + i];
    f0 += TF;
    nf = (int)min((long long)TF, F - f0);
    R = nf * nch;
    if (vec) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!(vec && spt_b <= kSeg)) {  // the next tile's DC reads the X planes
      if (vec) stage(mode, pre, pre + pre_plane, 0, R, true, Xr, Xi, 1);
      else stage(mode, x0, x1, f0 * nch, R, false, Xr, Xi, 1);
      if (tid == 0) {
        Xr[0] = carry[0].x;
        Xi[0] = carry[0].y;
      }
      __syncthreads();
    }
  }
}

// channel_tile<P, G> of nch, for f(kernel)
template <typename Fn>
cudaError_t with_channel_kernel(int nch, Fn f) {
  switch (nch) {
    case 2: return f(&channel_tile<2, 1>);
    case 4: return f(&channel_tile<4, 1>);
    case 8: return f(&channel_tile<8, 1>);
    case 16: return f(&channel_tile<16, 1>);
    case 32: return f(&channel_tile<16, 2>);
    case 64: return f(&channel_tile<16, 4>);
    default: return f(&channel_tile<0, 1>);
  }
}

}  // namespace

// One fused step.  Launches the three kernels on `stream`, in order, and
// returns the first nonzero cudaGetLastError() (0 when all launched).
// Shapes: n samples, F = n/nch frames, tileF | TF (frames per tile; the
// last tile of the stream may be shorter, a multiple of tileF), TF > L
// where F has more than one tile, run tiles per channel block,
// spt·nthr = C = tileF·nch with nthr <= 1024, n_chunks = n/C <= 1024·m;
// spt_a·256 >= (TF + L + 1)·nch, spt_b·256 >= TF·nch; o_h = −(L+1)·nch
// mod C, r_loc = r^(o_h mod spt), r_oh = r^o_h.  Scratch: chunk_end,
// chunk_in and partial (n_chunks complex each).
extern "C" int csdr_flagship_fused(
    int mode, const void* x0, const void* x1, long long n, int nch, int L, int tileF, int TF,
    int run, int spt, int m, int spt_a, int spt_b, int o_h, int vec, float r, float g, float rC,
    float r_loc, float r_oh, float inv_kf, float phase_inc, const void* taps_hat,
    const void* twiddle, const void* ramp2, const void* pow_thr, const void* pow_blk,
    const void* pow_rep, const void* phase_in, const void* hist_in, const void* xlast_in,
    const void* ydc_in, void* phase_out, void* hist_out, void* xlast_out, void* ydc_out,
    void* chunk_end, void* chunk_in, void* partial, void* audio, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = tileF * nch;
  const int n_chunks = (int)(n / C);
  const int nthr = C / spt;
  const long long F = n / nch;
  auto c2 = [](const void* p) { return static_cast<const float2*>(p); };
  auto m2 = [](void* p) { return static_cast<float2*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };

  const size_t smem_a = 2 * sizeof(float) * plane_len(C + 1) + sizeof(float2) * nthr;
  cudaError_t e = allow_smem(&dc_chunk, smem_a);
  if (e != cudaSuccess) return e;
  dc_chunk<<<n_chunks, nthr, smem_a, st>>>(mode, x0, x1, spt, r, g, cf(pow_thr), c2(xlast_in),
                                           vec, o_h, r_loc, m2(chunk_end), m2(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  carry_scan<<<1, kScanThreads, 0, st>>>(c2(chunk_end), n_chunks, m, rC, cf(pow_blk), c2(ydc_in),
                                         m2(chunk_in), m2(ydc_out), cf(phase_in), phase_inc,
                                         static_cast<float*>(phase_out));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem = ChannelLayout(mode, nch, L, TF, vec).bytes;
  const unsigned grid = (unsigned)(((F + TF - 1) / TF + run - 1) / run);
  return with_channel_kernel(nch, [&](auto kernel) {
    const cudaError_t a = allow_smem(kernel, smem);
    if (a != cudaSuccess) return a;
    kernel<<<grid, kChannelThreads, smem, st>>>(
        mode, x0, x1, nch, L, TF, run, C, spt_a, spt_b, vec, r, g, cf(pow_rep), c2(chunk_in),
        c2(partial), r_oh, cf(phase_in), cf(ramp2), c2(hist_in), c2(xlast_in), c2(ydc_in),
        cf(taps_hat), c2(twiddle), F, inv_kf, static_cast<float*>(audio), m2(hist_out),
        m2(xlast_out));
    return cudaGetLastError();
  });
}

extern "C" int csdr_scan_threads() { return kScanThreads; }
extern "C" int csdr_channel_threads() { return kChannelThreads; }
extern "C" long long csdr_channel_smem(int mode, int nch, int L, int TF, int vec) {
  return (long long)ChannelLayout(mode, nch, L, TF, vec).bytes;
}
// channel blocks resident on the current device at once: its SMs times the
// blocks of channel_tile<P, G> of nch that fit on one (0 where none fits)
extern "C" int csdr_channel_slots(int mode, int nch, int L, int TF, int vec) {
  const size_t smem = ChannelLayout(mode, nch, L, TF, vec).bytes;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const cudaError_t e = with_channel_kernel(nch, [&](auto kernel) {
    const cudaError_t a = allow_smem(kernel, smem);
    if (a != cudaSuccess) return a;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kChannelThreads, smem);
  });
  return e == cudaSuccess ? sms * per_sm : 0;
}
