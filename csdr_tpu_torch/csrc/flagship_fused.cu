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
//   (b)  channel_tile one block per tb frames (a run of q tiles, q·tileF·nch
//        <= 2048 samples where F allows, so small nch pay the halo and the
//        block's fixed costs less often).  Prologue: the DC
//        and NCO replay.  The tile needs the DC-blocked, NCO-shifted samples
//        of its own frames and of the L+1 frames before them (its halo); it
//        stages the raw samples once, takes the carry entering the halo as
//        r^{o_h}·g[c] + partial[c] (or y_dc_last and hist for the first
//        tiles), solves per-thread segments with zero carry, scans, replays
//        each segment from its exact carry and rotates it by the NCO (a
//        2·nch-entry table: the pre-shift −π(nch−1)/nch has period 2·nch
//        samples; cos/sin of a float64-made ramp plus the carried phase).
//        No shifted samples leave the block.  Then the permuted-tap branch
//        FIR (u[i,p=(nch-q)%nch] = sum_J T^[J,q]·s[i-J,q]): one thread per
//        branch q walks a run of 11 frames with the window in registers, one
//        shared-memory load per run of complex-by-real MACs.  Then the DFT
//        d[i,k] = sum_q u^[i,q]·e^{-j2πkq/nch}: for nch = P·G a power of two
//        <= 64, G lanes per frame each run a P-point FFT in registers and a
//        radix-G pass across the lanes with __shfl_xor_sync; for any other
//        nch a direct DFT blocked as 2 channels x 2 frames per thread.  Last
//        the conjugate-product demod with atan2f, written channel-major
//        (nch, F).  The tile recomputes the DFT of the frame before it, so
//        the demod needs no state beyond hist.
// No TF32, no bf16 split: every product is an FP32 FMA.  Every power of r
// comes from a float64 host table or argument.

#include <cuda_runtime.h>

#include "fft_reg.cuh"

namespace {

using namespace csdr;

constexpr int kScanThreads = 1024;    // threads of the one-block carry scan
constexpr int kChannelThreads = 256;  // threads per channel-tile block
constexpr int kRun = 11;              // frames per FIR thread
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

// bytes of channel_tile's shared memory; the wrapper checks the limit with
// it through csdr_channel_smem
__host__ __device__ inline size_t channel_smem(int nch, int L, int TF) {
  const int rmax = TF * nch + (L + 1) * nch;
  const size_t x = 2 * sizeof(float) * (size_t)plane_len(rmax + 1);
  const size_t u = sizeof(float2) * (size_t)(TF + 1) * u_ld(nch);
  return (x > u ? x : u) + sizeof(float2) * ((size_t)(TF + L + 1) * (nch + 1) + 3 * nch +
                                             kChannelThreads) +
         sizeof(float) * (size_t)(L + 1) * nch;
}

__device__ __forceinline__ float u8f(unsigned v) { return (float)v * (1.0f / 127.5f) - 1.0f; }

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

// Samples s0 .. s0+count-1 into planes Xr/Xi at off .. off+count-1, all
// threads of the block.  vec: 16-byte loads (the wrapper checks that the
// pointers are 16-byte aligned and that s0 and count are multiples of 16).
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
        Xr[pidx(o)] = u8f(w[j] & 255u); Xi[pidx(o)] = u8f((w[j] >> 8) & 255u);
        Xr[pidx(o + 1)] = u8f((w[j] >> 16) & 255u); Xi[pidx(o + 1)] = u8f(w[j] >> 24);
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
        Xr[pidx(off + 16 * i + j)] = u8f((wa[j / 4] >> (8 * (j % 4))) & 255u);
        Xi[pidx(off + 16 * i + j)] = u8f((wb[j / 4] >> (8 * (j % 4))) & 255u);
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

// (b) One block per tile of TF frames; writes audio[k, f0 .. f0+TF).  P, G:
// nch = P·G a power of two <= 64 (G lanes per frame, P points each); P = 0:
// any nch, direct DFT.  Shared memory: see channel_smem.
template <int P, int G>
__global__ void __launch_bounds__(kChannelThreads, 4)
    channel_tile(int mode, const void* __restrict__ x0, const void* __restrict__ x1, int nch,
                 int L, int TF, int C, int spt2, float r, float g,
                 const float* __restrict__ pow_rep,  // r^(spt2·t), t = 0..kChannelThreads
                 const float2* __restrict__ chunk_in, const float2* __restrict__ partial,
                 float r_oh, const float* __restrict__ phase_in, const float* __restrict__ ramp2,
                 const float2* __restrict__ hist_in, const float2* __restrict__ xlast_in,
                 const float2* __restrict__ ydc_in, const float* __restrict__ taps_hat,
                 const float2* __restrict__ twiddle, long long F, float inv_kf,
                 float* __restrict__ audio, float2* __restrict__ hist_out,
                 float2* __restrict__ xlast_out) {
  extern __shared__ float2 smem[];
  const int E = TF + L + 1;
  const int ld = nch + 1, ldU = u_ld(nch);
  const int halo = (L + 1) * nch;
  const int pl = plane_len(TF * nch + halo + 1);
  const int u_len = (TF + 1) * ldU;
  const int a_len = pl > u_len ? pl : u_len;  // float2 units
  float* Xr = reinterpret_cast<float*>(smem);
  float* Xi = Xr + pl;
  float2* U = smem;
  float2* S = smem + a_len;  // frames, later the DFT rows
  float2* rot = S + (size_t)E * ld;
  float2* tw = rot + 2 * nch;
  float2* sc = tw + nch;
  float* taps = reinterpret_cast<float*>(sc + kChannelThreads);
  const int tid = threadIdx.x;
  const long long f0 = (long long)blockIdx.x * TF;
  const long long n = F * nch;

  // --- prologue: raw samples [s_r − 1, e) and the carry entering s_r
  const long long s_h = (f0 - (L + 1)) * nch;  // halo start
  const long long s_r = s_h > 0 ? s_h : 0;
  const long long e_s = (f0 + TF) * nch;
  const int R = (int)(e_s - s_r);
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
  const int nt = blockDim.x;
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
  {
    const float ph = *phase_in;
    for (int k = tid; k < 2 * nch; k += nt) {
      float sn, cs;
      sincosf(ramp2[k] + ph, &sn, &cs);
      rot[k] = make_float2(cs, sn);
    }
  }
#pragma unroll
  for (int j = 0; j < kIn; ++j)
    if (tid + j * nt < R) {
      Xr[pidx(1 + tid + j * nt)] = xin[j].x;
      Xi[pidx(1 + tid + j * nt)] = xin[j].y;
    }
  if (R > kIn * nt) stage(mode, x0, x1, s_r + kIn * nt, R - kIn * nt, false, Xr, Xi, 1 + kIn * nt);
  // frames before the block's first sample (rows < L + 1 − f0) come from hist
  const int h_rows = (int)max(0LL, min((long long)E, L + 1 - f0));
  for (int i = tid; i < h_rows * nch; i += blockDim.x) {
    const int row = i / nch, q = i - row * nch;
    S[row * ld + q] = hist_in[(f0 + row) * nch + q];
  }
  __syncthreads();
  if (tid == 0 && e_s == n) *xlast_out = make_float2(Xr[pidx(R)], Xi[pidx(R)]);

  // DC: zero-carry segments of spt2, a scan, then the replay from the exact
  // carry, rotated by the NCO, into S
  const int b = min(tid * spt2, R), len = min(spt2, R - b);
  float2 unused;
  sc[tid] = dc_run(Xr, Xi, b, len, r, g, make_float2(0.f, 0.f), 0, unused);
  __syncthreads();
  decay_scan(sc, pow_rep);
  {
    const float pt = pow_rep[tid];
    float2 y = make_float2(pt * y0.x, pt * y0.y);
    if (tid > 0) {
      y.x += sc[tid - 1].x;
      y.y += sc[tid - 1].y;
    }
    const long long s = s_r + b;
    int k = (int)(s % (2 * nch));
    int q = (int)(s % nch);
    int row = (int)(s / nch - (f0 - (L + 1)));
    float xr = Xr[pidx(b)], xi = Xi[pidx(b)];
#pragma unroll 4
    for (int i = 1; i <= len; ++i) {
      const float vr = Xr[pidx(b + i)], vi = Xi[pidx(b + i)];
      y.x = r * y.x + g * (vr - xr);
      y.y = r * y.y + g * (vi - xi);
      xr = vr;
      xi = vi;
      const float2 c = rot[k];  // multiply by e^{−jθ}
      S[row * ld + q] = make_float2(y.x * c.x + y.y * c.y, y.y * c.x - y.x * c.y);
      if (++k == 2 * nch) k = 0;
      if (++q == nch) {
        q = 0;
        ++row;
      }
    }
  }
  __syncthreads();

  // the new hist is frames F−L−1 .. F−1 (rows >= F − f0); each frame is
  // written once, by the tile that owns it (frames before this block: by
  // tile 0)
  const int o_row = (int)max(0LL, min((long long)E, F - f0));
  for (int i = tid; i < (E - o_row) * nch; i += blockDim.x) {
    const int row = o_row + i / nch, q = i % nch;
    const long long fr = f0 - (L + 1) + row;
    if (fr >= f0 || (blockIdx.x == 0 && fr < 0))
      hist_out[(fr - (F - L - 1)) * nch + q] = S[row * ld + q];
  }

  // --- branch FIR: U row t is frame f0 − 1 + t, S row t + L; a thread
  // walks kRun frames of one branch with the window in registers
  const int runs = (TF + kRun) / kRun;  // ceil((TF + 1) / kRun)
  for (int it = tid; it < nch * runs; it += blockDim.x) {
    const int q = it % nch, t0 = (it / nch) * kRun;
    float2 win[kRun], acc[kRun];
#pragma unroll
    for (int p = 0; p < kRun; ++p) {
      const int row = t0 + p + L;
      win[p] = row < E ? S[row * ld + q] : make_float2(0.f, 0.f);
      acc[p] = make_float2(0.f, 0.f);
    }
    for (int J = 0;;) {
      const float c = taps[J * nch + q];
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        acc[p].x = fmaf(c, win[p].x, acc[p].x);
        acc[p].y = fmaf(c, win[p].y, acc[p].y);
      }
      if (++J > L) break;
#pragma unroll
      for (int p = kRun - 1; p > 0; --p) win[p] = win[p - 1];
      win[0] = S[(t0 + L - J) * ld + q];
    }
#pragma unroll
    for (int p = 0; p < kRun; ++p)
      if (t0 + p <= TF) U[(t0 + p) * ldU + q] = acc[p];
  }
  __syncthreads();

  // --- DFT over branches into S rows 0..TF: d[t,k] = sum_q U[t,q]·W^{kq}
  if (P > 0) {
    constexpr int PP = P > 0 ? P : 1;
    const int l = tid % G;
    for (int base = 0; base <= TF; base += kChannelThreads / G) {  // uniform
      const int t = base + tid / G;
      const bool ok = t <= TF;
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
#pragma unroll
        for (int k1 = 0; k1 < PP; ++k1) S[t * ld + k1 + PP * k2] = v[rev_bits(k1, PP)];
      }
    }
  } else {
    constexpr int KB = 2, FB = 2;
    const int nkb = (nch + KB - 1) / KB, nfb = (TF + FB) / FB;  // ceil((TF + 1) / FB)
    for (int it = tid; it < nkb * nfb; it += blockDim.x) {
      const int k0 = (it % nkb) * KB, t0 = (it / nkb) * FB;
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
          u[j] = t0 + j <= TF ? U[(t0 + j) * ldU + q] : make_float2(0.f, 0.f);
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
          if (k0 + i < nch && t0 + j <= TF) S[(t0 + j) * ld + k0 + i] = acc[i][j];
    }
  }
  __syncthreads();

  // --- FM demod: arg(d[t]·conj(d[t−1])) / (2π·kf), channel-major out
  for (int i = tid; i < TF * nch; i += blockDim.x) {
    const int k = i / TF, t = i - k * TF;
    const float2 a = S[(t + 1) * ld + k], b2 = S[t * ld + k];
    const float cre = a.x * b2.x + a.y * b2.y;
    const float cim = a.y * b2.x - a.x * b2.y;
    audio[(long long)k * F + f0 + t] = atan2f(cim, cre) * inv_kf;
  }
}

template <int P, int G>
cudaError_t launch_channel(unsigned grid, size_t smem, cudaStream_t st, int mode, const void* x0,
                           const void* x1, int nch, int L, int TF, int C, int spt2, float r,
                           float g, const float* pow_rep, const float2* chunk_in,
                           const float2* partial, float r_oh, const float* phase_in,
                           const float* ramp2, const float2* hist_in, const float2* xlast_in,
                           const float2* ydc_in, const float* taps, const float2* twiddle,
                           long long F, float inv_kf, float* audio, float2* hist_out,
                           float2* xlast_out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&channel_tile<P, G>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  channel_tile<P, G><<<grid, kChannelThreads, smem, st>>>(
      mode, x0, x1, nch, L, TF, C, spt2, r, g, pow_rep, chunk_in, partial, r_oh, phase_in, ramp2,
      hist_in, xlast_in, ydc_in, taps, twiddle, F, inv_kf, audio, hist_out, xlast_out);
  return cudaGetLastError();
}

}  // namespace

// One fused step.  Launches the three kernels on `stream`, in order, and
// returns the first nonzero cudaGetLastError() (0 when all launched).
// Shapes: n samples, F = n/nch frames, tileF | tb | F (tb: frames per
// channel block), spt·nthr = C = tileF·nch with nthr <= 1024, n_chunks =
// n/C <= 1024·m; spt2·256 >= (tb + L + 1)·nch;
// o_h = −(L+1)·nch mod C, r_loc = r^(o_h mod spt), r_oh = r^o_h.  Scratch:
// chunk_end, chunk_in and partial (n_chunks complex each).
extern "C" int csdr_flagship_fused(
    int mode, const void* x0, const void* x1, long long n, int nch, int L, int tileF, int tb,
    int spt, int m, int spt2, int o_h, int vec, float r, float g, float rC, float r_loc, float r_oh,
    float inv_kf, float phase_inc, const void* taps_hat, const void* twiddle, const void* ramp2,
    const void* pow_thr, const void* pow_blk, const void* pow_rep, const void* phase_in,
    const void* hist_in, const void* xlast_in, const void* ydc_in, void* phase_out,
    void* hist_out, void* xlast_out, void* ydc_out, void* chunk_end, void* chunk_in,
    void* partial, void* audio, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = tileF * nch;
  const int n_chunks = (int)(n / C);
  const int nthr = C / spt;
  const long long F = n / nch;
  auto c2 = [](const void* p) { return static_cast<const float2*>(p); };
  auto m2 = [](void* p) { return static_cast<float2*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };

  const size_t smem_a = 2 * sizeof(float) * plane_len(C + 1) + sizeof(float2) * nthr;
  if (smem_a > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&dc_chunk),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_a);
    if (e != cudaSuccess) return e;
  }
  dc_chunk<<<n_chunks, nthr, smem_a, st>>>(mode, x0, x1, spt, r, g, cf(pow_thr), c2(xlast_in),
                                           vec, o_h, r_loc, m2(chunk_end), m2(partial));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  carry_scan<<<1, kScanThreads, 0, st>>>(c2(chunk_end), n_chunks, m, rC, cf(pow_blk), c2(ydc_in),
                                         m2(chunk_in), m2(ydc_out), cf(phase_in), phase_inc,
                                         static_cast<float*>(phase_out));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem = channel_smem(nch, L, tb);
  const unsigned grid = (unsigned)(F / tb);
#define CSDR_CHANNEL(P, G)                                                                        \
  launch_channel<P, G>(grid, smem, st, mode, x0, x1, nch, L, tb, C, spt2, r, g, cf(pow_rep),    \
                       c2(chunk_in), c2(partial), r_oh, cf(phase_in), cf(ramp2), c2(hist_in),    \
                       c2(xlast_in), c2(ydc_in), cf(taps_hat), c2(twiddle), F, inv_kf,           \
                       static_cast<float*>(audio), m2(hist_out), m2(xlast_out))
  switch (nch) {
    case 2: return CSDR_CHANNEL(2, 1);
    case 4: return CSDR_CHANNEL(4, 1);
    case 8: return CSDR_CHANNEL(8, 1);
    case 16: return CSDR_CHANNEL(16, 1);
    case 32: return CSDR_CHANNEL(16, 2);
    case 64: return CSDR_CHANNEL(16, 4);
    default: return CSDR_CHANNEL(0, 1);
  }
#undef CSDR_CHANNEL
}

extern "C" int csdr_scan_threads() { return kScanThreads; }
extern "C" int csdr_channel_threads() { return kChannelThreads; }
extern "C" long long csdr_channel_smem(int nch, int L, int tb) {
  return (long long)channel_smem(nch, L, tb);
}
