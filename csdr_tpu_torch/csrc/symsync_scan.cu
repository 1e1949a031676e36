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
// written once: ~12 B per input sample) but the dependent chain from one τ
// to the next: the positions, the window and bank reads, the multiply-adds,
// a five-level shuffle tree and the loop update.
//
// Design: one warp per row, one row per block.
//  - Pairs.  The edge output 2i+1 and the centre output 2i+2 are taken at
//    the same τ (an edge tick does not update the loop), so the warp
//    computes both windows in one pass: every lane reads its taps of both,
//    and the two shuffle trees run interleaved; then one loop update.
//    Output 0, a centre tick, and a last lone edge stand alone.  That
//    halves the serial steps.
//  - A window ring in shared memory.  cp.async stages the row in chunks of
//    kChunk samples into a ring of kRingChunks chunks, a chunk ahead of the
//    centre window (which advances by half per output), and waits only
//    for chunks already long in flight.  The ring's first Wp samples are
//    mirrored past its end, so a window is read at ring + (s mod kRing) + t
//    with no wrap per tap.  The reads are issued before the test that the
//    ring holds the window; a window it does not hold (a τ jump, the wrapped
//    or clamped start of a window outside [0, L − W]) is read again from
//    device memory with the same indexing and the same sum, and a window
//    far from the ring re-seats it.  Nothing depends on τ staying in range.
//  - The bank (npfb rows of W taps) is staged in shared memory once, each
//    row padded with zeros to Wp = 32·⌈W/32⌉, so a lane's taps of a row are
//    at fixed offsets; rint(v), half to even, for 0 ≤ v ≤ npfb is the low
//    bits of v + 1.5·2^23, one add in place of a conversion.
//  - Lane l sums taps l, l + 32, l + 64, … in that order, and a fixed
//    __shfl_xor_sync tree (16, 8, 4, 2, 1) sums the lanes, which leaves the
//    same bits in every lane, so every lane applies the same loop update
//    and no broadcast is needed.  Lane j % 32 keeps output j, and every 32
//    outputs the warp stores them coalesced.
// Every product and sum is an explicit _rn intrinsic (no FMA contraction),
// and a frac·npfb that rounds to npfb is clipped to npfb − 1 (it does not
// move to the next ipos).

#include <cuda_runtime.h>

#include "mma_bf16x3.cuh"

namespace {

using csdr::cp_async;
using csdr::cp_async_commit;
using csdr::cp_async_wait;

constexpr int kChunk = 1024;      // samples per ring chunk
constexpr int kRingChunks = 4;    // chunks in the ring
constexpr int kRing = kChunk * kRingChunks;
constexpr int kMaxTaps = kChunk;  // W ≤ kChunk, so the mirror holds one chunk's start

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

// The window start s and bank row ph of a position.  floor(pos) is clamped
// to ±2^30 before the int conversion (L < 2^30, so the clamped start is the
// same).
__device__ __forceinline__ void pick(float pos, float npf, int npfb, int mk, int L, int W, int& s,
                                     int& ph) {
  const float v = __fmul_rn(__fsub_rn(pos, floorf(pos)), npf);
  const int p = __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;   // rint(v)
  ph = min(max(p, 0), npfb - 1);
  int si = __float2int_rd(fminf(fmaxf(pos, -1073741824.0f), 1073741824.0f)) - mk;
  if (si < 0) si += L;
  s = min(max(si, 0), L - W);
}

// NT taps per lane: a template constant up to 8 (W ≤ 256), else nt.  The
// constant lets the tap loops unroll into registers; with the run-time nt
// this kernel took 1.7× the time at W 81 and 1.4× at W 25 on an H100
// (chip_scan_split.py).
template <typename K, int NT>
__global__ void __launch_bounds__(32) symsync_scan_rows(
    const typename K::T* __restrict__ xfull, int L, const float* __restrict__ bank, int npfb,
    int W, int nt, int mk, int nout, float start, float half, float kp, float ki,
    const float* __restrict__ tau_in, const float* __restrict__ eta_in,
    const typename K::T* __restrict__ prev_in, const typename K::T* __restrict__ edge_in,
    typename K::T* __restrict__ y, float* __restrict__ tau_out, float* __restrict__ eta_out,
    typename K::T* __restrict__ prev_out, typename K::T* __restrict__ edge_out) {
  using T = typename K::T;
  const int ntaps = NT > 0 ? NT : nt;
  const int Wp = 32 * ntaps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);                 // kRing + Wp (the mirror)
  float* sbank = reinterpret_cast<float*>(ring + kRing + Wp);   // npfb × Wp
  const int lane = threadIdx.x;
  for (int i = lane; i < npfb * Wp; i += 32) {
    const int r = i / Wp, t = i - r * Wp;
    sbank[i] = t < W ? bank[r * W + t] : 0.0f;
  }
  __syncwarp();
  const long long row = blockIdx.x;
  const T* x = xfull + row * L;
  T* yr = y + row * nout;
  const T* ring_lane = ring + lane;
  const float* bank_lane = sbank + lane;
  float tau = tau_in[row], eta = eta_in[row];
  T prev = prev_in[row], edge = edge_in[row];
  const float npf = (float)npfb;

  int cb = 0;   // the ring holds chunks cb .. cb + kRingChunks − 1; cb and cb + 1 have landed
  auto issue = [&](int c) {
    const int g0 = c * kChunk;
    T* dst = ring + (c & (kRingChunks - 1)) * kChunk;
    for (int i = lane; i < kChunk; i += 32) {
      const bool ok = g0 + i < L;
      cp_async<sizeof(T)>(dst + i, x + (ok ? g0 + i : 0), ok);
    }
    if ((c & (kRingChunks - 1)) == 0) {   // the mirror past the ring's end
      for (int i = lane; i < Wp; i += 32) {
        const bool ok = g0 + i < L;
        cp_async<sizeof(T)>(ring + kRing + i, x + (ok ? g0 + i : 0), ok);
      }
    }
    cp_async_commit();
  };
  auto seat = [&](int c) {
    cp_async_wait<0>();
    __syncwarp();
    cb = c;
    for (int q = 0; q < kRingChunks; ++q) issue(cb + q);
    cp_async_wait<kRingChunks - 2>();
    __syncwarp();
  };
  // keep the ring a chunk behind the window starting at s
  auto follow = [&](int s) {
    const int lo = cb * kChunk;
    if (__builtin_expect(s < lo + kChunk, 1) && s >= lo) return;
    if (s >= lo && s < lo + 2 * kChunk) {
      __syncwarp();
      issue(cb + kRingChunks);
      ++cb;
      cp_async_wait<kRingChunks - 2>();
      __syncwarp();
    } else {
      seat(s / kChunk);
    }
  };
  auto covered = [&](int s) {
    const int lo = cb * kChunk;
    return s >= lo && s + W <= lo + 2 * kChunk;
  };
  // this lane's part of the window at s in bank row ph, from the ring or
  // from device memory
  auto ring_part = [&](int s, int ph) -> T {
    const T* src = ring_lane + (s & (kRing - 1));
    const float* b = bank_lane + ph * Wp;
    T acc = K::zero();
#pragma unroll
    for (int u = 0; u < ntaps; ++u) {
      const T nacc = K::madd(acc, src[32 * u], b[32 * u]);
      acc = lane + 32 * u < W ? nacc : acc;
    }
    return acc;
  };
  auto global_part = [&](int s, int ph) -> T {
    const float* b = bank_lane + ph * Wp;
    T acc = K::zero();
#pragma unroll
    for (int u = 0; u < ntaps; ++u) {
      const T nacc = K::madd(acc, x[s + min(lane + 32 * u, W - 1)], b[32 * u]);
      acc = lane + 32 * u < W ? nacc : acc;
    }
    return acc;
  };
  auto tree = [&](T v) -> T {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = K::shfl_add(v, off);
    return v;
  };
  auto update = [&](T yc) {
    float e = K::ted(edge, yc, prev);
    e = -fminf(fmaxf(e, -1.0f), 1.0f);
    eta = __fadd_rn(eta, __fmul_rn(ki, e));
    tau = __fadd_rn(__fadd_rn(tau, __fmul_rn(kp, e)), eta);
    prev = yc;
  };
  auto position = [&](int j) { return __fadd_rn(__fadd_rn(start, __fmul_rn((float)j, half)), tau); };

  T mine = K::zero();
  int s, ph;
  // output 0, a centre tick, alone
  pick(position(0), npf, npfb, mk, L, W, s, ph);
  seat(s / kChunk);
  {
    const T y0 = tree(covered(s) ? ring_part(s, ph) : global_part(s, ph));
    update(y0);
    mine = lane == 0 ? y0 : mine;
  }
  int j = 1;
  // pairs: edge j and centre j + 1 at one τ
  for (; j + 1 < nout; j += 2) {
    int se, phe, sc, phc;
    pick(position(j), npf, npfb, mk, L, W, se, phe);
    pick(position(j + 1), npf, npfb, mk, L, W, sc, phc);
    T ae = ring_part(se, phe), ac = ring_part(sc, phc);
    if (__builtin_expect(!(covered(se) && covered(sc)), 0)) {
      if (!covered(se)) ae = global_part(se, phe);
      if (!covered(sc)) ac = global_part(sc, phc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ae = K::shfl_add(ae, off);
      ac = K::shfl_add(ac, off);
    }
    edge = ae;
    mine = lane == (j & 31) ? ae : mine;
    if ((j & 31) == 31) yr[j - 31 + lane] = mine;
    update(ac);
    mine = lane == ((j + 1) & 31) ? ac : mine;
    follow(sc);
  }
  if (j < nout) {   // a last edge alone
    pick(position(j), npf, npfb, mk, L, W, s, ph);
    edge = tree(covered(s) ? ring_part(s, ph) : global_part(s, ph));
    mine = lane == (j & 31) ? edge : mine;
    ++j;
  }
  // the last group of outputs, j of them written in all
  const int j0 = (j - 1) & ~31;
  if (j0 + lane < j) yr[j0 + lane] = mine;
  cp_async_wait<0>();
  if (lane == 0) {
    tau_out[row] = tau;
    eta_out[row] = eta;
    prev_out[row] = prev;
    edge_out[row] = edge;
  }
}

template <typename K, int NT>
cudaError_t launch_nt(const void* xfull, int L, int rows, const void* bank, int npfb, int W, int nt,
                      int mk, int nout, float start, float half, float kp, float ki,
                      const void* tau_in, const void* eta_in, const void* prev_in,
                      const void* edge_in, void* y, void* tau_out, void* eta_out, void* prev_out,
                      void* edge_out, cudaStream_t st) {
  using T = typename K::T;
  const size_t smem = (kRing + 32 * (size_t)nt) * sizeof(T) + sizeof(float) * (size_t)npfb * 32 * nt;
  cudaError_t e = cudaFuncSetAttribute(&symsync_scan_rows<K, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  symsync_scan_rows<K, NT><<<rows, 32, smem, st>>>(
      static_cast<const T*>(xfull), L, static_cast<const float*>(bank), npfb, W, nt, mk, nout,
      start, half, kp, ki, static_cast<const float*>(tau_in), static_cast<const float*>(eta_in),
      static_cast<const T*>(prev_in), static_cast<const T*>(edge_in), static_cast<T*>(y),
      static_cast<float*>(tau_out), static_cast<float*>(eta_out), static_cast<T*>(prev_out),
      static_cast<T*>(edge_out));
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch(const void* xfull, int L, int rows, const void* bank, int npfb, int W, int mk,
                   int nout, float start, float half, float kp, float ki, const void* tau_in,
                   const void* eta_in, const void* prev_in, const void* edge_in, void* y,
                   void* tau_out, void* eta_out, void* prev_out, void* edge_out,
                   cudaStream_t st) {
  const int nt = (W + 31) / 32;
#define CSDR_SYNC_NT(N)                                                                           \
  case N:                                                                                         \
    return launch_nt<K, N>(xfull, L, rows, bank, npfb, W, nt, mk, nout, start, half, kp, ki,      \
                           tau_in, eta_in, prev_in, edge_in, y, tau_out, eta_out, prev_out,       \
                           edge_out, st);
  switch (nt) {
    CSDR_SYNC_NT(1)
    CSDR_SYNC_NT(2)
    CSDR_SYNC_NT(3)
    CSDR_SYNC_NT(4)
    CSDR_SYNC_NT(5)
    CSDR_SYNC_NT(6)
    CSDR_SYNC_NT(7)
    CSDR_SYNC_NT(8)
    default:
      return launch_nt<K, 0>(xfull, L, rows, bank, npfb, W, nt, mk, nout, start, half, kp, ki,
                             tau_in, eta_in, prev_in, edge_in, y, tau_out, eta_out, prev_out,
                             edge_out, st);
  }
#undef CSDR_SYNC_NT
}

}  // namespace

// One launch over `rows` rows of L = H + n samples on `stream`; returns the
// first CUDA error (0 when it launched).  is_complex: xfull, y, prev and edge
// are float2 (complex64), else float.  bank: (npfb, W) float32, W ≤ kMaxTaps;
// tau, eta: (rows,) float32; y: (rows, nout); L < 2^30.
extern "C" int csdr_symsync_scan(int is_complex, const void* xfull, long long L, int rows,
                                 const void* bank, int npfb, int W, int mk, long long nout,
                                 float start, float half, float kp, float ki, const void* tau_in,
                                 const void* eta_in, const void* prev_in, const void* edge_in,
                                 void* y, void* tau_out, void* eta_out, void* prev_out,
                                 void* edge_out, void* stream) {
  if (W > kMaxTaps || L >= (1LL << 30) || nout >= (1LL << 31) - 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_complex
                   ? launch<Complex>(xfull, (int)L, rows, bank, npfb, W, mk, (int)nout, start,
                                     half, kp, ki, tau_in, eta_in, prev_in, edge_in, y, tau_out,
                                     eta_out, prev_out, edge_out, st)
                   : launch<Real>(xfull, (int)L, rows, bank, npfb, W, mk, (int)nout, start, half,
                                  kp, ki, tau_in, eta_in, prev_in, edge_in, y, tau_out, eta_out,
                                  prev_out, edge_out, st));
}
