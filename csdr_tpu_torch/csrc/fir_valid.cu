// Causal valid FIR for Hopper (sm_90a) on the tensor cores: real float32
// taps over batched rows of real (float) or complex (float2) samples.
//
// Replaces the TPU kernel csdr_tpu/ops/pallas/fir_kernel.py pallas_fir_valid
// (K5, pallas_call in _fir_rows).  For each row b:
//     y[b, i] = sum_k h[k] * x[b, i + K − 1 − k],   i < n,  row length n + K − 1,
// which, with the reversed taps g[p] = h[K − 1 − p], is the correlation
//     y[b, i] = sum_p g[p] * x[b, i + p].
//
// What bounds it on this card.  At 64 rows x 2^17 complex outputs x 585
// taps the direct FIR is 19.6 GFLOP: >= 0.29 ms at the 67 TFLOP/s FP32
// peak, against 128 MB of traffic, ~40 us at 3.35 TB/s.  No FP32-FMA
// design comes near the bytes.  Like the Pallas kernel, which runs banded
// Toeplitz products on the MXU, this one runs the FIR as a matrix product
// on the tensor cores, with the bf16x3 split (mma_bf16x3.cuh) for accuracy:
// 3 bf16 products of 16·ceil((K + 63)/16) MACs per output and real plane,
// 66 GFLOP at that shape, 67 us at the 989 TFLOP/s dense bf16 rate, which
// only wgmma reaches (mma.sync issues at about half of it on this card).
//
// Arithmetic.  Frames of 64 outputs, Y[j, f] = y[64f + j], give Y = G·X with
//     G[j, c] = g[c − j]  (Toeplitz, zero outside [0, K)),  X[c, f] = x[64f + c],
// c < 16·KS, KS = ceil((K + 63)/16) k-steps of 16: a wgmma m64n64k16 per
// k-step, M = the 64 outputs of a frame, N = 64 frames.  G is the A
// operand, in registers: warp w's rows j = 16w + gid (+ 8) come from a
// table of tap pairs P[q] = (g[q], g[q + 1]) made once per taps and device
// by the wrapper (hi and lo planes): a[0] = P[16kk + 2tig − gid − 16w],
// a[1] = P[· − 8], a[2] = P[· + 8], a[3] = a[0], so no pair is read
// misaligned and the dense banks are never stored.  X is the B operand,
// read by wgmma from the window itself: stored as rows of 64 samples (128
// bytes) in the 128-byte swizzle, frame f of k-step kk is row f + kk/4 at
// byte 32·(kk % 4), so a k-step's descriptor only moves its start.
// Complex rows run as two real planes against the same A.
//
// Structure.  Work items are runs of kRun = 4,096 outputs (64 frames) of
// one row; taps longer than kChunkSteps·16 = 1,024 are swept in chunks, so
// any K works.  Persistent blocks of one warpgroup, several per SM, walk
// the (item, chunk) stages.  A stage's raw window (64 + steps/4 rows, zero
// past the row) and, when there is more than one chunk, its tap pairs (two
// buffers) are fetched with cp.async as soon as the previous stage has
// split its window, so the copy overlaps that stage's MMAs.  The block
// splits the window once into swizzled bf16 hi/lo planes, then issues 3
// wgmmas per k-step and plane, the A registers of two k-steps in flight,
// accumulating in FP32 registers across chunks.  Outputs leave from the
// accumulators as runs of 8 consecutive samples (whole 32-byte sectors).
// No TF32 and no library GEMM.

#include "mma_bf16x3.cuh"

namespace {

using csdr::cp_async;
using csdr::hold;
using csdr::split2;

constexpr int kThreads = 128;             // one warpgroup
constexpr int kFrame = 64;                // outputs per frame: wgmma's M
constexpr int kFrames = 64;               // frames per work item: wgmma's N
constexpr int kRun = kFrame * kFrames;    // outputs per work item
constexpr int kChunkSteps = 64;           // k-steps (16 taps) per tap chunk, whole k-blocks of 4
constexpr int kTapPad = 64;               // pair table word Q holds P[Q − kTapPad]

__device__ __forceinline__ float re_of(float v) { return v; }
__device__ __forceinline__ float re_of(float2 v) { return v.x; }
__device__ __forceinline__ float im_of(float2 v) { return v.y; }
__device__ __forceinline__ void put(float* y, long long o, const float (&v)[2]) { y[o] = v[0]; }
__device__ __forceinline__ void put(float2* y, long long o, const float (&v)[2]) {
  y[o] = make_float2(v[0], v[1]);
}

struct Geometry {
  int KSC, rows, part, tap_words;  // k-steps per chunk, window rows, bytes per plane part
  __host__ __device__ Geometry(int KS) {
    KSC = KS < kChunkSteps ? KS : kChunkSteps;
    rows = kFrames + (KSC + 3) / 4;      // frame f of k-block kb reads row f + kb
    part = (rows + 7) / 8 * 1024;        // whole 1024-byte swizzle atoms
    tap_words = 16 * KSC + kTapPad;
  }
  // from a 1024-byte-aligned base: the window's parts [P][hi, lo], the raw
  // window [rows·64], the tap pairs [2][hi, lo][tap_words]
  __host__ __device__ size_t smem(int P) const {
    return 1024 + (size_t)2 * P * part + (size_t)rows * kFrame * P * sizeof(float) +
           2 * 2 * (size_t)tap_words * 4;
  }
};

// x: rows of lx = n + K − 1 samples; taps_hi / taps_lo: the pair tables,
// 16·KS + kTapPad words each; y: rows of n samples.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fir_valid_tile(const T* __restrict__ x, const uint32_t* __restrict__ taps_hi,
                   const uint32_t* __restrict__ taps_lo, long long n, long long lx, int KS,
                   int rows, T* __restrict__ y) {
  constexpr int P = sizeof(T) / sizeof(float);  // real planes
  extern __shared__ unsigned char smem_raw[];
  const Geometry geo(KS);
  const uint32_t raw_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* win = smem_raw + ((1024 - (raw_s & 1023)) & 1023);  // 1024-byte aligned
  const uint32_t win_s = static_cast<uint32_t>(__cvta_generic_to_shared(win));
  T* raw = reinterpret_cast<T*>(win + 2 * P * geo.part);
  uint32_t* tap = reinterpret_cast<uint32_t*>(raw + geo.rows * kFrame);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long runs = (n + kRun - 1) / kRun;
  const long long items = runs * rows;
  const int nchunks = (KS + kChunkSteps - 1) / kChunkSteps;
  const long long mine =
      items > (long long)blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long stages = mine * nchunks;

  auto load = [&](long long s) {
    const long long it = blockIdx.x + (s / nchunks) * gridDim.x;
    const int ch = (int)(s % nchunks);
    const long long row = it / runs, i0 = (it % runs) * kRun;
    const int kk0 = ch * kChunkSteps;
    const int ksc = min(kChunkSteps, KS - kk0);
    const T* src = x + row * lx;
    const long long base = i0 + 16LL * kk0;
    for (int e = tid; e < (kFrames + (ksc + 3) / 4) * kFrame; e += kThreads) {
      const bool ok = base + e < lx;
      cp_async<sizeof(T)>(raw + e, src + (ok ? base + e : 0), ok);
    }
    if (nchunks > 1 || s == 0) {
      uint32_t* td = tap + (s & 1) * 2 * geo.tap_words;
      for (int i = tid; i < 4 * ksc + kTapPad / 4; i += kThreads) {  // 16-byte pieces
        cp_async<16>(td + 4 * i, taps_hi + 16 * kk0 + 4 * i, true);
        cp_async<16>(td + geo.tap_words + 4 * i, taps_lo + 16 * kk0 + 4 * i, true);
      }
    }
    csdr::cp_async_commit();
  };

  float acc[P][32];
  if (stages > 0) load(0);
  for (long long s = 0; s < stages; ++s) {
    csdr::cp_async_wait<0>();  // stage s has landed (this thread's copies)
    __syncthreads();           // ... everyone's; stage s − 1's MMAs are done with the window

    const long long it = blockIdx.x + (s / nchunks) * gridDim.x;
    const int ch = (int)(s % nchunks);
    const long long row = it / runs, i0 = (it % runs) * kRun;
    const int ksc = min(kChunkSteps, KS - ch * kChunkSteps);

    // split the window into swizzled hi/lo planes: sample e is row e / 64,
    // 16-byte chunk (e % 64) / 8 stored at chunk ^ (row & 7)
    for (int w = tid; w < (kFrames + (ksc + 3) / 4) * kFrame / 2; w += kThreads) {
      const T a = raw[2 * w], b = raw[2 * w + 1];
      const int R = w >> 5, c = (2 * w) & 63;
      const int off = R * 128 + ((((c >> 3) ^ R) & 7) << 4) + (c & 7) * 2;
      uint32_t hi, lo;
      split2(re_of(a), re_of(b), hi, lo);
      *reinterpret_cast<uint32_t*>(win + off) = hi;
      *reinterpret_cast<uint32_t*>(win + geo.part + off) = lo;
      if constexpr (P == 2) {
        split2(im_of(a), im_of(b), hi, lo);
        *reinterpret_cast<uint32_t*>(win + 2 * geo.part + off) = hi;
        *reinterpret_cast<uint32_t*>(win + 3 * geo.part + off) = lo;
      }
    }
    csdr::fence_async_shared();
    __syncthreads();  // the planes are ready and the raw window is free: fetch stage s + 1
    if (s + 1 < stages) load(s + 1);

    if (ch == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    }
    // A of k-step kk, rows j = 16·warp + gid (+ 8), columns 16kk + 2tig (+ 8):
    // g[c − j] from the pair table
    const uint32_t* th =
        tap + (nchunks > 1 ? (s & 1) : 0) * 2 * geo.tap_words + kTapPad + 2 * tig - gid - 16 * warp;
    const uint32_t* tl = th + geo.tap_words;
    // one k-step: fence, 3 wgmmas per plane (B of k-block kk / 4 starts at
    // window row kk / 4, k-step kk % 4 32 bytes in), commit; then wait for
    // the previous k-step, whose A registers `prev` may now be reused
    auto step = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4], uint32_t (&ph)[4],
                    uint32_t (&pl)[4]) {
      ah[0] = th[16 * kk];
      ah[1] = th[16 * kk - 8];
      ah[2] = th[16 * kk + 8];
      ah[3] = ah[0];
      al[0] = tl[16 * kk];
      al[1] = tl[16 * kk - 8];
      al[2] = tl[16 * kk + 8];
      al[3] = al[0];
      const uint32_t b = win_s + 128 * (kk >> 2) + 32 * (kk & 3);
      csdr::wgmma_fence();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint32_t bh = b + 2 * p * geo.part, bl = bh + geo.part;
        csdr::wgmma_m64n64k16(acc[p], al, csdr::desc_sw128(bh));
        csdr::wgmma_m64n64k16(acc[p], ah, csdr::desc_sw128(bl));
        csdr::wgmma_m64n64k16(acc[p], ah, csdr::desc_sw128(bh));
      }
      csdr::wgmma_commit();
      csdr::wgmma_wait<1>();
      hold(ph);
      hold(pl);
    };
#pragma unroll
    for (int p = 0; p < P; ++p) hold(acc[p]);
    uint32_t a0h[4], a0l[4], a1h[4] = {0, 0, 0, 0}, a1l[4] = {0, 0, 0, 0};
    int kk = 0;
    for (; kk + 1 < ksc; kk += 2) {
      step(kk, a0h, a0l, a1h, a1l);
      step(kk + 1, a1h, a1l, a0h, a0l);
    }
    if (kk < ksc) step(kk, a0h, a0l, a1h, a1l);
    csdr::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) hold(acc[p]);

    if (ch == nchunks - 1) {
      // d[4i + e]: output 16·warp + gid (+ 8 for e >= 2) of frame 8i + 2tig (+ e & 1)
      T* yr = y + row * n;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long o = i0 + (long long)kFrame * (8 * i + 2 * tig + (e & 1)) + 16 * warp +
                              gid + 8 * (e >> 1);
          const float v[2] = {acc[0][4 * i + e], acc[P - 1][4 * i + e]};
          if (o < n) put(yr, o, v);
        }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* taps_hi, const void* taps_lo, long long n,
                   long long lx, int KS, int rows, void* y, cudaStream_t st) {
  const size_t smem = Geometry(KS).smem(sizeof(T) / sizeof(float));
  cudaError_t e = csdr::allow_smem(&fir_valid_tile<T>, smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 0;
  e = csdr::persistent_grid(&fir_valid_tile<T>, kThreads, smem,
                            (n + kRun - 1) / kRun * (long long)rows, &grid);
  if (e != cudaSuccess) return e;
  fir_valid_tile<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(taps_hi),
      static_cast<const uint32_t*>(taps_lo), n, lx, KS, rows, static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block takes at KS k-steps.
extern "C" long long csdr_fir_valid_smem(int is_complex, int KS) {
  return (long long)Geometry(KS).smem(is_complex ? 2 : 1);
}

// One launch over `rows` rows on `stream`; returns the first CUDA error (0
// when it launched).  is_complex: x and y are float2 (complex64) rows, else
// float.  taps_hi / taps_lo: the wrapper's pair tables of 16·KS + 64
// words, KS = ceil((K + 63)/16).
extern "C" int csdr_fir_valid(int is_complex, const void* x, const void* taps_hi,
                              const void* taps_lo, long long n, long long lx, int KS, int rows,
                              void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_complex ? launch<float2>(x, taps_hi, taps_lo, n, lx, KS, rows, y, st)
                    : launch<float>(x, taps_hi, taps_lo, n, lx, KS, rows, y, st);
}
