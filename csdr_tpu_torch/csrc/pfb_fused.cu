// Fused polyphase filterbank tail for Hopper (sm_90a): branch FIR over
// pre-shifted, frame-reversed panels -> DFT against a (column shard of the)
// DFT matrix on the tensor cores -> optional per-channel FM demod.
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
// samples (8·nch B) and writes ncho floats or complex: at nch = ncho = 64,
// per 2^23 samples, 64 MB in and 32 MB (K3) or 64 MB (K4) out, 30–40 us of
// HBM at 3.35 TB/s.  The DFT as an FP32 FMA product is 4.3 GFLOP (65 us at
// the 67 TFLOP/s FP32 peak) and, fed from shared memory, waits on it.  So,
// like the Pallas kernels, this one runs the DFT on the matrix unit: the
// complex product as one real GEMM in bf16x3 (mma_bf16x3.cuh),
//     [.. Ure[p] Uim[p] ..] @ B,  B[2p][2k] = Wre,  B[2p][2k+1] = Wim,
//                                 B[2p+1][2k] = −Wim, B[2p+1][2k+1] = Wre,
// 12.9 GFLOP of bf16 per step, ~13 us at 989 TFLOP/s.  Interleaving re/im
// along both K and N makes U[t, p] one 32-bit A word (bf16 re, im) and
// leaves (Dre, Dim) of one channel in one lane's c[0], c[1].  The form takes
// any W, so nch 4, 20, 64 and a column shard run the same code.
//
// Design.  Persistent blocks of 512 threads, one per SM, each walking a
// contiguous run of tiles of TF frames (TF | F, from the wrapper).  A
// block splits W once into B (hi and lo, K-major in the 128-byte swizzle)
// in shared memory and loads the taps once.  A tile's panel rows (TF + H) are fetched with cp.async into one of two
// buffers while the previous tile computes.  Per tile:
//   (1) branch FIR, one thread per branch p and run of kRun frames with the
//       window in registers (one shared-memory load per sample, kRun
//       complex FMAs per tap); rows are split into bf16 hi/lo words of U;
//   (2) DFT: each warpgroup task is 64 frames (wgmma's M; each warp's A by
//       ldmatrix.x4 from U) by 32 columns of D (16 channels, B from shared
//       memory in the 128-byte swizzle), 3 wgmmas per k-step.  K4 writes D
//       from the accumulators, channel-major, as runs of 8 frames (64
//       bytes); K3 puts D into the tile's panel buffer, which the FIR is
//       done with;
//   (3) K3: d[t]·conj(d[t−1]) -> atan2f / (2π·kf), channel-major with the
//       lanes along frames.
// K3's frame before a tile comes from the previous tile's last D row; only
// a block's first tile computes it, as FIR row −1 (U row TF) and one FP32
// row of D on the CUDA cores.  U rows past the tile and branches past nch
// stay zero; W past nch or ncho is zero.  Every GEMM product is bf16x3 with
// FP32 accumulation (no TF32).

#include "mma_bf16x3.cuh"

namespace {

using csdr::cp_async;
using csdr::hold;
using csdr::split2;

constexpr int kThreads = 512;  // 4 warpgroups
constexpr int kGroups = kThreads / 128;
constexpr int kRun = 8;        // FIR rows per thread
constexpr int kM = 64;         // GEMM rows (frames) per task: wgmma's M
constexpr int kN = 32;         // GEMM columns per task: wgmma's N (16 channels)

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Layout {
  int H, E, nout, MB, Urows, Kp, KS, NG, KB, NP, ldU, ldD, region, b_part;
  __host__ __device__ Layout(bool demod, int nch, int ncho, int L, int TF) {
    H = L - 1 + (demod ? 1 : 0);
    E = TF + H;                     // panel rows per tile
    nout = TF + (demod ? 1 : 0);    // D rows: the tile's frames (K3: + the one before)
    MB = ceil_div(TF, kM);          // GEMM row blocks
    Urows = MB * kM + (demod ? 16 : 0);  // + K3's U row TF
    Kp = ceil_div(nch, 8) * 8;      // branches, padded: 2·Kp is a whole number of k-steps
    KS = Kp / 8;                    // k-steps of 16 (8 complex branches)
    NG = ceil_div(2 * ncho, kN);    // column groups of 32 (16 complex channels)
    KB = ceil_div(2 * Kp, 64);      // B's k-blocks of 64 (one 128-byte swizzle row)
    NP = NG * kN;                   // B's rows (columns of D), padded
    ldU = Kp + 4;                   // U row stride in words: 8 rows hit 8 bank groups
    ldD = ncho + 1;                 // D row stride in float2
    // float2 per tile buffer: panel rows, then K3's D rows
    region = demod && nout * ldD > E * nch ? nout * ldD : E * nch;
    b_part = KB * NP * 128;         // bytes of B's hi (or lo) part
  }
  // bytes, from a 1024-byte-aligned base: B hi and lo, two tile buffers
  // (panel rows, then D), U hi and lo, two rows of D carried from tile to
  // tile (K3), the taps
  __host__ __device__ size_t smem(int nch, int L) const {
    return 1024 + 2 * (size_t)b_part + 2 * (size_t)region * sizeof(float2) +
           2 * (size_t)Urows * ldU * 4 + 2 * (size_t)ldD * sizeof(float2) +
           (size_t)L * nch * sizeof(float);
  }
};

// (1) branch FIR of one thread: U rows ρ0 .. ρ0 + kRun − 1 of branch p,
// U[ρ, p] = sum_J taps[J, p]·S[ρ + H − J, p], split into U's hi/lo words
// (row ρ = −1 into row TF).  The window of kRun samples stays in registers
// and shifts by one sample per tap: one shared-memory load per tap.
__device__ __forceinline__ void fir_run(const float2* S, const float* taps, int nch, int L, int H,
                                        int E, int TF, int rho0, int p, int ldU, uint32_t* Uh,
                                        uint32_t* Ul) {
  float2 acc[kRun], win[kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    acc[q] = make_float2(0.f, 0.f);
    const int row = rho0 + q + H;
    win[q] = row < E ? S[row * nch + p] : make_float2(0.f, 0.f);
  }
  for (int J = 0;;) {
    const float c = taps[J * nch + p];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      acc[q].x = fmaf(c, win[q].x, acc[q].x);
      acc[q].y = fmaf(c, win[q].y, acc[q].y);
    }
    if (++J == L) break;
#pragma unroll
    for (int q = kRun - 1; q > 0; --q) win[q] = win[q - 1];
    win[0] = S[(rho0 + H - J) * nch + p];
  }
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const int rho = rho0 + q;
    if (rho < TF) {
      const int r = rho < 0 ? TF : rho;
      split2(acc[q].x, acc[q].y, Uh[r * ldU + p], Ul[r * ldU + p]);
    }
  }
}

// arg(a·conj(b))·inv_kf
__device__ __forceinline__ float demod(float ax, float ay, float bx, float by, float inv_kf) {
  return atan2f(ay * bx - ax * by, ax * bx + ay * by) * inv_kf;
}

template <bool DEMOD>
__global__ void __launch_bounds__(kThreads, 1)
    pfb_tile(const float2* __restrict__ vfull, const float* __restrict__ taps_g,
             const float2* __restrict__ W_g, long long F, int nch, int ncho, int L, int TF,
             float inv_kf, void* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const Layout lay(DEMOD, nch, ncho, L, TF);
  const uint32_t raw_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* Bw = smem_raw + ((1024 - (raw_s & 1023)) & 1023);  // [hi, lo][KB][NP][128 B]
  const uint32_t B_s = static_cast<uint32_t>(__cvta_generic_to_shared(Bw));
  float2* buf = reinterpret_cast<float2*>(Bw + 2 * lay.b_part);    // [2][region]
  uint32_t* Uh = reinterpret_cast<uint32_t*>(buf + 2 * lay.region);  // [Urows][ldU]
  uint32_t* Ul = Uh + lay.Urows * lay.ldU;
  float2* carry = reinterpret_cast<float2*>(Ul + lay.Urows * lay.ldU);  // [2][ldD]
  float* taps = reinterpret_cast<float*>(carry + 2 * lay.ldD);          // (L, nch)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // each block walks a contiguous run of tiles, so K3's demod takes the
  // frame before a tile from the previous one; only its first tile
  // computes that frame (FIR row −1, GEMM row TF)
  const long long tiles = F / TF;
  const long long per = tiles / gridDim.x, rem = tiles % gridDim.x;
  const long long mine = per + ((long long)blockIdx.x < rem ? 1 : 0);
  const long long first = blockIdx.x * per + (blockIdx.x < rem ? blockIdx.x : rem);

  auto load = [&](long long i) {
    const long long f0 = (first + i) * TF;
    const float2* src = vfull + f0 * nch;  // panel row f0 = the tile's first halo row
    float2* dst = buf + (i & 1) * lay.region;
    for (int e = tid; e < lay.E * nch; e += kThreads) cp_async<8>(dst + e, src + e, true);
    csdr::cp_async_commit();
  };

  // once per block: the taps, zero U (its padding stays zero), the first
  // tile, and W split into B fragments
  for (int i = tid; i < L * nch; i += kThreads) cp_async<4>(taps + i, taps_g + i, true);
  for (int i = tid; i < 2 * lay.Urows * lay.ldU; i += kThreads) Uh[i] = 0u;
  if (mine > 0) load(0);
  // B, split, K-major in the 128-byte swizzle: row n (a column of D,
  // channel n / 2, re or im) holds B[c][n] for c < 2·Kp, k-block c / 64 in
  // its own part; word (n, p) is (B[2p][n], B[2p + 1][n]): (Wre, −Wim) of
  // W[p, n/2] for n even, (Wim, Wre) for n odd
  for (int u = tid; u < lay.NP * lay.Kp; u += kThreads) {
    const int n = u / lay.Kp, p = u - n * lay.Kp, k = n >> 1, c = (2 * p) & 63;
    float v0 = 0.f, v1 = 0.f;
    if (p < nch && k < ncho) {
      const float2 w = W_g[(long long)p * ncho + k];
      v0 = (n & 1) ? w.y : w.x;
      v1 = (n & 1) ? w.x : -w.y;
    }
    const int off = (2 * p / 64) * lay.NP * 128 + n * 128 + ((((c >> 3) ^ n) & 7) << 4) + (c & 7) * 2;
    split2(v0, v1, *reinterpret_cast<uint32_t*>(Bw + off),
           *reinterpret_cast<uint32_t*>(Bw + lay.b_part + off));
  }
  csdr::fence_async_shared();  // B is read by wgmma

  const uint32_t Uh_s = static_cast<uint32_t>(__cvta_generic_to_shared(Uh));
  const uint32_t lo_off = 4 * lay.Urows * lay.ldU;  // bytes from Uh to Ul
  const int wg = warp >> 2, w4 = warp & 3;
  for (long long i = 0; i < mine; ++i) {
    __syncthreads();  // the previous tile's readers of buffer (i + 1) & 1 and of U are done
    if (i + 1 < mine)
      load(i + 1);
    else
      csdr::cp_async_commit();
    csdr::cp_async_wait<1>();
    __syncthreads();
    const long long f0 = (first + i) * TF;
    float2* S = buf + (i & 1) * lay.region;
    const int extra = DEMOD && i == 0 ? 1 : 0;  // this tile computes the frame before it
    const int runs = ceil_div(TF + extra, kRun);

    // (1) branch FIR
    for (int it = tid; it < nch * runs; it += kThreads) {
      const int p = it % nch;
      const int rho0 = (it / nch) * kRun - extra;
      fir_run(S, taps, nch, L, lay.H, lay.E, TF, rho0, p, lay.ldU, Uh, Ul);
    }
    __syncthreads();

    // (2) DFT on the tensor cores: each warpgroup task is 64 rows (warp w4:
    // rows 16·w4 .. + 15, A by ldmatrix.x4 from U) by 32 columns of D (B
    // from shared memory), 3 wgmmas per k-step
    for (int task = wg; task < lay.MB * lay.NG; task += kGroups) {
      const int mb = task / lay.NG, ng = task - mb * lay.NG;
      float acc[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] = 0.f;
      // ldmatrix.x4 rows of this lane: matrix L >> 3 = (rows + 8, words + 4)
      const uint32_t a_addr =
          Uh_s + 4 * ((mb * kM + 16 * w4 + (lane & 7) + 8 * ((lane >> 3) & 1)) * lay.ldU +
                      4 * (lane >> 4));
      const uint32_t b_addr = B_s + ng * kN * 128;
      // one k-step, then wait for the one before, whose A registers `ph`,
      // `pl` may now be reused
      auto step = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4], uint32_t (&ph)[4],
                      uint32_t (&pl)[4]) {
        csdr::ldmatrix_x4(ah, a_addr + 32 * kk);
        csdr::ldmatrix_x4(al, a_addr + 32 * kk + lo_off);
        const uint32_t bh = b_addr + (kk >> 2) * lay.NP * 128 + 32 * (kk & 3), bl = bh + lay.b_part;
        csdr::wgmma_fence();
        csdr::wgmma_m64n32k16(acc, al, csdr::desc_sw128(bh));
        csdr::wgmma_m64n32k16(acc, ah, csdr::desc_sw128(bl));
        csdr::wgmma_m64n32k16(acc, ah, csdr::desc_sw128(bh));
        csdr::wgmma_commit();
        csdr::wgmma_wait<1>();
        hold(ph);
        hold(pl);
      };
      hold(acc);
      uint32_t a0h[4], a0l[4], a1h[4] = {0, 0, 0, 0}, a1l[4] = {0, 0, 0, 0};
      int kk = 0;
      for (; kk + 1 < lay.KS; kk += 2) {
        step(kk, a0h, a0l, a1h, a1l);
        step(kk + 1, a1h, a1l, a0h, a0l);
      }
      if (kk < lay.KS) step(kk, a0h, a0l, a1h, a1l);
      csdr::wgmma_wait<0>();
      hold(acc);
      // acc[4i + e]: row 16·w4 + gid (+ 8 for e >= 2), column 8i + 2tig
      // (+ e & 1), so (acc[4i], acc[4i + 1]) is channel 16·ng + 4i + tig
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * ng + 4 * i + tig, t = mb * kM + 16 * w4 + gid;
        if (k >= ncho) continue;
        if constexpr (DEMOD) {
          if (t < TF) S[t * lay.ldD + k] = make_float2(acc[4 * i], acc[4 * i + 1]);
          if (t + 8 < TF) S[(t + 8) * lay.ldD + k] = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
        } else {
          float2* chan = static_cast<float2*>(out) + (long long)k * F + f0;
          if (t < TF) chan[t] = make_float2(acc[4 * i], acc[4 * i + 1]);
          if (t + 8 < TF) chan[t + 8] = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
        }
      }
    }

    if (DEMOD && extra) {
      // K3's frame before a block's first tile: D row TF = U row TF (hi +
      // lo) times W in FP32, on the CUDA cores
      for (int k = tid; k < ncho; k += kThreads) {
        float2 d = make_float2(0.f, 0.f);
        for (int p = 0; p < nch; ++p) {
          const uint32_t h = Uh[TF * lay.ldU + p], l = Ul[TF * lay.ldU + p];
          const float ur = __uint_as_float(h << 16) + __uint_as_float(l << 16);
          const float ui = __uint_as_float(h & 0xFFFF0000u) + __uint_as_float(l & 0xFFFF0000u);
          const float2 w = W_g[(long long)p * ncho + k];
          d.x = fmaf(ur, w.x, fmaf(-ui, w.y, d.x));
          d.y = fmaf(ur, w.y, fmaf(ui, w.x, d.y));
        }
        S[TF * lay.ldD + k] = d;
      }
    }

    if constexpr (DEMOD) {
      // (3) K3's demod, channel-major with the lanes along frames; the
      // frame before the tile is row TF (a block's first tile) or the
      // previous tile's last row
      __syncthreads();
      const float2* prev = carry + ((i - 1) & 1) * lay.ldD;
      float2* last = carry + (i & 1) * lay.ldD;
      const int k_step = kThreads % TF == 0 ? kThreads / TF : 0;  // else divide per output
      for (int e = tid, k = tid / TF, t = tid % TF; e < TF * ncho; e += kThreads, k += k_step) {
        if (k_step == 0) k = e / TF, t = e - k * TF;
        const float2 a = S[t * lay.ldD + k];
        const float2 b = t > 0 ? S[(t - 1) * lay.ldD + k] : extra ? S[TF * lay.ldD + k] : prev[k];
        if (t == TF - 1) last[k] = a;
        static_cast<float*>(out)[(long long)k * F + f0 + t] = demod(a.x, a.y, b.x, b.y, inv_kf);
      }
    }
  }
  csdr::cp_async_wait<0>();
}

template <bool DEMOD>
cudaError_t launch(const void* vfull, const void* taps, const void* W, long long F, int nch,
                   int ncho, int L, int TF, float inv_kf, void* out, cudaStream_t st) {
  const size_t smem = Layout(DEMOD, nch, ncho, L, TF).smem(nch, L);
  cudaError_t e = csdr::allow_smem(&pfb_tile<DEMOD>, smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 0;
  e = csdr::persistent_grid(&pfb_tile<DEMOD>, kThreads, smem, F / TF, &grid);
  if (e != cudaSuccess) return e;
  pfb_tile<DEMOD><<<grid, kThreads, smem, st>>>(
      static_cast<const float2*>(vfull), static_cast<const float*>(taps),
      static_cast<const float2*>(W), F, nch, ncho, L, TF, inv_kf, out);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" long long csdr_pfb_smem(int demod, int nch, int ncho, int L, int TF) {
  return (long long)Layout(demod != 0, nch, ncho, L, TF).smem(nch, L);
}

// One launch of K3 (demod != 0: audio (ncho, F) float32) or K4 (demod == 0:
// channels (ncho, F) complex64) on `stream`; returns the first CUDA error
// (0 when it launched).  Shapes: vfull (F + L + (demod ? 0 : −1), nch),
// TF | F (frames per tile).
extern "C" int csdr_pfb_fused(int demod, const void* vfull, const void* taps, const void* W,
                              long long F, int nch, int ncho, int L, int TF, float inv_kf,
                              void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return demod ? launch<true>(vfull, taps, W, F, nch, ncho, L, TF, inv_kf, out, st)
               : launch<false>(vfull, taps, W, F, nch, ncho, L, TF, inv_kf, out, st);
}
