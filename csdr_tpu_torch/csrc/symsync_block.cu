// The block-parallel symbol synchronizer for Hopper (sm_90a), K9: the timing
// tone, the line fit and the polyphase interpolation of SymSync (block mode)
// in two launches.
//
// Replaces no Pallas kernel.  It replaces the jnp gathers of
// csdr_tpu/models/symsync.py SymSync.apply, which the port first wrote as
// eager PyTorch ops: ~270 launches a block at the DeNBFMSync flow's shape
// (64 rows of 262,080 samples, k 10, W 81 taps, npfb 64), chunked gathers
// of (rows, nout, taps) index and sample panels that move several GB.  The
// work itself: each row of [hist | x] read once, each output written once,
// the bank once, ~81 MB and ~0.58 GFLOP at that shape, ~24 us at 3.35 TB/s;
// so bytes bound it, and the design reads each input sample from device
// memory twice (once per launch) and never writes an intermediate larger
// than the window sums.
//
// Launch 1, sync_tone, grid (parts, nw, rows): block (p, w, r) sums part p
// of timing window w of row r, z[i] = s[i]·e^{−2πi·i/k} with
// s[i] = |x[i] − x[i−1]|² (s[0] repeats s[1]'s term, or, on a time rank
// past the first, differences against the left neighbour's last sample),
// rot[i] the caller's row-length rotator, the very numbers the plain version
// multiplies by (one row long, read from L2 by every row).  The products
// and sums are float64, as in the plain version: where the tone sits on the
// real axis (a signal on an integer timing grid), the sign of its imaginary
// part decides the first window's unwrap (τ ≈ 0 or ≈ k), and a float32 sum
// leaves that sign to its order; float64 leaves it to the signal.  Each
// thread sums its samples i ≡ tid (mod 256) in order, then a fixed
// xor-shuffle tree and a tree over the warps: no atomics, so two runs are
// bit-identical.  The split
// into parts depends on the window length alone, so the sharded step's
// partials equal the serial step's window by window.
//
// Launch 2, sync_interp, grid (tiles, rows), kPer outputs per thread, a
// tile of kPer·threads consecutive outputs a block:
//  - warp 0 sums the row's partials in a fixed order into the window sums
//    Tw (…, nw), rounded to complex64, and lane 0 fits the line as the
//    plain fit_line does, in float32 and in its order (angle, unwrap
//    against the carried τ, the weighted line, the clamp, the bounded
//    carry with its slip); tile 0 writes the carried τ;
//  - every thread takes its outputs' positions as the plain positions does,
//    an integer grid point plus a float32 residual, round half to even,
//    every product and sum an explicit _rn intrinsic (no FMA contraction),
//    so the kernel picks the window and bank phase the eager path picks
//    wherever its line is the same;
//  - the block stages the span of samples its windows cover in shared
//    memory once, read through up to three row segments ([hist | x] in
//    serial, [left halo | x | right halo] sharded) with no concatenation on
//    the card; a window leaving the row reads as the eager gather does (a
//    negative index wraps once, the rest clamps).  The staging area holds
//    every tile's span: |slope| ≤ 0.2 bounds it, a position is held within
//    2^24 samples of its grid point (float32 steps by at most 2 there, so a
//    NaN or far-off line cannot widen the span), and the wrapper's cap adds
//    a quarter and 64 samples of room; a span over it traps;
//  - the bank (npfb × W float32) sits in shared memory; an output is the sum
//    over its W taps in four interleaved partial sums (FMA), bank row p
//    interpolating at ipos − p/npfb, the JAX package's convention.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kToneThreads = 256;
constexpr int kMaxWindows = 8;    // windows(): at most 8 timing windows
constexpr int kMaxParts = 64;     // partial sums per timing window
constexpr int kMaxTaps = 1024;    // W = 2mk + 1
constexpr int kPer = 4;           // outputs per thread of sync_interp

struct Real {
  using T = float;
  static __device__ __forceinline__ float energy(T a, T b) {
    const float d = __fsub_rn(a, b);
    return __fmul_rn(d, d);
  }
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T madd(T acc, T x, float b) { return fmaf(x, b, acc); }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};

struct Complex {
  using T = float2;
  static __device__ __forceinline__ float energy(T a, T b) {
    const float dr = __fsub_rn(a.x, b.x), di = __fsub_rn(a.y, b.y);
    return __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
  }
  static __device__ __forceinline__ T zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ T madd(T acc, T x, float b) {
    return make_float2(fmaf(x.x, b, acc.x), fmaf(x.y, b, acc.y));
  }
  static __device__ __forceinline__ T add(T a, T b) { return make_float2(a.x + b.x, a.y + b.y); }
};

__device__ __forceinline__ double2 shfl_add(double2 v, int off) {
  v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
  v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  return v;
}

// torch.remainder: fmodf, then + y where the signs differ.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = __fadd_rn(r, y);
  return r;
}

template <typename K>
__global__ void __launch_bounds__(kToneThreads) sync_tone(
    const typename K::T* __restrict__ x, int n, const typename K::T* __restrict__ prev,
    const float2* __restrict__ rot, int wlen, int nw, int parts, int seg,
    double2* __restrict__ partials) {
  using T = typename K::T;
  __shared__ double2 swarp[kToneThreads / 32];
  const int p = blockIdx.x, w = blockIdx.y;
  const long long row = blockIdx.z;
  const T* xr = x + row * n;
  const int lo = w * wlen + p * seg;
  const int hi = min(lo + seg, (w + 1) * wlen);
  double ax = 0.0, ay = 0.0;
  for (int i = lo + threadIdx.x; i < hi; i += kToneThreads) {
    float s;
    if (i > 0) {
      s = K::energy(xr[i], xr[i - 1]);
    } else {
      s = prev != nullptr ? K::energy(xr[0], prev[row]) : K::energy(xr[1], xr[0]);
    }
    const float2 c = rot[i];
    ax = fma((double)s, (double)c.x, ax);   // the product is exact in float64
    ay = fma((double)s, (double)c.y, ay);
  }
  double2 v = make_double2(ax, ay);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = shfl_add(v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) swarp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kToneThreads / 32 ? swarp[lane] : make_double2(0.0, 0.0);
#pragma unroll
    for (int off = kToneThreads / 64; off > 0; off >>= 1) v = shfl_add(v, off);
    if (lane == 0) partials[(row * nw + w) * parts + p] = v;
  }
}

struct Line {
  float tm, slope, cm, carry;
};

// The plain fit_line (ops/cuda/symsync_block.py) for one row, in its float32
// order.
__device__ Line fit_line(const float2* Tw, int nw, long long n, int k, float scale, float B,
                         float tau_prev, bool valid) {
  const float kf = (float)k, half = __fmul_rn(kf, 0.5f);
  float tau_w[kMaxWindows], seq[kMaxWindows], wgt[kMaxWindows], cen[kMaxWindows];
  const double wl = (double)(n / nw);
  for (int w = 0; w < nw; ++w) {
    tau_w[w] = __fmul_rn(-atan2f(Tw[w].y, Tw[w].x), scale);
    wgt[w] = __fadd_rn(hypotf(Tw[w].x, Tw[w].y), 1e-12f);
    cen[w] = __double2float_rn((w + 0.5) * wl);
  }
  // unwrap: the first window against the carried estimate, then window to
  // window
  float t0 = floor_mod(tau_w[0], kf);
  const float d0 = __fsub_rn(floor_mod(__fadd_rn(__fsub_rn(t0, tau_prev), half), kf), half);
  t0 = valid ? __fadd_rn(tau_prev, d0) : t0;
  float cum = 0.0f;
  seq[0] = __fadd_rn(t0, 0.0f);
  for (int w = 1; w < nw; ++w) {
    const float step =
        __fsub_rn(floor_mod(__fadd_rn(__fsub_rn(tau_w[w], tau_w[w - 1]), half), kf), half);
    cum = __fadd_rn(cum, step);
    seq[w] = __fadd_rn(t0, cum);
  }
  float wsum = 0.0f, scm = 0.0f, stm = 0.0f;
  for (int w = 0; w < nw; ++w) {
    wsum = __fadd_rn(wsum, wgt[w]);
    scm = __fadd_rn(scm, __fmul_rn(wgt[w], cen[w]));
    stm = __fadd_rn(stm, __fmul_rn(wgt[w], seq[w]));
  }
  Line L;
  L.cm = __fdiv_rn(scm, wsum);
  L.tm = __fdiv_rn(stm, wsum);
  float var = 0.0f, cov = 0.0f;
  for (int w = 0; w < nw; ++w) {
    const float dc = __fsub_rn(cen[w], L.cm);
    var = __fadd_rn(var, __fmul_rn(wgt[w], __fmul_rn(dc, dc)));
    cov = __fadd_rn(cov, __fmul_rn(__fmul_rn(wgt[w], dc), __fsub_rn(seq[w], L.tm)));
  }
  var = __fadd_rn(var, 1e-6f);
  float slope = nw > 1 ? __fdiv_rn(cov, var) : 0.0f;
  slope = slope < -0.2f ? -0.2f : (slope > 0.2f ? 0.2f : slope);
  L.slope = slope;
  // τ at the block end, then the bounded carry: only once |τ| leaves the
  // slack B does it snap back by whole symbols
  float carry = __fadd_rn(L.tm, __fmul_rn(slope, __fsub_rn(__ll2float_rn(n), L.cm)));
  const float over = fmaxf(__fsub_rn(fabsf(carry), B), 0.0f);
  const float slip = ceilf(__fdiv_rn(over, kf));
  const float sgn = carry > 0.0f ? 1.0f : (carry < 0.0f ? -1.0f : 0.0f);
  L.carry = __fsub_rn(carry, __fmul_rn(__fmul_rn(slip, kf), sgn));
  return L;
}

// A row as up to three segments a | b | c of la, lb, lc samples.
template <typename T>
struct Row {
  const T* a;
  const T* b;
  const T* c;
  int la, lb, L;
  // sample g of the row as the eager gather reads it: a negative index
  // wraps once, the rest clamps into [0, L − 1]
  __device__ __forceinline__ T at(int g) const {
    if (g < 0) g += L;
    g = min(max(g, 0), L - 1);
    if (g < la) return a[g];
    g -= la;
    return g < lb ? b[g] : c[g - lb];
  }
};

template <typename K>
__global__ void __launch_bounds__(256) sync_interp(
    const typename K::T* __restrict__ a, int la, const typename K::T* __restrict__ b, int lb,
    const typename K::T* __restrict__ c, int lc, const double2* __restrict__ partials, int nw,
    int parts, const float* __restrict__ tau_prev, int tau_stride,
    const unsigned char* __restrict__ valid, int valid_stride, const float* __restrict__ bank,
    int npfb, int W, int k, int mk, int ops, long long n, float scale, float B, long long start,
    long long j0, long long origin, int nout, int cap, typename K::T* __restrict__ y,
    float* __restrict__ tau_out, float* __restrict__ line_out, typename K::T* __restrict__ hist_out,
    int hout) {
  using T = typename K::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sbank = reinterpret_cast<float*>(smem_raw);                      // npfb × W
  T* swin = reinterpret_cast<T*>(sbank + ((npfb * W + 3) & ~3));          // cap samples
  __shared__ float2 sTw[kMaxWindows];
  __shared__ float sline[3];
  __shared__ int slo, shi;
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const Row<T> rw{a + row * la, b + row * lb, c + row * lc, la, lb, la + lb + lc};
  {
    // 16-byte copies (the bank tensor's base is aligned), several in flight
    const int n4 = (npfb * W) >> 2;
    const float4* b4 = reinterpret_cast<const float4*>(bank);
    float4* s4 = reinterpret_cast<float4*>(sbank);
#pragma unroll 4
    for (int i = tid; i < n4; i += blockDim.x) s4[i] = b4[i];
    for (int i = 4 * n4 + tid; i < npfb * W; i += blockDim.x) sbank[i] = bank[i];
  }
  if (tid < 32) {
    for (int w = 0; w < nw; ++w) {
      const double2* pp = partials + (row * nw + w) * parts;
      double2 v = make_double2(0.0, 0.0);
      for (int p = tid; p < parts; p += 32) {
        v.x += pp[p].x;
        v.y += pp[p].y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = shfl_add(v, off);
      if (tid == 0) sTw[w] = make_float2(__double2float_rn(v.x), __double2float_rn(v.y));
    }
    __syncwarp();
    if (tid == 0) {
      const Line L = fit_line(sTw, nw, n, k, scale, B, tau_prev[row * tau_stride],
                              valid[row * valid_stride] != 0);
      sline[0] = L.tm;
      sline[1] = L.slope;
      sline[2] = L.cm;
      if (blockIdx.x == 0) {
        tau_out[row] = L.carry;
        if (line_out != nullptr) {
          line_out[row] = L.tm;
          line_out[gridDim.y + row] = L.slope;
          line_out[2 * gridDim.y + row] = L.cm;
        }
      }
      slo = INT_MAX;
      shi = INT_MIN;
    }
  }
  __syncthreads();
  const float tm = sline[0], slope = sline[1], cm = sline[2];
  const float halfk = __fmul_rn((float)k, 0.5f);
  const int j_first = blockIdx.x * blockDim.x * kPer + tid;
  int ipos[kPer], ph[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int jl = j_first + q * blockDim.x;
    ipos[q] = ph[q] = 0;
    if (jl < nout) {
      // the plain positions: the integer grid point and the float32 residual
      const long long num = (j0 + jl) * (long long)k;
      const long long bi = start + num / ops;
      const float bf = __fdiv_rn((float)(num % ops), (float)ops);
      const float bdiff = __fadd_rn(__fsub_rn(__ll2float_rn(bi), cm), bf);
      const float delta =
          __fadd_rn(__fadd_rn(__fadd_rn(tm, __fmul_rn(slope, bdiff)), halfk), bf);
      const float dlo = floorf(delta);
      const float f = __fmul_rn(__fsub_rn(delta, dlo), (float)npfb);
      // held within 2^24 of the grid point (NaN too): |ipos| < 2^31
      ipos[q] = (int)(bi + (long long)fminf(fmaxf(dlo, -16777216.0f), 16777216.0f) - origin);
      ph[q] = min(max((int)rintf(f), 0), npfb - 1);
      atomicMin(&slo, ipos[q]);
      atomicMax(&shi, ipos[q]);
    }
  }
  __syncthreads();
  const int lo = slo - mk;
  if (shi >= slo) {
    const long long span = (long long)shi - slo + W;
    if (span > cap) __trap();
#pragma unroll 4
    for (int q = tid; q < span; q += blockDim.x) swin[q] = rw.at(lo + q);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int jl = j_first + q * blockDim.x;
    if (jl >= nout) break;
    const float* bk = sbank + ph[q] * W;
    const T* src = swin + (ipos[q] - mk - lo);
    T a0 = K::zero(), a1 = K::zero(), a2 = K::zero(), a3 = K::zero();
    int l = 0;
    for (; l + 4 <= W; l += 4) {
      a0 = K::madd(a0, src[l], bk[l]);
      a1 = K::madd(a1, src[l + 1], bk[l + 1]);
      a2 = K::madd(a2, src[l + 2], bk[l + 2]);
      a3 = K::madd(a3, src[l + 3], bk[l + 3]);
    }
    for (; l < W; ++l) a0 = K::madd(a0, src[l], bk[l]);
    y[row * nout + jl] = K::add(K::add(a0, a1), K::add(a2, a3));
  }
  if (hist_out != nullptr && blockIdx.x == 0) {
    for (int q = tid; q < hout; q += blockDim.x) hist_out[row * hout + q] = rw.at(rw.L - hout + q);
  }
}

template <typename K>
cudaError_t tone(const void* x, int n, int rows, const void* prev, const void* rot, int wlen,
                 int nw, int parts, int seg, void* partials, cudaStream_t st) {
  using T = typename K::T;
  sync_tone<K><<<dim3(parts, nw, rows), kToneThreads, 0, st>>>(
      static_cast<const T*>(x), n, static_cast<const T*>(prev), static_cast<const float2*>(rot),
      wlen, nw, parts, seg, static_cast<double2*>(partials));
  return cudaGetLastError();
}

template <typename K>
cudaError_t interp(const void* a, int la, const void* b, int lb, const void* c, int lc, int rows,
                   const void* partials, int nw, int parts, const void* tau_prev, int tau_stride,
                   const void* valid, int valid_stride, const void* bank, int npfb, int W, int k,
                   int mk, int ops, long long n, float scale, float B, long long start,
                   long long j0, long long origin, int nout, int tile, int cap, void* y,
                   void* tau_out, void* line_out, void* hist_out, int hout, cudaStream_t st) {
  using T = typename K::T;
  const size_t smem = sizeof(float) * (size_t)((npfb * W + 3) & ~3) + sizeof(T) * (size_t)cap;
  cudaError_t e = cudaFuncSetAttribute(&sync_interp<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = nout > 0 ? (nout + tile * kPer - 1) / (tile * kPer) : 1;
  sync_interp<K><<<dim3(tiles, rows), tile, smem, st>>>(
      static_cast<const T*>(a), la, static_cast<const T*>(b), lb, static_cast<const T*>(c), lc,
      static_cast<const double2*>(partials), nw, parts, static_cast<const float*>(tau_prev),
      tau_stride, static_cast<const unsigned char*>(valid), valid_stride,
      static_cast<const float*>(bank), npfb, W, k, mk, ops, n, scale, B, start, j0, origin, nout,
      cap, static_cast<T*>(y), static_cast<float*>(tau_out), static_cast<float*>(line_out),
      static_cast<T*>(hist_out), hout);
  return cudaGetLastError();
}

}  // namespace

// Launch 1 over `rows` rows of n samples on `stream`; returns the first CUDA
// error (0 when it launched).  is_complex: x and prev are float2
// (complex64), else float.  prev: (rows,) samples before each row, or null
// (the head rule).  rot: (n,) complex64, e^{−2πi·i/k}.  partials: (rows, nw,
// parts) complex128, window w's part p covering samples [w·wlen + p·seg, …).
extern "C" int csdr_sync_tone(int is_complex, const void* x, long long n, int rows,
                              const void* prev, const void* rot, long long wlen, int nw,
                              int parts, long long seg, void* partials, void* stream) {
  if (nw < 1 || nw > kMaxWindows || parts < 1 || parts > kMaxParts ||
      n < 2 || n >= (1LL << 30) || (long long)nw * wlen > n || (long long)parts * seg < wlen ||
      rows < 1 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_complex ? tone<Complex>(x, (int)n, rows, prev, rot, (int)wlen, nw, parts,
                                          (int)seg, partials, st)
                          : tone<Real>(x, (int)n, rows, prev, rot, (int)wlen, nw, parts,
                                       (int)seg, partials, st));
}

// Launch 2 over `rows` rows of the row a | b | c (each (rows, l·) contiguous;
// lb or lc may be 0) on `stream`.  partials: (rows, nw, parts) complex128;
// tau_prev float32 and valid bool, element row·stride (stride 0 or 1); bank
// (npfb, W) float32; n the block length the line is fitted over; outputs
// j0 … j0 + nout − 1 of the block, at index − origin of the row; y (rows,
// nout), tau_out (rows,) float32, line_out (3, rows) float32 the line
// (tm, slope, cm) the outputs sit on, or null, hist_out (rows, hout) the
// row's last hout samples, or null.  tile threads a block (a multiple of 32 up to 256), cap
// samples of staging; a block covers tile·kPer outputs.
extern "C" int csdr_sync_interp(int is_complex, const void* a, long long la, const void* b,
                                long long lb, const void* c, long long lc, int rows,
                                const void* partials, int nw, int parts, const void* tau_prev,
                                int tau_stride, const void* valid, int valid_stride,
                                const void* bank, int npfb, int W, int k, int mk, int ops,
                                long long n, float scale, float B, long long start, long long j0,
                                long long origin, long long nout, int tile, int cap, void* y,
                                void* tau_out, void* line_out, void* hist_out, long long hout,
                                void* stream) {
  if (W < 1 || W > kMaxTaps || npfb < 1 || nw < 1 || nw > kMaxWindows || parts < 1 ||
      parts > kMaxParts || la + lb + lc >= (1LL << 30) || la + lb + lc < W || nout < 0 ||
      nout >= (1LL << 31) - 256 || tile < 32 || tile > 256 || tile % 32 || cap < W || rows < 1 ||
      rows > 65535 || ops < 1 || k < 2 || hout < 0 || hout > la + lb + lc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_complex
                   ? interp<Complex>(a, (int)la, b, (int)lb, c, (int)lc, rows, partials, nw, parts,
                                     tau_prev, tau_stride, valid, valid_stride, bank, npfb, W, k,
                                     mk, ops, n, scale, B, start, j0, origin, (int)nout, tile, cap,
                                     y, tau_out, line_out, hist_out, (int)hout, st)
                   : interp<Real>(a, (int)la, b, (int)lb, c, (int)lc, rows, partials, nw, parts,
                                  tau_prev, tau_stride, valid, valid_stride, bank, npfb, W, k, mk,
                                  ops, n, scale, B, start, j0, origin, (int)nout, tile, cap, y,
                                  tau_out, line_out, hist_out, (int)hout, st));
}
