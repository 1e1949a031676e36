"""The port's FIR family (ops/fir.py) and the plain versions of its kernels
K5 (ops/cuda/fir_valid.py) and K6 (ops/cuda/fft_fir.py) against the JAX
package, on numpy-seeded inputs.

Tolerances, each with its source, relative to the largest output:
  * conv_valid per strategy: 1e-3 real, 2e-3 complex (tests/test_fir.py:25,36);
  * K5's plain version vs pallas_fir_valid(interpret=True): 2e-3
    (tests/test_pallas_fir.py:21,32);
  * K6's plain version vs fft_fir_valid(interpret=True): 2e-4
    (tests/test_fftfir.py:36,51);
  * the streaming FIRs: 1e-3 (fir_stream) and 2e-3 (decim, interp)
    (tests/test_fir.py:49,71,90); batched rows equal row by row within
    float32 rounding, 1e-6 (the batched conv1d and FFT sum in another order).
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from csdr_tpu.ops import fir as jfir
from csdr_tpu.ops.pallas.bf16x3 import split_bf16_np
from csdr_tpu.ops.pallas.fftfir import fft_fir_valid as jax_fft_fir_valid
from csdr_tpu.ops.pallas.fir_kernel import pallas_fir_valid
from csdr_tpu.utils import firdes as jfirdes

import csdr_tpu_torch as ct
from csdr_tpu_torch.ops import fir as tfir
from csdr_tpu_torch.ops.cuda import bf16x3
from csdr_tpu_torch.ops.cuda import fft_fir as k6
from csdr_tpu_torch.ops.cuda import fir_valid as k5
from csdr_tpu_torch.utils import firdes as tfirdes

torch.set_num_threads(1)


def _rel(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


def _signal(rng, n, cplx):
    x = rng.normal(size=n).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.normal(size=n)).astype(np.complex64)
    return x


def test_fir_designs_equal():
    for df, as_db in [(0.001, 60.0), (0.00625, 60.0), (0.02, 60.0), (0.1, 80.0), (5.0, 60.0)]:
        assert tfirdes.kaiser_filter_len(df, as_db) == jfirdes.kaiser_filter_len(df, as_db)
    for m in (2, 4, 5):
        np.testing.assert_array_equal(tfirdes.firdecim_kaiser(m, 10, 60.0),
                                      jfirdes.firdecim_kaiser(m, 10, 60.0))
    np.testing.assert_array_equal(tfirdes.halfband_kaiser(12, 60.0),
                                  jfirdes.halfband_kaiser(12, 60.0))
    with pytest.raises(ValueError):
        tfirdes.kaiser_filter_len(0.0, 60.0)


@pytest.mark.parametrize("K,strategy,cplx", [(7, "slices", False), (33, "slices", False),
                                             (33, "fft", False), (257, "fft", False),
                                             (41, "slices", True), (41, "fft", True)])
def test_conv_valid_matches_jax(K, strategy, cplx):
    rng = np.random.default_rng(K)
    h = rng.normal(size=K) + (1j * rng.normal(size=K) if cplx else 0)
    xfull = _signal(rng, 3000 + K - 1, cplx)
    want = np.asarray(jfir.conv_valid(jnp.asarray(xfull), h, strategy))
    got = tfir.conv_valid(torch.from_numpy(xfull), h, strategy)
    assert got.dtype == (torch.complex64 if cplx else torch.float32)
    assert _rel(got, want) < (2e-3 if cplx else 1e-3)


def test_real_input_complex_taps_give_complex_output():
    """The SSB chain relies on it in both strategies."""
    rng = np.random.default_rng(5)
    h = rng.normal(size=80) * np.exp(2j * np.pi * 0.1 * np.arange(80))
    xfull = _signal(rng, 2000 + 79, False)
    for strategy in ("fft", "pallas_fft"):
        want = np.asarray(jfir.conv_valid(jnp.asarray(xfull), h, "fft"))
        got = tfir.conv_valid(torch.from_numpy(xfull), h, strategy)
        assert got.dtype == torch.complex64
        assert _rel(got, want) < 2e-3


@pytest.mark.parametrize("K,n,cplx", [(63, 4000, False), (401, 10000, False),
                                      (1000, 8192, False), (200, 5000, True)])
def test_k5_plain_matches_pallas_interpret(K, n, cplx):
    rng = np.random.default_rng(K)
    h = rng.normal(size=K)
    xfull = _signal(rng, n + K - 1, cplx)
    want = np.asarray(pallas_fir_valid(jnp.asarray(xfull), h, interpret=True))
    got = k5.fir_valid(torch.from_numpy(xfull), h)
    assert got.dtype == torch.from_numpy(xfull).dtype
    assert _rel(got, want) < 2e-3
    assert _rel(tfir.conv_valid(torch.from_numpy(xfull), h, "pallas_mxu"), want) < 2e-3


@pytest.mark.parametrize("cplx", [False, True])
def test_k5_batched_rows_equal_row_by_row(cplx):
    rng = np.random.default_rng(7)
    h = rng.normal(size=300)
    xfull = torch.from_numpy(_signal(rng, 3 * 1299, cplx).reshape(3, 1299))
    rows = k5.fir_valid(xfull, h)
    assert rows.shape == (3, 1000)
    for b in range(3):
        assert _rel(rows[b], k5.fir_valid(xfull[b], h)) < 1e-6


@pytest.mark.parametrize("K,cplx", [(1, False), (401, False), (2048, False),
                                    (1, True), (401, True), (2048, True)])
def test_k6_plain_matches_pallas_interpret(K, cplx):
    """real/real and complex/complex; n spans several 16384-sample segments."""
    rng = np.random.default_rng(K + cplx)
    taps = rng.normal(size=K) / np.sqrt(K)
    if cplx:
        taps = taps * np.exp(2j * np.pi * 0.19 * np.arange(K))
    xfull = _signal(rng, 40_000 + K - 1, cplx)
    want = np.asarray(jax_fft_fir_valid(jnp.asarray(xfull), taps, interpret=True))
    got = k6.fft_fir_valid(torch.from_numpy(xfull), taps)
    assert got.dtype == (torch.complex64 if cplx else torch.float32)
    assert _rel(got, want) < 2e-4


def test_k6_refuses_as_jax_does():
    with pytest.raises(ValueError, match="shorter than"):
        k6.fft_fir_valid(torch.zeros(20000), np.zeros(16384))
    with pytest.raises(ValueError, match="longer than taps"):
        k6.fft_fir_valid(torch.zeros(63), np.ones(64, np.float32))


def test_kernel_wrappers_refuse_other_devices():
    x = torch.empty(1000, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k5.fir_valid(x, np.ones(10))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k6.fft_fir_valid(x, np.ones(10))
    with pytest.raises(ValueError, match="real taps"):
        tfir.conv_valid(torch.zeros(1000), np.ones(300) + 1j, "pallas_mxu")


REV4 = np.array([int(f"{k:04b}"[::-1], 2) for k in range(16)])


def _dft_reg(v, inv):
    """csrc/fft_reg.cuh dft_reg over axis 0: radix-2 DIF, natural order in,
    bit-reversed order out."""
    v = v.copy()
    P = v.shape[0]
    half = P // 2
    while half >= 1:
        for g in range(0, P, 2 * half):
            for j in range(half):
                a, b = v[g + j].copy(), v[g + j + half].copy()
                e = j * (16 // (2 * half))
                v[g + j], v[g + j + half] = a + b, (a - b) * np.exp((1 if inv else -1) * 2j
                                                                     * np.pi * e / 16)
        half //= 2
    return v


def _twiddle(v, r, N, inv, out_rev):
    """csrc/fft_fir.cu twiddle: v[i] *= W_N^{∓r·k(i)}, k(i) = rev4(i) on a
    DFT's outputs."""
    k = np.arange(16)
    w = np.exp((1 if inv else -1) * 2j * np.pi * np.outer(k, r) / N)
    idx = REV4 if out_rev else k
    v[idx] = v[idx] * w


def _dft4_blocks(v, inv):
    """Pass 4 (or its inverse): four DFT4s over each thread's 16 points."""
    for q in range(4):
        a = _dft_reg(v[4 * q:4 * q + 4], inv)
        v[4 * q:4 * q + 4] = a[[0, 2, 1, 3]]


def _k6_schedule(xrow, taps):
    """One row through the pass schedule of csrc/fft_fir.cu in numpy, with
    the wrapper's H table: 1024 butterflies of 16 points per pass, real
    input with real taps paired into one complex transform."""
    S, K = k6.S, len(taps)
    n = len(xrow) - (K - 1)
    hop, nseg = k6.segments(n, K)
    pair = not np.iscomplexobj(xrow) and not np.iscomplexobj(taps)
    Ht = k6._kernel_spectrum_on(taps.tobytes(), taps.dtype.str, torch.device("cpu")).numpy()
    Ht = Ht.astype(np.complex128).reshape(16, S // 16)
    x = np.concatenate([xrow, np.zeros(2 * S + hop * nseg, xrow.dtype)]).astype(np.complex128)
    y = np.zeros(n, np.float64 if pair else np.complex128)
    u, m = np.arange(S // 16), np.arange(16)[:, None]
    for seg in range(0, nseg, 2 if pair else 1):
        start = seg * hop
        has2 = pair and seg + 1 < nseg
        v = x[start + u + 1024 * m]
        if has2:
            v = v + 1j * x[start + hop + u + 1024 * m]
        s = np.zeros(S, np.complex128)
        v = _dft_reg(v, False)
        _twiddle(v, u, S, False, True)
        s[u + 1024 * m] = v[REV4]
        for N in (1024, 64):
            st = N // 16
            pos = (u // st) * N + u % st + st * m
            v = _dft_reg(s[pos], False)
            _twiddle(v, u % st, N, False, True)
            s[pos] = v[REV4]
        v = s[16 * u + m]
        _dft4_blocks(v, False)
        v *= Ht
        _dft4_blocks(v, True)
        s[16 * u + m] = v
        for N in (64, 1024):
            st = N // 16
            pos = (u // st) * N + u % st + st * m
            v = s[pos]
            _twiddle(v, u % st, N, True, False)
            s[pos] = _dft_reg(v, True)[REV4]
        v = s[u + 1024 * m]
        _twiddle(v, u, S, True, False)
        z = _dft_reg(v, True)[REV4].reshape(-1)   # position u + 1024·m
        i = (u + 1024 * m).reshape(-1)
        keep = i >= K - 1
        o = start + i[keep] - (K - 1)
        zk = z[keep]
        ok = o < n
        y[o[ok]] = zk[ok].real if pair else zk[ok]
        if has2:
            ok2 = o + hop < n
            y[o[ok2] + hop] = zk[ok2].imag
    return y


def test_k6_transform_order_is_a_permutation():
    order = k6.transform_order()
    assert sorted(order.tolist()) == list(range(k6.S))
    pads = {p + (p >> 4) for p in range(k6.S)}   # the exchange buffer's padding
    assert len(pads) == k6.S and max(pads) < k6.S + k6.S // 16


@pytest.mark.parametrize("case,K,nseg", [("complex_taps", 1826, 2), ("real_pair_odd", 3651, 3),
                                         ("real_in_complex_taps", 300, 1)])
def test_k6_tables_through_the_kernel_schedule(case, K, nseg):
    """The kernel's H table driven through the register-pass schedule of
    csrc/fft_fir.cu, transcribed in numpy, equals the plain version: complex
    input and taps; real × real with an odd segment count (the last pair
    half empty); real input with complex taps."""
    rng = np.random.default_rng(K)
    taps = rng.normal(size=K) / np.sqrt(K)
    if case != "real_pair_odd":
        taps = taps * np.exp(2j * np.pi * 0.05 * np.arange(K))
    hop = k6.S - (K - 1)
    n = (nseg - 1) * hop + hop // 2
    xfull = _signal(rng, n + K - 1, case == "complex_taps")
    assert k6.segments(n, K) == (hop, nseg)
    got = _k6_schedule(xfull, taps)
    want = k6.fft_fir_valid_ref(torch.from_numpy(xfull), taps).numpy()
    assert _rel(got, want) < 2e-4


def test_fir_stream_blocks_match_jax():
    rng = np.random.default_rng(2)
    h = rng.normal(size=301)
    x = _signal(rng, 8192, True)
    jh, th = jnp.zeros(300, jnp.complex64), torch.zeros(300, dtype=torch.complex64)
    for blk in np.split(x, 4):
        jh, jy = jfir.fir_stream(h, jh, jnp.asarray(blk))
        th, ty = tfir.fir_stream(h, th, torch.from_numpy(blk))
        assert _rel(ty, jy) < 1e-3
    assert _rel(th, jh) == 0.0


@pytest.mark.parametrize("M,K,strategy", [(4, 41, "poly"), (4, 41, "fft"), (8, 161, "poly"),
                                          (20, 401, "fft"), (5, 13, "poly")])
def test_fir_decim_stream_matches_jax(M, K, strategy):
    rng = np.random.default_rng(3)
    h = rng.normal(size=K)
    x = _signal(rng, 480 * M * 2, False)
    jh, th = jnp.zeros(K - 1, jnp.float32), torch.zeros(K - 1)
    for blk in np.split(x, 2):
        jh, jy = jfir.fir_decim_stream(h, M, jh, jnp.asarray(blk), strategy)
        th, ty = tfir.fir_decim_stream(h, M, th, torch.from_numpy(blk), strategy)
        assert ty.shape == (len(blk) // M,)
        assert _rel(ty, jy) < 2e-3


def test_fir_interp_stream_matches_jax():
    rng = np.random.default_rng(4)
    P, K = 3, 22
    h = rng.normal(size=K)
    x = _signal(rng, 1024, True)
    Lsub = -(-K // P)
    jh, th = jnp.zeros(Lsub - 1, jnp.complex64), torch.zeros(Lsub - 1, dtype=torch.complex64)
    for blk in np.split(x, 4):
        jh, jy = jfir.fir_interp_stream(h, P, jh, jnp.asarray(blk))
        th, ty = tfir.fir_interp_stream(h, P, th, torch.from_numpy(blk))
        assert ty.shape == (P * len(blk),)
        assert _rel(ty, jy) < 2e-3


@pytest.mark.parametrize("op", ["slices", "fft", "pallas_fft", "pallas_mxu", "decim_poly",
                                "decim_fft", "interp"])
def test_batched_rows_equal_row_by_row(op):
    """Inside PerChannel the FIR gets (nch, n) blocks and (nch, ·) hist:
    two streamed blocks of 3 rows equal each row streamed alone."""
    rng = np.random.default_rng(6)
    h = rng.normal(size=300 if op == "pallas_mxu" else 90)
    x = torch.from_numpy(_signal(rng, 3 * 2 * 1200, True).reshape(3, 2, 1200))

    def run(xs, lead):
        if op == "interp":
            hist, step = torch.zeros(*lead, 29, dtype=torch.complex64), \
                lambda hb, xb: tfir.fir_interp_stream(h, 3, hb, xb)
        elif op.startswith("decim"):
            hist, step = torch.zeros(*lead, len(h) - 1, dtype=torch.complex64), \
                lambda hb, xb: tfir.fir_decim_stream(h, 4, hb, xb, op.split("_")[1])
        else:
            hist, step = torch.zeros(*lead, len(h) - 1, dtype=torch.complex64), \
                lambda hb, xb: tfir.fir_stream(h, hb, xb, op)
        ys = []
        for xb in xs:
            hist, y = step(hist, xb)
            ys.append(y)
        return torch.cat(ys, dim=-1)

    batched = run([x[:, 0], x[:, 1]], (3,))
    for b in range(3):
        assert _rel(batched[b], run([x[b, 0], x[b, 1]], ())) < 1e-6


def test_auto_strategy_routing():
    """Short → slices; long real on the card → K5; long complex or on the
    CPU → fft; 64 < nz ≤ 256 stays fft (tests/test_fir.py:92-107)."""
    cpu = torch.zeros(1)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert tfir._auto_strategy(np.ones(32), cpu) == "slices"
    assert tfir._auto_strategy(np.ones(401), cpu) == "fft"
    assert tfir._auto_strategy(np.ones(401), card) == "pallas_mxu"
    assert tfir._auto_strategy(np.ones(401) + 1j, card) == "fft"
    assert tfir._auto_strategy(np.ones(128), card) == "fft"
    half = np.zeros(600)
    half[::4] = 1.0  # 150 non-zeros of 600: the count, not the length, decides
    assert tfir._auto_strategy(half, card) == "fft"


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_bf16_split_matches_the_jax_packages(scale):
    """The port's bit-operation bf16 rounding (nearest even) gives the same
    hi and lo planes as split_bf16_np (ml_dtypes), ties included."""
    rng = np.random.default_rng(int(scale * 10) + 1)
    a = (rng.normal(size=4096) * scale).astype(np.float32)
    # exact ties: the bits below bf16's last place are 0x8000
    ties = (a[:64].view(np.uint32) & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    a = np.concatenate([a, ties.view(np.float32), np.float32([0.0, -0.0])])
    hi, lo = bf16x3.split_bf16(a)
    jhi, jlo = split_bf16_np(a)
    np.testing.assert_array_equal(hi, jhi.view(np.uint16))
    np.testing.assert_array_equal(lo, jlo.view(np.uint16))
    back = bf16x3.bf16_value(hi).astype(np.float64) + bf16x3.bf16_value(lo)
    assert np.max(np.abs(back - a) / (np.abs(a) + 1e-30)) < 2.0 ** -16


def _words(words):
    """uint32 words → (low, high) float64 bf16 values."""
    w = np.asarray(words, np.uint32)
    return (bf16x3.bf16_value(w & 0xFFFF).astype(np.float64),
            bf16x3.bf16_value(w >> 16).astype(np.float64))


def _sw128(R, c):
    """Element (row R, column c) of a 64-column bf16 window in the 128-byte
    swizzle: its 16-byte chunk c // 8 sits at chunk (c // 8) ^ (R % 8)."""
    return R * 64 + (((c // 8) ^ R) % 8) * 8 + c % 8


GID, TIG = np.arange(32) >> 2, np.arange(32) & 3


def _k5_schedule(xfull, taps, products=("lo·hi", "hi·lo", "hi·hi")):
    """csrc/fir_valid.cu transcribed in numpy, float64 sums of the bf16
    operands: work items of RUN outputs (64 frames of FRAME = 64), tap
    chunks of CHUNK_STEPS k-steps; the window split into hi/lo and stored in
    the 128-byte swizzle; per k-step, each warp's A registers from the
    wrapper's pair tables and B read as wgmma reads it (k-block kk // 4
    from window row kk // 4, k-step kk % 4 at column 16·(kk % 4), frame f
    in row f + kk // 4); 3 products per plane (A·B, or fewer in
    ``products``); outputs from d[4i + e]."""
    K = len(taps)
    rows, lx = xfull.shape
    n = lx - (K - 1)
    KS = k5.k_steps(K)
    th, tl = k5.tap_tables(np.asarray(taps, np.float32))
    planes = [xfull.real, xfull.imag] if np.iscomplexobj(xfull) else [xfull]
    y = np.zeros((len(planes), rows, n))
    frames = k5.RUN // k5.FRAME
    f = np.arange(frames)
    for row in range(rows):
        for i0 in range(0, n, k5.RUN):
            acc = np.zeros((len(planes), k5.FRAME, frames))        # d[j, f]
            for kk0 in range(0, KS, k5.CHUNK_STEPS):
                ksc = min(k5.CHUNK_STEPS, KS - kk0)
                nrow = frames + -(-ksc // 4)
                base = i0 + 16 * kk0
                tap_h = th[16 * kk0:16 * (kk0 + ksc) + k5.TAP_PAD]
                tap_l = tl[16 * kk0:16 * (kk0 + ksc) + k5.TAP_PAD]
                smem = []
                for pl in planes:
                    raw = np.zeros(nrow * 64, np.float32)
                    seg = pl[row, base:base + nrow * 64]
                    raw[:len(seg)] = seg
                    e = np.arange(nrow * 64)
                    parts = []
                    for bits in bf16x3.split_bf16(raw):
                        part = np.zeros(nrow * 64, np.uint16)
                        part[_sw128(e // 64, e % 64)] = bits
                        parts.append(bf16x3.bf16_value(part).astype(np.float64))
                    smem.append(parts)
                for kk in range(ksc):
                    A = []
                    for tab in (tap_h, tap_l):
                        a = np.zeros((k5.FRAME, 16))
                        for w in range(4):
                            q = k5.TAP_PAD + 16 * kk + 2 * TIG - GID - 16 * w
                            for dr, dq, dc in ((0, 0, 0), (8, -8, 0), (0, 8, 8), (8, 0, 8)):
                                lo_v, hi_v = _words(tab[q + dq])
                                a[16 * w + GID + dr, 2 * TIG + dc] = lo_v
                                a[16 * w + GID + dr, 2 * TIG + dc + 1] = hi_v
                        A.append(a)
                    R = f[None, :] + kk // 4                          # (1, frames)
                    c = 16 * (kk % 4) + np.arange(16)[:, None]       # (16, 1)
                    for p, parts in enumerate(smem):
                        Bh, Bl = (part[_sw128(R, c)] for part in parts)
                        terms = {"lo·hi": (A[1], Bh), "hi·lo": (A[0], Bl), "hi·hi": (A[0], Bh)}
                        for name in products:
                            acc[p] += terms[name][0] @ terms[name][1]
            o = i0 + k5.FRAME * f[None, :] + np.arange(k5.FRAME)[:, None]
            keep = o < n
            for p in range(len(planes)):
                y[p, row, o[keep]] = acc[p][keep]
    return y[0] + 1j * y[1] if len(planes) == 2 else y[0]


@pytest.mark.parametrize("K,n,cplx", [(1, 5099, False), (257, 5099, True), (585, 4103, True),
                                      (585, 5099, False), (701, 4200, False),
                                      (3651, 4107, True)])
def test_k5_tensor_core_schedule(K, n, cplx):
    """The tap tables and window indexing of csrc/fir_valid.cu, transcribed
    in numpy, against a float64 direct FIR on 2 rows: n spans a ragged
    second run (not a multiple of RUN or of the 64-output frame), C = K + 63
    is padded to whole k-steps, and 3,651 taps cross tap-chunk edges.  The
    bf16x3 products stay below 1e-4 of the largest output."""
    rng = np.random.default_rng(K + n)
    h = rng.normal(size=K) / np.sqrt(K)
    xfull = np.stack([_signal(rng, n + K - 1, cplx) for _ in range(2)])
    got = _k5_schedule(xfull, h)
    x64 = xfull.astype(np.complex128 if cplx else np.float64)
    g = np.asarray(h, np.float32).astype(np.float64)[::-1]
    want = np.stack([np.correlate(r, g, "valid") if not cplx
                     else np.correlate(r.real, g, "valid") + 1j * np.correlate(r.imag, g, "valid")
                     for r in x64])
    assert got.shape == want.shape == (2, n)
    assert _rel(got, want) < 1e-4
    assert _rel(got, k5.fir_valid_ref(torch.from_numpy(xfull), h).numpy()) < 1e-4


def test_k5_tap_tables():
    """Word Q of each table packs g[Q − 64] (low) and g[Q − 63] (high),
    g the reversed taps, zero outside [0, K); hi + lo ≈ g."""
    h = np.random.default_rng(1).normal(size=37).astype(np.float32)
    th, tl = k5.tap_tables(h)
    assert th.shape == tl.shape == (16 * k5.k_steps(37) + k5.TAP_PAD,)
    g = np.zeros(len(th) + 1)
    g[k5.TAP_PAD:k5.TAP_PAD + 37] = h[::-1]
    for lohi in (0, 1):
        v = _words(th)[lohi] + _words(tl)[lohi]
        np.testing.assert_allclose(v, g[lohi:lohi + len(th)], rtol=2.0 ** -16, atol=0)


@pytest.mark.parametrize("products", [("hi·lo", "hi·hi"), ("lo·hi", "hi·hi"), ("hi·hi",)])
def test_k5_bound_catches_a_dropped_product(products):
    """The K5 bound of the card tests and chip_smoke.py (1e-4 relative to the
    largest output) fails the schedule with a bf16x3 product left out, or
    plain bf16, on the main path's shape: 585 taps over complex rows."""
    K, n = 585, 4103
    rng = np.random.default_rng(K + n)
    h = ct.cw_demodulator(500 / 40000, 700 / 40000).blocks[0].taps
    assert len(h) == K
    xfull = np.stack([_signal(rng, n + K - 1, True)])
    want = k5.fir_valid_ref(torch.from_numpy(xfull), h).numpy()
    assert _rel(_k5_schedule(xfull, h), want) < 1e-4
    assert _rel(_k5_schedule(xfull, h, products), want) > 1e-4
