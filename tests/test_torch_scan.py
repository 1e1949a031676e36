"""The port's two serial per-sample recurrences on the CPU against the JAX
package: the stereo decoder's pilot PLL (``pll_mode="scan"``, K7's plain
twin) and the closed-loop symbol sync ``SymSyncScan`` (``mode="scan"``,
K8's plain twin), over state-chained blocks, inside ``PerChannel``, with JAX
state handed over mid-stream and a checkpoint round trip; the refusals to
shard; the reference's behavioural cases; and numpy transcriptions of each
kernel's order of operations held against its twin.

Tolerances.  The PLL and the stereo output: 2e-3 relative to the largest
output, the reference's bound for a chain in another float order
(tests/test_sharding_generic.py:60); the PLL's float32 loop reads ~1e-7
here.  ``SymSyncScan``: 2e-3 of the largest output
(tests/test_sharding_generic.py:346) up to the first output whose window
start or bank row lies within SYNC_TIE bank steps of a rounding boundary
in the reference run (``torch_oracles.scan_ties``: a tiny change of τ moves
the pick there, and a moved pick feeds back through the loop); after it
both runs must decode the same symbols (the signs of the centre samples),
and the carried τ's parting is only reported.  The reference's ties are
read from the port twin's trace on the same input, which follows the JAX
run bit for bit or nearly until the first tie.  So that every output is
held, not only those before the first tie, the loop is also opened: the
twin runs each centre tick's two outputs from the carry JAX held there
(recomputed from JAX's outputs, equal to JAX's carry at each block's end),
within 2e-3 except at JAX's own ties, with τ and η after them equal to
JAX's but for what the outputs' last bits move.  Behaviour: separation >
15 dB, bits > 0.99 (real) and > 0.97 (complex), the slip floor
(tests/test_symsync_stereo.py:198-287, tests/test_symsync_slip.py:116-130).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.core.block import PerChannel as JPerChannel
from csdr_tpu.models import stereo as j_stereo
from csdr_tpu.models import symsync as j_sync
from csdr_tpu.utils import firdes as j_firdes

import csdr_tpu_torch as ct
from csdr_tpu_torch.core import checkpoint
from csdr_tpu_torch.core.block import PerChannel
from csdr_tpu_torch.models import stereo, symsync
from csdr_tpu_torch.ops.cuda import pll_scan as k7
from csdr_tpu_torch.ops.cuda import symsync_scan as k8
from csdr_tpu_torch.ops.cuda._build import source_ints
from csdr_tpu_torch.parallel.generic import ShardedChain
from csdr_tpu_torch.utils.convert import from_jax_chain_state
from torch_oracles import (SYNC_TIE, SYNC_TOL, heli_coord, heli_decode, heli_levels,
                           heli_text, scan_agree, scan_ok, scan_ties)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-3
QUAD = 192000.0


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got.astype(np.complex128) - want)) / (np.max(np.abs(want)) + 1e-12))


# ---- the pilot PLL (K7) -------------------------------------------------------

def _pilot(n, seed, snr=0.1):
    """An analytic 19 kHz pilot at QUAD with a phase offset, a small
    frequency error and noise, complex64."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    w = 2 * np.pi * 19003.0 / QUAD
    noise = rng.normal(size=n) + 1j * rng.normal(size=n)
    p = 0.1 * np.exp(1j * (w * t + 1.1)) + snr * 0.1 * noise
    return p.astype(np.complex64)


@pytest.mark.parametrize("theta0,freq0", [(5.9, 1e-4), (-0.4, 0.0), (6.2831, -2e-4)])
def test_pll_twin_matches_jax_scan_over_chained_blocks(theta0, freq0):
    """fms_pll_scan's twin against the JAX lax.scan over 2 chained blocks:
    sub38 and the carry (θ, freq), from a carried θ inside [0, 2π), a
    negative one (the floored mod's case) and one at the wrap."""
    n = 4096
    p = _pilot(2 * n, 1)
    omega, bw = 2 * np.pi * 19000.0 / QUAD, 9.0 / QUAD
    js = (jnp.float32(theta0), jnp.float32(freq0))
    ts = (torch.tensor(theta0), torch.tensor(freq0))
    for b in range(2):
        js, jy = j_stereo.fms_pll_scan(jnp.asarray(p[b * n:(b + 1) * n]), js, omega, bw)
        ts, ty = stereo.fms_pll_scan(torch.from_numpy(p[b * n:(b + 1) * n]), ts, omega, bw)
        assert ty.dtype == torch.complex64 and ty.shape == (n,)
        assert _rel(ty.numpy(), np.asarray(jy)) < TOL
        assert abs(float(ts[0]) - float(js[0])) < 1e-4
        assert abs(float(ts[1]) - float(js[1])) < 1e-6


def _mpx(n, seed=0):
    """tests/test_symsync_stereo.py:198-211's composite: L 800 Hz, R 2.5 kHz,
    the pilot at phase 0.7, the subcarrier phase-locked."""
    t = np.arange(n) / QUAD
    L = 0.8 * np.sin(2 * np.pi * 800.0 * t)
    R = 0.8 * np.sin(2 * np.pi * 2500.0 * t)
    pilot = 0.1 * np.cos(2 * np.pi * 19000.0 * t + 0.7)
    sub = np.cos(2 * np.pi * 38000.0 * t + 1.4)
    x = 0.45 * (L + R) + pilot + 0.45 * (L - R) * sub
    return (x + 1e-3 * np.random.default_rng(seed).normal(size=n)).astype(np.float32)


def test_stereo_scan_pll_matches_jax_over_two_blocks():
    """stereo_fm_decoder(…, pll_mode="scan") against JAX over 2 blocks, the
    decoder's pll carry included."""
    n = 1 << 13
    x = _mpx(2 * n, 3)
    jd, td = (j_stereo.stereo_fm_decoder(QUAD, 4, pll_mode="scan"),
              stereo.stereo_fm_decoder(QUAD, 4, pll_mode="scan"))
    js, ts = jd.init(), td.init(CPU)
    for b in range(2):
        js, jy = jd.apply(js, jnp.asarray(x[b * n:(b + 1) * n]))
        ts, ty = td.apply(ts, torch.from_numpy(x[b * n:(b + 1) * n]))
        assert ty.shape == (2, n // 4)
        assert _rel(ty.numpy(), np.asarray(jy)) < TOL
    for got, want in zip(ts["pll"], js["pll"]):
        assert abs(float(got) - float(want)) < 1e-4


def test_stereo_scan_pll_separation():
    """tests/test_symsync_stereo.py:198-222: after the 9 Hz loop pulls in,
    L/R separation > 15 dB."""
    quad, n = QUAD, 1 << 17
    x = _mpx(n)
    dec = stereo.stereo_fm_decoder(quad, 4, pll_mode="scan")
    _, out = dec.apply(dec.init(CPU), torch.from_numpy(x))
    y = out[0].numpy()[out.shape[-1] // 2:].astype(np.float64)
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y)))) ** 2
    freqs = np.fft.rfftfreq(len(y), 4 / quad)
    pw = lambda f0: spec[(freqs > f0 - 100) & (freqs < f0 + 100)].max()  # noqa: E731
    sep = 10 * np.log10(pw(800.0) / pw(2500.0))
    assert sep > 15.0, sep


def _floor_mod_np(x, y):
    r = np.fmod(x, y)
    return np.where((r != 0) & ((r < 0) != (y < 0)), (r + y).astype(np.float32), r)


def test_floored_fmod_is_jnp_mod():
    """The kernels' mod (fmodf, then + y where the signs differ) equals
    jnp.mod and torch.remainder bit for bit, negative θ included (a plain
    fmodf is wrong there)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-30, 30, 4000), [-0.0, 0.0, -1e-9, 2 * np.pi,
                                                      -2 * np.pi, 1e-9]]).astype(np.float32)
    y = np.float32(2 * np.pi)
    got = _floor_mod_np(x, y)
    assert np.array_equal(got, np.asarray(jnp.mod(jnp.asarray(x), y)))
    assert np.array_equal(got, torch.remainder(torch.from_numpy(x), float(y)).numpy())
    assert not np.array_equal(np.fmod(x, y), got)


_PI32, _TWO_PI32 = np.float32(np.pi), np.float32(2 * np.pi)
_THREE_PI32, _FOUR_PI32 = np.float32(3 * np.pi), np.float32(4 * np.pi)


def _rotated_angle_np(v, theta):
    """angle(p·e^{−jθ}) as the JAX scan (and K7's rare branch) computes it:
    the product (pr + j·pi)(cos θ − j sin θ) rounded term by term, then
    atan2 of its signed parts."""
    f32 = np.float32
    s, c = np.sin(theta), np.cos(theta)
    re = f32(f32(v.real * c) + f32(v.imag * s))
    im = f32(f32(v.imag * c) - f32(v.real * s))
    return np.arctan2(im, re)


def _pll_transcribed(p, theta, freq, omega, alpha, beta):
    """K7's order in numpy float32: the φ pass (p = 0 flagged as NaN);
    chunks of kChunk; in each, groups of kGroup steps with the cheap wraps
    as selects and a flag where d leaves (−3π, π] or x leaves (−2π, 4π),
    a flagged group and the chunk's tail run again by the careful loop (the
    rotated product for e, the floored mod for θ); then every e^{2jθ}.
    Returns ((θ, freq), sub38, e and θ_out per step)."""
    chunk, group = source_ints("pll_scan.cu", "kChunk", "kGroup")
    f32 = np.float32
    theta, freq = f32(theta), f32(freq)
    omega, alpha, beta = f32(omega), f32(alpha), f32(beta)
    with np.errstate(invalid="ignore"):
        phi = np.where((p.real == 0) & (p.imag == 0), np.float32(np.nan),
                       np.arctan2(p.imag, p.real)).astype(np.float32)
    th = np.empty(len(p), np.float32)
    es = np.empty(len(p), np.float32)

    def careful(i0, i1, theta, freq):
        for i in range(i0, i1):
            d = f32(phi[i] - theta)
            if d > -_THREE_PI32 and d <= _PI32:
                e = f32(d + _TWO_PI32) if d <= -_PI32 else d
            else:
                e = _rotated_angle_np(p[i], theta)
            th[i], es[i] = theta, e
            freq = f32(freq + f32(beta * e))
            x = f32(f32(f32(theta + omega) + freq) + f32(alpha * e))
            if x > -_TWO_PI32 and x < _FOUR_PI32:
                theta = f32(x + _TWO_PI32) if x < 0 else (f32(x - _TWO_PI32) if x >= _TWO_PI32
                                                          else x)
            else:
                theta = _floor_mod_np(x, _TWO_PI32)[()]
        return theta, freq

    for c0 in range(0, len(p), chunk):
        c1 = min(c0 + chunk, len(p))
        g = c0
        while g + group <= c1:
            theta0, freq0, rare = theta, freq, False
            with np.errstate(invalid="ignore"):
                for i in range(g, g + group):
                    d = f32(phi[i] - theta)
                    rare |= not (d > -_THREE_PI32 and d <= _PI32)
                    e = f32(d + _TWO_PI32) if d <= -_PI32 else d
                    th[i], es[i] = theta, e
                    freq = f32(freq + f32(beta * e))
                    x = f32(f32(f32(theta + omega) + freq) + f32(alpha * e))
                    rare |= not (x > -_TWO_PI32 and x < _FOUR_PI32)
                    theta = f32(x + _TWO_PI32) if x < 0 else (
                        f32(x - _TWO_PI32) if x >= _TWO_PI32 else x)
            if rare:
                theta, freq = careful(g, g + group, theta0, freq0)
            g += group
        theta, freq = careful(g, c1, theta, freq)
    two = f32(2) * th
    return (theta, freq), (np.cos(two) + 1j * np.sin(two)).astype(np.complex64), es, th


def _pll_constants():
    return 2 * np.pi * 19000.0 / QUAD, 4 * 9.0 / QUAD, 4 * (9.0 / QUAD) ** 2


@pytest.mark.parametrize("case", ["noisy", "zeros", "carry_high", "carry_low"])
def test_pll_kernel_order_matches_twin(case):
    """K7's order of operations, transcribed in numpy (the φ pass, chunks
    and branch-free groups, the cheap wraps, the careful rerun of a flagged
    group with the rotated product and the floored mod), against the twin
    across chunk and group boundaries: from a negative θ, with a run of
    exact zeros, and from carries of θ ±20 and freq 0.5."""
    n = 2500
    p = _pilot(n, 4)
    theta0, freq0 = {"noisy": (-0.3, 2e-5), "zeros": (1.0, 0.0), "carry_high": (20.0, 0.5),
                     "carry_low": (-20.0, 0.5)}[case]
    if case == "zeros":
        p[1030:1100] = 0
    omega, alpha, beta = _pll_constants()
    (th, fr), sub, _, _ = _pll_transcribed(p, theta0, freq0, omega, alpha, beta)
    (tt, tf), tsub = k7.pll_scan(torch.from_numpy(p), (torch.tensor(theta0),
                                                       torch.tensor(freq0)), omega, alpha, beta)
    assert np.abs(tsub.numpy() - sub).max() < 1e-5
    assert abs(float(tt) - th) < 1e-5 and abs(float(tf) - fr) < 1e-8


@pytest.mark.parametrize("case", ["mod", "wrap", "carry_high", "carry_low"])
def test_pll_cheap_wraps_are_exact_and_rare_branches_take_over(case):
    """The loop's cheap forms against JAX.  mod: x + 2π (x < 0), x − 2π
    (x ≥ 2π) or x equals jnp.mod(x, 2π) bit for bit on (−2π, 4π), its ends
    and ±0 included, and the range test sends the rest to the floored mod.
    wrap: for d = φ − θ in (−3π, π], d + 2π (d ≤ −π) or d is the exact
    wrap of d into (−π, π] (Sterbenz: the add rounds nothing), and within
    1e-6 of jnp.angle of the rotated product, as JAX computes e, away from
    ±π (where the two may fall on either side).  carry: from θ = ±20 and
    freq = 0.5 the first steps take the rare branches (the rotated product,
    the floored mod), and the twin stays within 2e-3 of the JAX scan over
    two chained blocks, θ within 1e-4."""
    rng = np.random.default_rng(11)
    if case == "mod":
        ulp = np.spacing(_TWO_PI32)
        x = np.concatenate([rng.uniform(-2 * np.pi, 4 * np.pi, 20000),
                            [-_TWO_PI32 + ulp, -np.float32(1e-30), -0.0, 0.0, 1e-30,
                             _TWO_PI32 - ulp, _TWO_PI32, _TWO_PI32 + ulp,
                             _FOUR_PI32 - np.spacing(_FOUR_PI32)]]).astype(np.float32)
        x = x[(x > -_TWO_PI32) & (x < _FOUR_PI32)]
        cheap = torch.where(torch.from_numpy(x) < 0, torch.from_numpy(x) + _TWO_PI32,
                            torch.where(torch.from_numpy(x) >= _TWO_PI32,
                                        torch.from_numpy(x) - _TWO_PI32, torch.from_numpy(x)))
        want = np.asarray(jnp.mod(jnp.asarray(x), _TWO_PI32))
        assert np.array_equal(cheap.numpy().view(np.int32), want.view(np.int32))
        outside = np.array([-_TWO_PI32, -7.0, _FOUR_PI32, 20.0, -20.0], np.float32)
        assert not np.any((outside > -_TWO_PI32) & (outside < _FOUR_PI32))
        assert np.array_equal(_floor_mod_np(outside, _TWO_PI32),
                              np.asarray(jnp.mod(jnp.asarray(outside), _TWO_PI32)))
        return
    omega, alpha, beta = _pll_constants()
    if case == "wrap":
        n = 20000
        p = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        theta = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        d = (np.arctan2(p.imag, p.real).astype(np.float32) - theta).astype(np.float32)
        assert np.all((d > -_THREE_PI32) & (d <= _PI32))
        e = np.where(d <= -_PI32, (d + _TWO_PI32).astype(np.float32), d)
        exact = np.float64(d) + 2 * np.float64(_PI32) * (np.float64(d) <= -np.float64(_PI32))
        assert np.array_equal(e.astype(np.float64), exact)
        assert np.all((e > -_PI32 - 1e-6) & (e <= _PI32))
        angle = np.asarray(jnp.angle(jnp.asarray(p) * jnp.exp(-1j * jnp.asarray(theta))
                                     .astype(jnp.complex64)))
        away = np.abs(angle) < np.pi - 1e-5
        assert away.mean() > 0.99
        assert np.abs(e - angle)[away].max() < 1e-6
        return
    theta0 = 20.0 if case == "carry_high" else -20.0
    n = 4096
    p = _pilot(2 * n, 6)
    _, _, es, _ = _pll_transcribed(p[:8], theta0, 0.5, omega, alpha, beta)
    assert es[0] == _rotated_angle_np(p[0], np.float32(theta0))
    js = (jnp.float32(theta0), jnp.float32(0.5))
    ts = (torch.tensor(theta0), torch.tensor(0.5))
    bw = 9.0 / QUAD
    for b in range(2):
        js, jy = j_stereo.fms_pll_scan(jnp.asarray(p[b * n:(b + 1) * n]), js, omega, bw)
        ts, ty = stereo.fms_pll_scan(torch.from_numpy(p[b * n:(b + 1) * n]), ts, omega, bw)
        assert _rel(ty.numpy(), np.asarray(jy)) < TOL
        assert abs(float(ts[0]) - float(js[0])) < 1e-4


def test_pll_zero_run_takes_the_rotated_product():
    """A pilot row with runs of exact zeros (the zero-padded last block once
    the pilot FIR's history drains): at p = 0 the loop's e is the rotated
    product's, atan2 of its signed zeros (0 or ±π by the signs of cos θ and
    sin θ), as JAX computes it, not wrap(atan2(0, 0) − θ) = −θ; the twin
    stays within 2e-3 of the JAX scan over two chained blocks, θ within
    1e-4."""
    omega, alpha, beta = _pll_constants()
    n = 4096
    p = _pilot(2 * n, 9)
    for a, b in ((700, 760), (4000, 4500), (8000, 8192)):
        p[a:b] = 0
    _, _, es, th = _pll_transcribed(p, 0.0, 0.0, omega, alpha, beta)
    zero = np.flatnonzero((p.real == 0) & (p.imag == 0))
    want = np.array([_rotated_angle_np(np.complex64(0), t) for t in th[zero]], np.float32)
    assert np.array_equal(es[zero], want)
    assert np.all(np.isin(np.abs(want), [0.0, _PI32]))
    # wrap(atan2(0, 0) − θ) would be −θ (wrapped), another e on almost every one
    naive = np.where(-th[zero] <= -_PI32, -th[zero] + _TWO_PI32, -th[zero])
    assert np.mean(naive != want) > 0.9
    js = (jnp.float32(0.0), jnp.float32(0.0))
    ts = (torch.tensor(0.0), torch.tensor(0.0))
    bw = 9.0 / QUAD
    for b in range(2):
        js, jy = j_stereo.fms_pll_scan(jnp.asarray(p[b * n:(b + 1) * n]), js, omega, bw)
        ts, ty = stereo.fms_pll_scan(torch.from_numpy(p[b * n:(b + 1) * n]), ts, omega, bw)
        assert _rel(ty.numpy(), np.asarray(jy)) < TOL
        assert abs(float(ts[0]) - float(js[0])) < 1e-4


def test_pll_rows_and_refusals():
    """The twin runs rows (…, n) each on its own carry; the wrapper checks
    its operands."""
    p = np.stack([_pilot(600, s) for s in range(3)]).reshape(3, 1, 600)
    th, fr = torch.tensor([[0.1], [2.0], [4.0]]), torch.zeros(3, 1)
    (tt, tf), sub = k7.pll_scan(torch.from_numpy(p), (th, fr), 0.6, 1e-3, 1e-6)
    for r in range(3):
        (t1, f1), s1 = k7.pll_scan(torch.from_numpy(p[r, 0]), (th[r, 0], fr[r, 0]), 0.6, 1e-3,
                                   1e-6)
        assert torch.equal(s1, sub[r, 0]) and torch.equal(t1, tt[r, 0]) and torch.equal(f1,
                                                                                         tf[r, 0])
    with pytest.raises(ValueError, match="complex64"):
        k7.pll_scan(torch.zeros(8), (torch.tensor(0.0), torch.tensor(0.0)), 0.6, 1e-3, 1e-6)
    with pytest.raises(ValueError, match="theta"):
        k7.pll_scan(torch.zeros(2, 8, dtype=torch.complex64), (torch.zeros(3), torch.zeros(2)),
                    0.6, 1e-3, 1e-6)


# ---- the closed-loop symbol sync (K8) -----------------------------------------

def _fractional_delay(x, d, ntaps=61):
    t = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(t - (d - int(d))) * np.hamming(ntaps)
    return np.convolve(x, h)[int(d) + (ntaps - 1) // 2:][:len(x)]


def _real_nrz(seed=0, k=10, nsym=2000, delay=3.7):
    """tests/test_symsync_stereo.py:33-38's smoothed NRZ."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym) * 2 - 1
    x = np.repeat(bits.astype(np.float64), k)
    x = np.convolve(x, np.hanning(7) / np.hanning(7).sum(), mode="same")
    return bits, _fractional_delay(x, delay).astype(np.float32)


def _complex_bpsk(seed=1, k=4, m=3, nsym=4000):
    """tests/test_symsync_stereo.py:55-61's RRC BPSK."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym) * 2 - 1
    h = j_firdes.rrc(k, m, 0.5)
    up = np.zeros(nsym * k)
    up[::k] = bits
    x = np.convolve(up, h)[: nsym * k] * np.sqrt(k)
    return bits, _fractional_delay(x, 1.3).astype(np.complex64)


def _pair(kind):
    if kind == "real":
        return j_sync.sym_sync_r(10, 4, 0.0, 64, mode="scan"), \
            symsync.sym_sync_r(10, 4, 0.0, 64, mode="scan")
    return j_sync.sym_sync_c(3, 4, mode="scan"), symsync.sym_sync_c(3, 4, mode="scan")


def _chain(jb, pb, x, nblocks, jstate=None, pstate=None):
    """Both blocks over nblocks state-chained blocks of x (…, n); the port's
    steps run with ``torch_oracles.scan_ties`` recorded from its twin.
    Returns (JAX outputs, port outputs, ties, JAX states, port states)."""
    n = x.shape[-1] // nblocks // pb.granule * pb.granule
    js = jb.init() if jstate is None else jstate
    ps = pb.init(CPU) if pstate is None else pstate
    jo, po, ties, jss, pss = [], [], [], [], []
    with record_scan() as rec:
        for b in range(nblocks):
            xb = x[..., b * n:(b + 1) * n]
            js, jy = jb.apply(js, jnp.asarray(xb))
            ps, py = pb.apply(ps, torch.from_numpy(np.ascontiguousarray(xb)))
            jo.append(np.asarray(jy)), po.append(py.numpy()), jss.append(js), pss.append(ps)
    ties = np.concatenate(rec, axis=-1)
    return np.concatenate(jo, -1), np.concatenate(po, -1), ties, jss, pss


class record_scan:
    """Around port steps on the CPU: every ``symsync_scan`` call runs the
    twin with its trace and appends ``scan_ties`` of its outputs."""

    def __enter__(self):
        self.log, self.orig = [], k8.symsync_scan

        def recording(xfull, bank, carry, loop):
            carry, y, taus = k8.symsync_scan_ref(xfull, bank, carry, loop, trace=True)
            self.log.append(scan_ties(taus, loop, bank.shape[0], SYNC_TIE))
            return carry, y

        k8.symsync_scan = recording
        return self.log

    def __exit__(self, *exc):
        k8.symsync_scan = self.orig


@pytest.mark.parametrize("kind", ["real", "complex", "real_drift"])
def test_symsync_scan_matches_jax_over_three_blocks(kind):
    """SymSyncScan against the JAX lax.scan over 3 chained blocks of the
    reference's own test inputs (and the slip test's NRZ at +200 ppm):
    the sync rule above, and the carry."""
    x = {"real": lambda: _real_nrz()[1], "complex": lambda: _complex_bpsk()[1],
         "real_drift": lambda: _drift_nrz(2e-4, 3000, 11)[1]}[kind]()
    jb, pb = _pair("complex" if kind == "complex" else "real")
    jy, py, ties, jss, pss = _chain(jb, pb, x, 3)
    assert py.dtype == jy.dtype and py.shape == jy.shape
    agree = scan_agree(py, jy, ties, block=py.shape[-1] // 3)
    assert scan_ok(agree), agree
    for a, b in zip(pss[-1], jss[-1]):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype and a.shape == np.shape(b)
        assert bool(torch.isfinite(a).all())
    # the carry parts only after a moved pick: reported, not bound
    print(kind, agree, "tau", float(pss[-1][1]), float(jss[-1][1]))


def _jax_carries(jy, state, blk):
    """The carry (τ, η, prev, edge) the JAX loop held before each output of
    a block and after its last, (R, nout + 1) each, recomputed from its
    outputs jy (R, nout) and its carry at the block's start by the
    reference's update (csdr_tpu/models/symsync.py:341-360) in float32."""
    f32 = np.float32
    tau, eta, prev, edge = (np.array(v).reshape(jy.shape[0]) for v in state[1:])
    kp, ki = f32(blk.kp), f32(blk.ki)
    out = [np.empty((jy.shape[0], jy.shape[1] + 1), v.dtype) for v in (tau, eta, prev, edge)]
    for j in range(jy.shape[1] + 1):
        for o, v in zip(out, (tau, eta, prev, edge)):
            o[:, j] = v
        if j == jy.shape[1]:
            break
        y = jy[:, j]
        if j % 2 == 0:
            d = y - prev
            e = (edge.real * d.real + edge.imag * d.imag) if np.iscomplexobj(y) else edge * d
            e = -np.clip(e, f32(-1), f32(1))
            eta = eta + ki * e
            tau = (tau + kp * e) + eta
            prev = y
        else:
            edge = y
    return out


@pytest.mark.parametrize("kind", ["real", "complex", "real_drift", "per_channel"])
def test_symsync_scan_open_loop_matches_jax(kind):
    """The port's loop held against JAX's over every output of 3 chained
    blocks, with the loop opened: at each centre tick the twin starts from
    the carry JAX held there (recomputed from JAX's outputs by
    ``_jax_carries``, and equal to JAX's own carry at each block's end) and
    runs two outputs.  Those outputs are within 2e-3 of the largest of
    JAX's except at a tie of JAX's τ (``torch_oracles.scan_ties``), and the
    twin's τ and η after them equal JAX's within 1e-5 wherever the centre
    is no tie: wrong PI gains, a wrong TED or a wrong pick fail here
    though the closed loop might still lock.  No tie feeds back, so the
    whole run is compared."""
    if kind == "per_channel":
        x = np.stack([_real_nrz(seed=s, nsym=900, delay=d)[1]
                      for s, d in ((0, 3.7), (5, 1.2), (9, 6.4))])
    else:
        x = {"real": lambda: _real_nrz()[1], "complex": lambda: _complex_bpsk()[1],
             "real_drift": lambda: _drift_nrz(2e-4, 3000, 11)[1]}[kind]()[None]
    jb, pb = _pair("complex" if kind == "complex" else "real")
    R, jinner, inner = x.shape[0], jb, pb
    if R > 1:
        jb = JPerChannel(jb, R)
    n = x.shape[-1] // 3 // inner.granule * inner.granule
    bank = symsync._bank_on(inner.k, inner.m, inner.npfb, inner.ftype, inner.beta, CPU)
    half = np.float32(inner.k / 2.0)
    js = jb.init()
    kp, ki = float(inner.kp), float(inner.ki)
    compared = outputs = 0
    worst = 0.0
    for b in range(3):
        xb = np.ascontiguousarray(x[..., b * n:(b + 1) * n])
        js1, jy = jb.apply(js, jnp.asarray(xb if R > 1 else xb[0]))
        jy = np.asarray(jy).reshape(R, -1)
        taus, etas, prevs, edges = _jax_carries(jy, js, jinner)
        # the recomputed carry is JAX's own at the block's end
        tau_end = torch.remainder(torch.from_numpy(taus[:, -1]) + half, np.float32(inner.k)) - half
        assert np.allclose(tau_end.numpy(), np.array(js1[1]).reshape(R), rtol=0, atol=1e-5)
        assert np.allclose(etas[:, -1], np.array(js1[2]).reshape(R), rtol=0, atol=1e-7)
        xfull = torch.cat([torch.from_numpy(np.array(js[0]).reshape(R, -1)), torch.from_numpy(xb)],
                          dim=-1)
        loop = inner.loop(n)
        ties = scan_ties(torch.from_numpy(taus[:, :-1]), loop, inner.npfb)
        scale = np.abs(jy).max()
        for j in range(0, loop.nout, 2):
            lp = dataclasses.replace(loop, start=loop.start + j * loop.half, nout=2)
            carry = tuple(torch.from_numpy(np.ascontiguousarray(v[:, j]))
                          for v in (taus, etas, prevs, edges))
            (tau, eta, _, _), y = k8.symsync_scan_ref(xfull, bank, carry, lp)
            ok = ~ties[:, j:j + 2]
            err = np.abs(y.numpy().astype(np.complex128) - jy[:, j:j + 2]) / scale
            assert err[ok].max(initial=0.0) < TOL, (b, j, err)
            # the twin's centre output differs from JAX's by dy in the last
            # bits (another order of the window's sum); through the TED that
            # moves η by at most ki·|edge|·dy and τ by (kp + ki)·|edge|·dy
            centre = ok[:, 0]
            moved = np.abs(edges[:, j]) * np.abs(y.numpy()[:, 0] - jy[:, j])
            dtau = np.abs(tau.numpy() - taus[:, j + 2]) - (kp + ki) * moved
            deta = np.abs(eta.numpy() - etas[:, j + 2]) - ki * moved
            worst = max(worst, float(np.abs(tau.numpy() - taus[:, j + 2])[centre].max(initial=0)))
            assert dtau[centre].max(initial=0.0) < 4e-6, (b, j, dtau)
            assert deta[centre].max(initial=0.0) < 1e-7, (b, j, deta)
            compared += int(ok.sum())
        outputs += jy.size
        js = js1
    # the ties are few: nearly every output was compared
    assert compared > 0.9 * outputs, (compared, outputs)
    print(kind, "compared", compared, "of", outputs, "worst tau", worst)


def test_symsync_scan_per_channel_matches_jax():
    """PerChannel(SymSyncScan) over 3 channels, each its own stream and
    carry, against the JAX PerChannel (vmap) over 3 chained blocks."""
    x = np.stack([_real_nrz(seed=s, nsym=900, delay=d)[1] for s, d in ((0, 3.7), (5, 1.2),
                                                                         (9, 6.4))])
    jb = JPerChannel(j_sync.sym_sync_r(10, 4, 0.0, 64, mode="scan"), 3)
    pb = PerChannel(symsync.sym_sync_r(10, 4, 0.0, 64, mode="scan"), 3)
    jy, py, ties, _, pss = _chain(jb, pb, x, 3)
    assert py.shape == (3, 3 * (x.shape[-1] // 3 // 10) * 2)
    assert all(tuple(leaf.shape[:1]) == (3,) for leaf in pss[-1])
    agree = scan_agree(py, jy, ties, block=py.shape[-1] // 3)
    assert scan_ok(agree), agree
    # each row is the single-channel sync on that row
    _, single, _, _, _ = _chain(j_sync.sym_sync_r(10, 4, 0.0, 64, mode="scan"),
                                symsync.sym_sync_r(10, 4, 0.0, 64, mode="scan"), x[1], 3)
    assert np.array_equal(py[1], single)


def _accuracy(centres, bits, start):
    best = 0.0
    for lag in range(-16, 17):
        a = bits[start + max(0, lag):]
        b = np.sign(centres[start + max(0, -lag):])
        mm = min(len(a), len(b)) - 10
        if mm > 100:
            best = max(best, float(np.mean(a[:mm] == b[:mm])))
    return best


@pytest.mark.parametrize("kind,floor", [("real", 0.99), ("complex", 0.97)])
def test_symsync_scan_decodes_bits(kind, floor):
    """tests/test_symsync_stereo.py:248-287: after convergence (the second
    half) the centre samples decode the bits, > 0.99 real, > 0.97 complex."""
    bits, x = _real_nrz() if kind == "real" else _complex_bpsk()
    _, pb = _pair(kind)
    st, outs = pb.init(CPU), []
    n = len(x) // 2 // pb.granule * pb.granule
    for b in range(2):
        st, y = pb.apply(st, torch.from_numpy(x[b * n:(b + 1) * n]))
        outs.append(y.numpy())
    centres = np.real(np.concatenate(outs)[0::2])
    assert _accuracy(centres, bits, len(centres) // 2) > floor


def _drift_nrz(eps, nsym, seed, K=10):
    """tests/test_symsync_slip.py:40-48: bipolar NRZ at K·(1 + eps)
    samples/symbol read off an 8× dense grid, Hann-smoothed."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym) * 2 - 1
    dense = np.repeat(bits.astype(np.float64), 8 * K)
    t_rx = np.arange(int(nsym * K / (1 + eps) - 16)) * (1 + eps)
    x = np.interp(t_rx * 8, np.arange(len(dense)), dense)
    return bits, np.convolve(x, np.hanning(7) / np.hanning(7).sum(), mode="same").astype(
        np.float32)


def test_symsync_scan_slip_floor():
    """tests/test_symsync_slip.py:116-130: under a 500 ppm clock offset the
    scan loop decodes cleanly through its slips, its lag moves monotonically
    by at most one symbol per block and no faster than the drift."""
    eps, K = 5e-4, 10
    bits, x = _drift_nrz(eps, 16000, 7)
    blk = symsync.sym_sync_r(K, 4, 0.0, 64, mode="scan")
    st = blk.init(CPU)
    blocks = 8
    n = (len(x) // (blocks * blk.granule)) * blk.granule
    spb = n // K
    lags, accs = [], []
    for i in range(blocks):
        st, y = blk.apply(st, torch.from_numpy(x[i * n:(i + 1) * n]))
        seg = np.sign(y.numpy()[0::2])
        ref = bits[i * spb:(i + 1) * spb]
        best, bl = 0.0, 0
        for lag in range(-24, 25):
            a, b = ref[max(0, lag):], seg[max(0, -lag):]
            mm = min(len(a), len(b)) - 4
            if mm > 200:
                s = float(np.mean(a[:mm] == b[:mm]))
                if s > best:
                    best, bl = s, lag
        lags.append(bl)
        accs.append(best)
    assert min(accs) > 0.98, accs
    steps = np.diff(lags)
    assert np.all(steps >= 0) and np.max(np.abs(steps)) <= 1, lags
    assert lags[-1] - lags[0] <= np.ceil(eps * (len(lags) - 1) * n / K) + 1, lags


def test_jax_scan_state_hands_over_mid_stream():
    """The JAX SymSyncScan's and stereo scan PLL's states after block 1,
    through from_jax_chain_state, continue in the port: block 2 against
    JAX's block 2."""
    _, x = _complex_bpsk()
    jb, pb = _pair("complex")
    n = len(x) // 3 // 4 * 4
    js, _ = jb.apply(jb.init(), jnp.asarray(x[:n]))
    state = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
    assert [leaf.dtype for leaf in state] == [torch.complex64, torch.float32, torch.float32,
                                              torch.complex64, torch.complex64]
    jy, py, ties, _, _ = _chain(jb, pb, x[n:], 2, jstate=js, pstate=state)
    assert scan_ok(scan_agree(py, jy, ties, block=py.shape[-1] // 2))

    m = 1 << 12
    mpx = _mpx(2 * m, 8)
    jd, pd = (j_stereo.stereo_fm_decoder(QUAD, 4, pll_mode="scan"),
              stereo.stereo_fm_decoder(QUAD, 4, pll_mode="scan"))
    js, _ = jd.apply(jd.init(), jnp.asarray(mpx[:m]))
    _, jy = jd.apply(js, jnp.asarray(mpx[m:]))
    _, py = pd.apply(from_jax_chain_state(jax.tree.map(np.asarray, js), CPU),
                     torch.from_numpy(mpx[m:]))
    assert _rel(py.numpy(), np.asarray(jy)) < TOL


def test_scan_states_checkpoint_round_trip(tmp_path):
    """save_state / load_state carry the SymSyncScan tuple (inside
    PerChannel) and the stereo decoder's pll carry: a resumed run equals
    the uninterrupted one bit for bit."""
    x = np.stack([_real_nrz(seed=s, nsym=400)[1] for s in (1, 2)])
    pb = PerChannel(symsync.sym_sync_r(10, 4, 0.0, 64, mode="scan"), 2)
    n = 2000
    st, _ = pb.apply(pb.init(CPU), torch.from_numpy(x[:, :n]))
    path = str(tmp_path / "sync.npz")
    checkpoint.save_state(path, st, position=n, signature="scan")
    back, pos = checkpoint.load_state(path, pb.init(CPU), CPU, signature="scan")
    assert pos == n
    _, want = pb.apply(st, torch.from_numpy(x[:, n:2 * n]))
    _, got = pb.apply(back, torch.from_numpy(x[:, n:2 * n]))
    assert torch.equal(got, want)

    dec = stereo.stereo_fm_decoder(QUAD, 4, pll_mode="scan")
    mpx = _mpx(4096, 2)
    st, _ = dec.apply(dec.init(CPU), torch.from_numpy(mpx[:2048]))
    checkpoint.save_state(path, st)
    back, _ = checkpoint.load_state(path, dec.init(CPU), CPU)
    assert torch.equal(back["pll"][0], st["pll"][0]) and float(back["pll"][0]) != 0.0
    assert torch.equal(dec.apply(back, torch.from_numpy(mpx[2048:]))[1],
                       dec.apply(st, torch.from_numpy(mpx[2048:]))[1])


@pytest.mark.parametrize("case", ["stereo", "sync", "sync_per_channel"])
def test_scan_modes_refuse_to_shard_as_jax(case):
    """Neither scan shards in the JAX package: the stereo decoder's
    shard_validate and a block without a shard method refuse with the same
    NotImplementedError, statically, in both packages."""
    from jax.sharding import Mesh

    from csdr_tpu.parallel.generic import ShardedChain as JaxChain

    def graph(pkg, mods):
        st, sy = mods
        if case == "stereo":
            return pkg.chain(st.stereo_fm_decoder(QUAD, 4, pll_mode="scan"))
        inner = sy.sym_sync_r(10, 4, 0.0, 64, mode="scan")
        if case == "sync":
            return pkg.chain(inner)
        return pkg.chain(pkg.firpfbch_channelizer(4), pkg.PerChannel(inner, 4))

    block = 2 * 4 * 10 * 640
    with pytest.raises(NotImplementedError) as mine:
        ShardedChain.validate(graph(ct, (stereo, symsync)), 2, 1, block)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("time", "ch"))
    with pytest.raises(NotImplementedError) as theirs:
        JaxChain(graph(cs, (j_stereo, j_sync)), mesh, block)
    assert str(mine.value) == str(theirs.value)


def _scan_transcribed(xfull, bank, carry, loop):
    """K8's order in numpy float32 for one row: output 0 alone, then each
    edge output and the centre after it at one τ, a last edge alone; every
    lane's position (rint as the low bits of v + 1.5·2^23, the start from
    the floor of the position clamped to ±2^30); the window read from the
    ring of kRingChunks chunks (the first Wp = 32·⌈W/32⌉ samples mirrored
    past its end, chunks cb and cb + 1 landed) where it holds the window,
    else from the row; lane l's taps l, l + 32, … summed in order, the
    __shfl_xor_sync tree (16, 8, 4, 2, 1); the loop update; the ring kept a
    chunk behind the centre window, re-seated where the window is far from
    it.  Returns ((τ, η, prev, edge), y, counts of windows read from the row
    and of re-seats)."""
    chunk, nchunks = source_ints("symsync_scan.cu", "kChunk", "kRingChunks")
    f32 = np.float32
    npfb, W = bank.shape
    L = len(xfull)
    ring_n, wp = chunk * nchunks, 32 * -(-W // 32)
    tau, eta, prev, edge = carry
    tau, eta = f32(tau), f32(eta)
    kp, ki = f32(loop.kp), f32(loop.ki)
    cplx = np.iscomplexobj(xfull)
    lanes = np.arange(32)
    ring = np.full(ring_n + wp, np.nan, xfull.dtype)
    counts = {"slow": 0, "seats": 0}
    state = {"cb": 0}

    def issue(c):
        g = c * chunk + np.arange(chunk)
        slot = (c % nchunks) * chunk
        ring[slot:slot + chunk] = np.where(g < L, xfull[np.minimum(g, L - 1)], 0)
        if c % nchunks == 0:
            ring[ring_n:] = np.where(g[:wp] < L, xfull[np.minimum(g[:wp], L - 1)], 0)

    def seat(c):
        state["cb"] = c
        counts["seats"] += 1
        for q in range(nchunks):
            issue(c + q)

    def pick(j):
        pos = f32(f32(f32(loop.start) + f32(f32(j) * f32(loop.half))) + tau)
        v = f32(f32(pos - np.floor(pos)) * f32(npfb))
        ph = int(np.clip(int(np.array(f32(v + f32(12582912.0))).view(np.int32)) - 0x4B400000,
                         0, npfb - 1))
        si = int(np.floor(np.clip(pos, f32(-2.0 ** 30), f32(2.0 ** 30)))) - loop.mk
        return int(np.clip(si + L if si < 0 else si, 0, L - W)), ph

    def covered(s):
        lo = state["cb"] * chunk
        return s >= lo and s + W <= lo + 2 * chunk

    def window(s, ph):
        fast = covered(s)
        counts["slow"] += not fast
        parts = []
        src = ring[(s % ring_n) + np.arange(wp)] if fast else xfull[np.minimum(s + np.arange(wp),
                                                                               L - 1)]
        for plane in ((src.real, src.imag) if cplx else (src,)):
            acc = np.zeros(32, np.float32)
            for t0 in range(0, W, 32):
                t = t0 + lanes
                on = t < W
                prod = (plane[t[on]].astype(np.float32) * bank[ph, t[on]]).astype(np.float32)
                acc[on] = (acc[on] + prod).astype(np.float32)
            for off in (16, 8, 4, 2, 1):
                acc = (acc + acc[lanes ^ off]).astype(np.float32)
            assert np.all(acc == acc[0])   # the tree leaves the same bits in every lane
            parts.append(acc[0])
        return np.complex64(parts[0] + 1j * parts[1]) if cplx else parts[0]

    def update(out):
        nonlocal tau, eta, prev
        if cplx:
            e = f32(f32(f32(edge.real) * f32(out.real - prev.real))
                    + f32(f32(edge.imag) * f32(out.imag - prev.imag)))
        else:
            e = f32(edge * f32(out - prev))
        e = -min(max(e, f32(-1)), f32(1))
        eta = f32(eta + f32(ki * e))
        tau = f32(f32(tau + f32(kp * e)) + eta)
        prev = out

    def follow(s):
        lo = state["cb"] * chunk
        if lo <= s < lo + chunk:
            return
        if lo <= s < lo + 2 * chunk:
            issue(state["cb"] + nchunks)
            state["cb"] += 1
        else:
            seat(s // chunk)

    y = np.empty(loop.nout, xfull.dtype)
    s, ph = pick(0)
    seat(s // chunk)
    y[0] = window(s, ph)
    update(y[0])
    j = 1
    while j + 1 < loop.nout:
        (se, phe), (sc, phc) = pick(j), pick(j + 1)
        y[j], y[j + 1] = window(se, phe), window(sc, phc)
        edge = y[j]
        update(y[j + 1])
        follow(sc)
        j += 2
    if j < loop.nout:
        s, ph = pick(j)
        y[j] = edge = window(s, ph)
    return (tau, eta, prev, edge), y, counts


@pytest.mark.parametrize("kind,tau0", [("real", 0.0), ("complex", 0.0), ("real", "wrap"),
                                       ("real", "wrap+1"), ("complex", "wrap"),
                                       ("complex", "wrap+1"), ("real", "jump")])
def test_scan_kernel_order_matches_twin(kind, tau0):
    """K8's order of operations, transcribed in numpy (the paired outputs,
    the window ring and its mirror, the lane split and shuffle tree, rint,
    the wrapped and clamped window), against the twin over one block: the
    twin sums in the kernel's order, so bit for bit.  From τ = 0, and from
    the τ of ``test_scan_window_clamps_and_rounds_as_jax`` that puts the
    first windows before xfull's start (their wrapped starts clamp to its
    end, far from the ring), and one output later (the edge and the centre
    of a pair then fall on either side): the ring is re-seated, and a
    window it does not hold is read from the row.  And a τ that runs back
    through a long row (a carried η of −30): the ring is re-seated behind
    it, chunk after chunk, and the pairs that straddle its edge read the
    row."""
    _, x = _real_nrz(nsym=1200 if tau0 == "jump" else 300) if kind == "real" else \
        _complex_bpsk(nsym=600)
    _, pb = _pair(kind)
    st = pb.init(CPU)
    xfull = torch.cat([st[0], torch.from_numpy(x)])
    bank = symsync._bank_on(pb.k, pb.m, pb.npfb, pb.ftype, pb.beta, CPU)
    loop = pb.loop(len(x))
    t0 = {0.0: 0.0, "wrap": -(pb.H + 3 * pb.k + 0.25),
          "wrap+1": -(pb.H + 3 * pb.k + 0.25) - loop.half, "jump": 3000.3}[tau0]
    # "jump": a carried η of −30 sends τ back ~30 samples a centre tick, so
    # the windows run back through the row, wrap past its start to its end
    # and run back again
    eta0 = np.float32(-30.0 if tau0 == "jump" else 0.0)
    carry0 = (torch.tensor(np.float32(t0)), torch.tensor(eta0), *st[3:])
    carry, want = k8.symsync_scan_ref(xfull, bank, carry0, loop)
    got_carry, got, counts = _scan_transcribed(xfull.numpy(), bank.numpy(),
                                               tuple(c.numpy()[()] for c in carry0), loop)
    assert np.array_equal(got, want.numpy())
    assert got_carry[0] == carry[0].numpy() and got_carry[1] == carry[1].numpy()
    if tau0 == 0.0:
        assert counts == {"slow": 0, "seats": 1}, counts
    elif tau0 in ("wrap", "wrap+1"):
        assert counts["seats"] >= 2, counts
    else:
        assert counts["seats"] >= 2 and counts["slow"] > 0, counts
    print(kind, tau0, counts)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_scan_window_clamps_and_rounds_as_jax(kind):
    """With the loop open (lf_bw = 0, τ constant) both packages and the
    transcription take the same windows and bank rows: a τ that puts the
    first windows before xfull's start and one that puts the last past its
    end (lax.dynamic_slice wraps a negative start once by L, then clamps it
    into [0, L − W]), frac·npfb on
    a half (rint, half to even), and frac·npfb rounding to npfb (clipped
    to npfb − 1, not the next ipos)."""
    k, m, npfb = (10, 4, 64) if kind == "real" else (4, 3, 32)
    cplx = kind == "complex"
    args = (k, m, 0.0 if not cplx else 0.5, npfb, cplx, "kaiser" if not cplx else "rnyquist")
    jb = j_sync.SymSyncScan(*args, lf_bw=0.0)
    pb = symsync.SymSyncScan(*args, lf_bw=0.0)
    n = 40 * k
    rng = np.random.default_rng(3)
    x = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0)
    x = x.astype(np.complex64 if cplx else np.float32)
    dt = np.complex64 if cplx else np.float32
    taus = [-(pb.H + 3 * k + 0.25), n / 2 + 0.3, 5.5 / npfb, 6.5 / npfb, (npfb - 0.25) / npfb]
    for tau in taus:
        tau = np.float32(tau)
        hist = rng.normal(size=pb.H).astype(np.float32)
        hist = (hist + 1j * rng.normal(size=pb.H)).astype(dt) if cplx else hist
        jstate = (jnp.asarray(hist), jnp.float32(tau), jnp.float32(0), jnp.asarray(dt(0)),
                  jnp.asarray(dt(0)))
        _, jy = jb.apply(jstate, jnp.asarray(x))
        pstate = (torch.from_numpy(hist), torch.tensor(tau), torch.tensor(0.0),
                  torch.zeros((), dtype=torch.complex64 if cplx else torch.float32),
                  torch.zeros((), dtype=torch.complex64 if cplx else torch.float32))
        _, py = pb.apply(pstate, torch.from_numpy(x))
        assert _rel(py.numpy(), np.asarray(jy)) < 1e-5, tau
        xfull = np.concatenate([hist, x])
        bank = symsync._interp_bank(k, m, npfb, pb.ftype, pb.beta)
        _, ty, _ = _scan_transcribed(xfull, bank, (tau, np.float32(0), dt(0), dt(0)),
                                     pb.loop(n))
        assert _rel(ty, np.asarray(jy)) < 1e-5, tau
    # the half-even pick itself: rint(5.5) = 6, rint(6.5) = 6; 63.75 clips to 63
    loop = pb.loop(n)
    for tau, want in ((5.5 / npfb, 6), (6.5 / npfb, 6), ((npfb - 0.25) / npfb, npfb - 1)):
        ipos, ph = k8.picks(torch.tensor(np.float32(tau)), 0, loop, npfb)
        assert int(ph) == want and int(ipos) == loop.start, (tau, int(ph), int(ipos))


def test_scan_wrapper_refusals():
    """The wrapper checks its operands: dtype, the bank's width, the
    carry's shape and dtype."""
    pb = symsync.sym_sync_r(10, mode="scan")
    bank = symsync._bank_on(10, 4, 64, "kaiser", 0.0, CPU)
    loop = pb.loop(100)
    z = torch.zeros(())
    with pytest.raises(ValueError, match="float32 or complex64"):
        k8.symsync_scan(torch.zeros(200, dtype=torch.float64), bank, (z, z, z, z), loop)
    with pytest.raises(ValueError, match="bank"):
        k8.symsync_scan(torch.zeros(200), bank[:, :10], (z, z, z, z), loop)
    with pytest.raises(ValueError, match="prev"):
        k8.symsync_scan(torch.zeros(200), bank, (z, z, torch.zeros((), dtype=torch.complex64),
                                                 z), loop)


def test_tracker_scan_decodes_coordinates_as_jax(tmp_path):
    """The DeNBFMSync tracker's per-channel chain with mode="scan" on a
    helicopter 2-FSK channel at 40 kHz with a +100 ppm clock, 4 blocks of
    the -c 64 flow's 130,880 frames cut to 16,384: helidecode finds only the
    sent coordinate, at least every one sent after the first block, and no
    fewer than the JAX SymSyncScan finds (each τ wrap at a block's end can
    cost the frame across it, in both packages)."""
    k, block, nblk, eps = 10, 16384, 4, 1e-4
    n = block * nblk
    text = heli_text(11)
    lv = heli_levels(text, n // k + 4)
    sym = np.floor((np.arange(n) + 3.3) / (k * (1 + eps))).astype(int)
    rng = np.random.default_rng(5)
    x = (0.3 * np.exp(2j * np.pi * np.cumsum(lv[sym] * 0.1))
         + 0.014 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    jg = cs.chain(cs.fm_demodulator(0.02 * k), j_sync.sym_sync_r(k, 4, 0.0, 64, mode="scan"))
    pg = ct.chain(ct.fm_demodulator(0.02 * k), symsync.sym_sync_r(k, 4, 0.0, 64, mode="scan"))
    js, ps = jg.init(), pg.init(CPU)
    outs = {"jax": [], "port": []}
    for b in range(nblk):
        js, jy = jg.apply(js, jnp.asarray(x[b * block:(b + 1) * block]))
        ps, py = pg.apply(ps, torch.from_numpy(x[b * block:(b + 1) * block]))
        outs["jax"].append(np.asarray(jy)), outs["port"].append(py.numpy())
    coords = {}
    for name, o in outs.items():
        path = str(tmp_path / f"{name}.f32")
        np.concatenate(o).astype(np.float32).tofile(path)
        coords[name] = heli_decode(path)
    after_first = 2 * ((n - block) // int(k * (1 + eps) * 730) - 1)
    for name, got in coords.items():
        assert set(got) == {heli_coord(text)}, (name, set(got))
    # every coordinate sent after the first block, or the JAX set where the
    # reference finds fewer
    assert len(coords["port"]) >= min(after_first, len(coords["jax"])), \
        (len(coords["port"]), len(coords["jax"]), after_first)
    print("coordinates", {k_: len(v) for k_, v in coords.items()}, "after the first block",
          after_first)
