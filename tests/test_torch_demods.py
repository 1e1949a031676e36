"""The port's FIR demod flows — AM, SSB (USB/LSB), CW, single-channel and
per channel — and the single-channel receivers against the JAX package,
streamed over several blocks; the ``nbfm_audio`` golden anchor; JAX state
handed to the port mid-stream for the channelized DeCW chain.

Tolerances: 2e-5 relative to the largest output, the golden tolerance of
tests/test_golden.py, where both sides run the same float32 arithmetic
(AM, the receivers, the anchor); 2e-3 where a long filter runs through an
FFT in the JAX package and through an FFT of another segmentation or
direct sums in the port (tests/test_fir.py:36); 3e-4 between the "fft" and
"pallas_fft" strategies (tests/test_fftfir.py:82)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.models import receivers as jrx

import csdr_tpu_torch as ct
from csdr_tpu_torch import blocks as TB
from csdr_tpu_torch.utils.convert import from_jax_chain_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5
GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden_anchors.npz")


def _rel(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


def _keyed(n, seed, carriers=((0.0, 0.5),)):
    """Carriers at (frequency in cycles/sample, amplitude), keyed on and off,
    with an AM tone, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    key = (np.mod(t // 700, 3) != 2).astype(np.float64)
    x = 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for f, a in carriers:
        x = x + a * key * (1 + 0.5 * np.sin(2 * np.pi * 0.001 * t)) * np.exp(
            2j * np.pi * np.mod(f * t, 1.0))
    return x.astype(np.complex64)


def _stream_both(jg, tg, blocks):
    js, ts = jg.init(), tg.init(CPU)
    outs = []
    for blk in blocks:
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        outs.append((ty, jy))
    return outs


@pytest.mark.parametrize("suppressed", [False, True])
def test_am_demod_matches_jax(suppressed):
    x = _keyed(3 * 1000, 1)
    outs = _stream_both(cs.blocks.AMDemod(suppressed=suppressed),
                        TB.AMDemod(suppressed=suppressed), np.split(x, 3))
    for ty, jy in outs:
        assert ty.dtype == torch.float32
        assert _rel(ty, jy) < TOL


@pytest.mark.parametrize("side", ["usb", "lsb"])
def test_ssb_demodulator_matches_jax(side):
    """Complex band-pass (487 taps at B = 0.0125), the "fft" strategy on
    both sides, then the real part."""
    f = 0.004 if side == "usb" else -0.004
    x = _keyed(3 * 4096, 2, carriers=((f, 0.5), (-f, 0.1)))
    jg, tg = cs.ssb_demodulator(side, 0.0125), ct.ssb_demodulator(side, 0.0125)
    for ty, jy in _stream_both(jg, tg, np.split(x, 3)):
        assert ty.dtype == torch.float32 and ty.is_contiguous()
        assert _rel(ty, jy) < 2e-3


@pytest.mark.parametrize("bw,pitch", [(0.0125, 0.0175), (0.002, 0.0029)])
def test_cw_demodulator_matches_jax(bw, pitch):
    """585 taps (the -c 64 channel's filter) and 3,651 (-c 1 at 2.56 MS/s);
    real taps over 256 non-zeros: "fft" on the CPU in both packages."""
    x = _keyed(3 * 8192, 3, carriers=((0.0003, 0.5),))
    jg, tg = cs.cw_demodulator(bw, pitch), ct.cw_demodulator(bw, pitch)
    for ty, jy in _stream_both(jg, tg, np.split(x, 3)):
        assert _rel(ty, jy) < 2e-3


@pytest.mark.parametrize("strategy", ["slices", "pallas_mxu"])
def test_cw_filter_strategies_agree(strategy):
    """The CW filter through the port's direct sums (slices, and K5's plain
    version) against JAX's "fft"."""
    x = _keyed(2 * 4096, 4)
    taps = ct.cw_demodulator(0.0125, 0.0175).blocks[0].taps
    jg = cs.fir_filter(taps, True)
    tg = TB.FIRFilter(taps, True, strategy=strategy)
    for ty, jy in _stream_both(jg, tg, np.split(x, 2)):
        assert _rel(ty, jy) < 2e-3


def test_cw_per_channel_matches_jax():
    """The channelized DeCW chain: dc_blocker >> PFB(4) >> PerChannel(CW)."""
    nch = 4
    x = _keyed(nch * 3 * 2048, 5, carriers=((-0.375, 0.3), (0.125, 0.3)))
    jg = jrx.channelized_receiver(nch, cs.cw_demodulator(0.0125, 0.0175))
    tg = ct.channelized_receiver(nch, ct.cw_demodulator(0.0125, 0.0175))
    for ty, jy in _stream_both(jg, tg, np.split(x, 3)):
        assert ty.shape == (nch, 2048)
        assert _rel(ty, jy) < 2e-3


def test_cw_chain_state_from_jax_mid_stream():
    """JAX runs the channelized DeCW chain (with AGC) for two blocks; its
    state — DC blocker, PFB hist, per-channel AGC, FIR hist and BFO phase —
    goes to the port, which continues as JAX does."""
    nch = 4
    x = _keyed(nch * 4 * 2048, 6, carriers=((-0.375, 0.3), (0.125, 0.3)))
    jg = jrx.channelized_receiver(nch, cs.cw_demodulator(0.0125, 0.0175),
                                  agc_threshold_db=-60.0)
    tg = ct.channelized_receiver(nch, ct.cw_demodulator(0.0125, 0.0175),
                                 agc_threshold_db=-60.0)
    blocks = np.split(x, 4)
    js = jg.init()
    for blk in blocks[:2]:
        js, _ = jg.apply(js, jnp.asarray(blk))
    ts = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
    fir_hist, bfo_phase = ts[2][1], ts[2][2]  # PerChannel((AGC, FIR, BFO, re))
    assert fir_hist.shape == (nch, 584) and bfo_phase.shape == (nch,)
    for blk in blocks[2:]:
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        assert _rel(ty, jy) < 2e-3


@pytest.mark.parametrize("flow", ["nbfm", "am", "raw"])
@pytest.mark.parametrize("agc", [None, -60.0])
def test_single_channel_receivers_match_jax(flow, agc):
    t = np.arange(3 * 2048)
    # an FM carrier well above the noise: atan2 amplifies float32 rounding
    # by 1/|d| where the magnitude nears zero
    x = (0.5 * np.exp(1j * (2 * np.pi * np.mod(0.01 * t, 1.0) + 3 * np.sin(2e-3 * t)))
         + _keyed(len(t), 7, carriers=())).astype(np.complex64)
    if flow == "nbfm":
        jg = jrx.nbfm_receiver(2.56e6, 0.0, 0.6, agc_threshold_db=agc)
        tg = ct.nbfm_receiver(2.56e6, 0.0, 0.6, agc_threshold_db=agc)
    elif flow == "am":
        jg = jrx.am_receiver(2.56e6, 0.0, agc_threshold_db=agc)
        tg = ct.am_receiver(2.56e6, 0.0, agc_threshold_db=agc)
    else:
        jg = jrx.raw_capture(2.56e6, agc_threshold_db=agc)
        tg = ct.raw_capture(2.56e6, agc_threshold_db=agc)
    for ty, jy in _stream_both(jg, tg, np.split(x, 3)):
        assert _rel(ty, jy) < TOL


def test_receiver_front_end_in_graph_matches_jax():
    """am_receiver with --offset and -b inside the graph."""
    jg = jrx.am_receiver(2.56e6, 48000.0, offset_hz=20000.0)
    tg = ct.am_receiver(2.56e6, 48000.0, offset_hz=20000.0)
    x = _keyed(3 * 160 * 40, 8, carriers=((20000 / 2.56e6, 0.5),))
    for ty, jy in _stream_both(jg, tg, np.split(x, 3)):
        assert ty.shape == (40 * 3,)
        assert _rel(ty, jy) < TOL


def test_golden_nbfm_anchor():
    """tests/test_golden.py:60-63: dc_blocker >> AGC(no squelch) >> FM
    demod(0.3) through the port's Pipeline, 2^14-sample blocks."""
    if not os.path.exists(GOLD):
        pytest.skip("golden anchors not generated")
    gold = np.load(GOLD)
    g = ct.chain(ct.dc_blocker(), ct.automatic_gain_control(None), ct.fm_demodulator(0.3))
    x = gold["in_fm"]
    sink = ct.CollectSink()
    ct.Pipeline(g, block_size=1 << 14, device=CPU).run(iter([x]), sink, num_samples=len(x))
    assert _rel(sink.concat(), gold["nbfm_audio"]) < TOL


def test_fir_filter_pallas_fft_matches_fft_strategy():
    """The library path of K6: FIRFilter(strategy="pallas_fft") against
    strategy="fft" over a u8 → IQ → band-pass → real chain in the
    Pipeline (on the CPU, K6's plain version)."""
    taps = ct.ssb_demodulator("usb", 3000 / 2.56e6).blocks[0].taps  # -c 1 DeUSB 3000
    assert len(taps) == 1826
    rng = np.random.default_rng(9)
    u8 = rng.integers(0, 256, size=(3 * 20000, 2)).astype(np.uint8)
    outs = {}
    for strategy in ("fft", "pallas_fft"):
        g = ct.chain(ct.u8_to_iq(), ct.fir_filter(taps, True, strategy=strategy),
                     ct.Lambda(lambda x: x.real.contiguous(), name="re"))
        sink = ct.CollectSink()
        ct.Pipeline(g, block_size=20000, device=CPU).run(iter([u8]), sink)
        outs[strategy] = sink.concat()
    assert outs["fft"].shape == (3 * 20000,) and outs["fft"].dtype == np.float32
    assert _rel(outs["pallas_fft"], outs["fft"]) < 3e-4
