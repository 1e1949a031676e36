"""The port's front end — the NCO mixer, the half-band and rational
resampler stages, ``resampler`` and ``models.receivers.front_end`` — and the
FIR decimator behind the channelized FM receiver, against the JAX package,
streamed over several blocks; and JAX state handed to the port mid-stream.

Tolerance: 2e-5 relative to the largest output, the golden tolerance of
tests/test_golden.py (the same float32 arithmetic in another order), and
2e-3 for the FM receivers with the FIR decimator (tests/test_fir.py:71)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.core.block import PerChannel as JPerChannel
from csdr_tpu.models import receivers as jrx
from csdr_tpu.ops import resamp as jresamp

import csdr_tpu_torch as ct
from csdr_tpu_torch import blocks as TB
from csdr_tpu_torch.ops import resamp as tresamp
from csdr_tpu_torch.utils.convert import from_jax_chain_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5


def _rel(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


def _iq(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (0.6 * np.exp(2j * np.pi * np.mod(0.013 * t, 1.0))
         + 0.3 * np.exp(2j * np.pi * np.mod(-0.21 * t, 1.0))
         + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    return x.astype(np.complex64)


def _stream_both(jg, tg, blocks):
    """Run both graphs block by block; returns the outputs per block and the
    final states."""
    js, ts = jg.init(), tg.init(CPU)
    outs = []
    for blk in blocks:
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        outs.append((ty, jy))
    return outs, js, ts


@pytest.mark.parametrize("omega,up", [(0.37, True), (2.9, False), (-1.3, True)])
def test_mixer_matches_jax(omega, up):
    x = _iq(3 * 1000, 1)
    jg = cs.mix_up(omega) if up else cs.mix_down(omega)
    tg = TB.mix_up(omega) if up else TB.mix_down(omega)
    outs, js, ts = _stream_both(jg, tg, np.split(x, 3))
    for ty, jy in outs:
        assert _rel(ty, jy) < TOL
    assert abs(float(ts) - float(js)) < 1e-6


def test_mixer_per_channel_phases_match_jax():
    """Inside PerChannel the phase is one per channel, (nch,)."""
    nch = 4
    x = _iq(nch * 3 * 500, 2).reshape(nch, 3 * 500)
    jg, tg = JPerChannel(cs.mix_up(0.7), nch), ct.PerChannel(TB.mix_up(0.7), nch)
    outs, js, ts = _stream_both(jg, tg, np.split(x, 3, axis=1))
    for ty, jy in outs:
        assert ty.shape == (nch, 500)
        assert _rel(ty, jy) < TOL
    assert ts.shape == (nch,)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_rational_taps_equal():
    for P, Q in [(3, 5), (61, 64), (4, 5)]:
        np.testing.assert_array_equal(tresamp.rational_taps(P, Q), jresamp.rational_taps(P, Q))
        assert tresamp.rational_approx(P / Q) == jresamp.rational_approx(P / Q)


@pytest.mark.parametrize("P,Q", [(3, 5), (4, 5), (61, 64)])
def test_rational_resampler_matches_jax(P, Q):
    """(3, 5) and (4, 5) run the strided slices; (61, 64) has P·L > 2048 and
    runs the gather form."""
    taps = tresamp.rational_taps(P, Q)
    assert (P * taps.shape[1] > 2048) == (P == 61)
    x = _iq(3 * Q * 40, 3)
    outs, js, ts = _stream_both(cs.blocks.RationalResampler(P, Q),
                                TB.RationalResampler(P, Q), np.split(x, 3))
    for ty, jy in outs:
        assert ty.shape == (Q * 40 // Q * P,)
        assert _rel(ty, jy) < TOL
    assert _rel(ts, js) == 0.0


def test_halfband_decim_matches_jax():
    x = _iq(4 * 512, 4)
    outs, _, _ = _stream_both(cs.blocks.HalfbandDecim(), TB.HalfbandDecim(), np.split(x, 4))
    for ty, jy in outs:
        assert ty.shape == (256,)
        assert _rel(ty, jy) < TOL


@pytest.mark.parametrize("rate", [48000 / 2.56e6, 0.4, 61 / 64, 0.5])
def test_resampler_matches_jax(rate):
    jg, tg = cs.resampler(rate), ct.resampler(rate)
    assert tg.rate == jg.rate and tg.granule == jg.granule
    g = tg.granule
    x = _iq(3 * g * max(1, 4096 // g), 5)
    outs, _, _ = _stream_both(jg, tg, np.split(x, 3))
    for ty, jy in outs:
        assert _rel(ty, jy) < TOL


def test_resampler_granule_for_48k_from_2_56M():
    """Five half-bands and a 3/5 stage: granule 2^5·5 = 160, rate 3/160."""
    g = ct.resampler(48000 / 2.56e6)
    assert g.granule == 160 and g.rate == jrx.front_end(2.56e6, 0.0, 48000)[0].rate
    assert [b.name for b in g.blocks] == ["halfband_decim"] * 5 + ["resamp(3/5)"]


@pytest.mark.parametrize("offset,bw", [(25600.0, 0.0), (-40000.0, 0.0), (0.0, 48000.0),
                                       (12345.0, 640000.0)])
def test_front_end_matches_jax(offset, bw):
    jst = jrx.front_end(2.56e6, offset, bw)
    tst = ct.front_end(2.56e6, offset, bw)
    assert [type(b).__name__ for b in tst] == [type(b).__name__ for b in jst]
    jg, tg = cs.chain(*jst), ct.chain(*tst)
    g = tg.granule
    x = _iq(3 * g * max(1, 8192 // g), 6)
    outs, _, _ = _stream_both(jg, tg, np.split(x, 3))
    for ty, jy in outs:
        assert _rel(ty, jy) < TOL


def test_front_end_state_from_jax_mid_stream():
    """The `-b` chain (mixer + resampler) run by JAX for two blocks, its
    state handed to the port, which continues as JAX does."""
    jg = cs.chain(*jrx.front_end(2.56e6, 30000.0, 48000.0))
    tg = ct.chain(*ct.front_end(2.56e6, 30000.0, 48000.0))
    blocks = np.split(_iq(4 * 160 * 30, 7), 4)
    js = jg.init()
    for blk in blocks[:2]:
        js, _ = jg.apply(js, jnp.asarray(blk))
    ts = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
    for blk in blocks[2:]:
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        assert _rel(ty, jy) < TOL


@pytest.mark.parametrize("backend", ["eager", "pfb_fused"])
def test_channelized_fm_receiver_audio_decim(backend):
    """audio_decim > 1 appends the per-channel FIR decimator (JAX
    models/receivers.py:151-157); against the JAX XLA graph."""
    nch, decim = 8, 4
    t = np.arange(nch * 64 * 2 * 3)
    x = np.zeros(len(t), np.complex128)
    for k in range(nch):
        fc = (k - (nch - 1) / 2) / nch
        x += 0.3 * np.exp(1j * (2 * np.pi * np.mod(fc * t, 1.0)
                                + 2.0 * np.sin(2 * np.pi * 0.002 * t) + k))
    x = x.astype(np.complex64)
    jg = jrx.channelized_fm_receiver(nch, kf=0.6, audio_decim=decim, backend="xla")
    tg = ct.channelized_fm_receiver(nch, kf=0.6, audio_decim=decim, backend=backend)
    assert tg.rate == jg.rate
    outs, _, _ = _stream_both(jg, tg, np.split(x, 3))
    ys = [(ty.numpy(), np.asarray(jy)) for ty, jy in outs]
    got, want = (np.concatenate(v, axis=1) for v in zip(*ys))
    assert got.shape == (nch, len(t) // nch // decim)
    # pfb_fused's demod history starts at zeros where FMDemod starts from a
    # unit sample: frame 0 differs and reaches the decimator's first outputs
    f0 = 0 if backend == "eager" else 64 // decim
    assert _rel(got[:, f0:], want[:, f0:]) < 2e-3
