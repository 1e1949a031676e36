"""The port's broadcast-FM graphs: the golden WBFM, stereo and RDS anchors
through its Pipeline, the stereo decoder and the RDS receiver against the
JAX blocks (with JAX state handed over mid-stream), and the Tee/Delay
combinators with their flush and multi-rate trim (the cases of
tests/test_flush.py and tests/test_blocks_runtime.py).

Tolerances: 2e-5 relative to the largest output, the golden tolerance of
tests/test_golden.py, for audio; the RDS bits byte-exact
(tests/test_golden.py:81)."""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csdr_tpu.core.block import Tee as JTee
from csdr_tpu.models import rds as jrds
from csdr_tpu.models.stereo import StereoFMDecoder as JStereo

import csdr_tpu_torch as ct
from csdr_tpu_torch.models import rds
from csdr_tpu_torch.models.stereo import StereoFMDecoder, stereo_fm_decoder
from csdr_tpu_torch.utils.convert import from_jax_chain_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5
GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden_anchors.npz")


@pytest.fixture(scope="module")
def gold():
    if not os.path.exists(GOLD):
        pytest.skip("golden anchors not generated")
    return np.load(GOLD)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


def _run(graph, x, block, sink=None):
    sink = sink if sink is not None else ct.CollectSink()
    total = ct.Pipeline(graph, block_size=block, device=CPU).run(iter([x]), sink,
                                                                  num_samples=len(x))
    return sink, total


def test_golden_wbfm_anchor(gold):
    """tests/test_golden.py:47-50: resampler(1/8) >> dc_blocker >> WBFM."""
    g = ct.chain(ct.resampler(0.125), ct.dc_blocker(), ct.wbfm_demodulator(32000.0, 4))
    sink, _ = _run(g, gold["in_fm"], 1 << 14)
    assert _rel(sink.concat(), gold["wbfm_audio"]) < TOL


def test_golden_stereo_rds_anchor(gold):
    """tests/test_golden.py:66-83: Tee(stereo_fm_decoder, rds_receiver) on the
    pinned MPX; the audio at 2e-5, the bits byte-exact, the station
    decoded.  The slicer's margin, |matched filter| at the chosen bit
    phase: bits 0 and 1 fall in the data filter's warm-up on a zero history
    (6.2e-10 and 8.7e-7 on the CPU, where a float difference may flip
    them), bit 2 reads 2.0e-3, and every later bit ≥ 4.8e-2."""
    quad = 192000.0
    g = ct.Tee(stereo_fm_decoder(quad, 4), rds.rds_receiver(quad))
    audio, bits = ct.CollectSink(), ct.CollectSink()
    _run(g, gold["in_mpx"], g.granule * max(1, (1 << 16) // g.granule),
         ct.BranchSinks(audio, bits))
    assert _rel(audio.concat(), gold["stereo_audio"]) < TOL
    assert np.array_equal(bits.concat(), gold["rds_bits"])
    dec = rds.decode_groups(bits.concat())
    assert dec["ps"] == "CSDR-TPU" and dec["pi"] == 0x52D4, dec

    front = ct.chain(*rds.rds_receiver(quad).blocks[:-1])
    base, _ = _run(front, gold["in_mpx"], 19 * 3200)
    slicer = rds.RDSBitSlicer()
    _, rows, ph = slicer.matched(slicer.init(CPU)[0], torch.from_numpy(base.concat()))
    mf = rows[:, ph].abs()
    assert mf[2].item() > 1e-3 and mf[3:].min().item() > 4e-2, mf[:4].tolist()


def _mpx(quad, n, seed):
    """A pilot-locked stereo MPX with L ≠ R tones, RDS groups and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / quad
    L, R = 0.5 * np.sin(2 * np.pi * 900 * t), 0.5 * np.sin(2 * np.pi * 3100 * t)
    pil = 2 * np.pi * 19000 * t + rng.uniform(0, 2 * np.pi)
    groups = [rds.make_group_0a(0x1234, s, "ABCDEFGH"[2 * s:2 * s + 2]) for s in range(4)]
    tx = rds.bits_from_groups(groups)
    bit = tx[np.floor(t * rds.RDS_BAUD).astype(np.int64) % len(tx)]
    half = np.floor(t * 2 * rds.RDS_BAUD).astype(np.int64) % 2
    lvl = (bit * 2.0 - 1.0) * np.where(half == 0, 1.0, -1.0)
    mpx = (0.45 * (L + R) + 0.1 * np.cos(pil) + 0.45 * (L - R) * np.cos(2 * pil)
           + 0.1 * lvl * np.cos(3 * pil) + 0.01 * rng.normal(size=n))
    return mpx.astype(np.float32)


def _stream_handover(jg, tg, blocks, handover):
    """JAX runs every block; the port runs the first ``handover`` blocks on
    its own state, then continues from the JAX state."""
    js, ts = jg.init(), tg.init(CPU)
    outs = []
    for i, blk in enumerate(blocks):
        if i == handover:
            ts = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        outs.append((ty, jy))
    return outs


def test_stereo_decoder_matches_jax_with_state_handover():
    quad, decim = 200000.0, 8
    x = _mpx(quad, 3 * 8000, 1)
    for ty, jy in _stream_handover(JStereo(quad, decim), StereoFMDecoder(quad, decim),
                                   np.split(x, 3), handover=1):
        assert ty.shape == (2, 1000) and ty.dtype == torch.float32
        assert _rel(ty, jy) < TOL


def test_rds_receiver_matches_jax_with_state_handover():
    """RDSBaseband (333-tap data filter at 200 kHz), the 19/200 resampler and
    the slicer: the bits equal, the baseband to 2e-5."""
    quad = 200000.0
    x = _mpx(quad, 3 * 32000, 2)
    outs = _stream_handover(jrds.rds_receiver(quad), rds.rds_receiver(quad), np.split(x, 3),
                            handover=2)
    bits = []
    for ty, jy in outs:
        assert ty.dtype == torch.uint8 and np.array_equal(ty.numpy(), np.asarray(jy))
        bits.append(ty.numpy())
    assert rds.RDSBaseband(quad).h_data.shape == (333,)
    base = _stream_handover(jrds.RDSBaseband(quad), rds.RDSBaseband(quad), np.split(x, 3), 1)
    for ty, jy in base:
        assert _rel(ty, jy) < TOL


def test_rds_protocol_layer_equals_jax():
    groups = [rds.make_group_0a(0x52D4, s, "CSDR-TPU"[2 * s:2 * s + 2], pty=3) for s in range(4)]
    groups += [rds.make_group_2a(0x52D4, s, "TPU NATIVE RADIO"[4 * s:4 * s + 4]) for s in range(4)]
    jgroups = [jrds.make_group_0a(0x52D4, s, "CSDR-TPU"[2 * s:2 * s + 2], pty=3)
               for s in range(4)]
    jgroups += [jrds.make_group_2a(0x52D4, s, "TPU NATIVE RADIO"[4 * s:4 * s + 4])
                for s in range(4)]
    assert groups == jgroups
    tx = rds.bits_from_groups(groups)
    assert np.array_equal(tx, jrds.bits_from_groups(jgroups))
    msg = np.bitwise_xor(tx, np.concatenate([[0], tx[:-1]])).astype(np.uint8)
    for skip in (0, 7):
        assert rds.decode_groups(msg[skip:]) == jrds.decode_groups(msg[skip:])
    assert all(rds.syndrome(rds.encode_block(m, o)) == rds.OFFSETS[o]
               for m in (0, 0x1234, 0xFFFF) for o in rds.OFFSETS)
    assert [rds.crc10(m) for m in range(0, 65536, 4099)] == [
        jrds.crc10(m) for m in range(0, 65536, 4099)]


def test_scan_pll_is_not_ported():
    """pll_mode="scan" builds the ported per-sample PLL (tests/test_torch_scan.py
    holds it to the JAX package); a mode other than "closed_form" or "scan"
    raises, where the JAX package takes it as "closed_form"."""
    assert StereoFMDecoder(200000.0, 8, pll_mode="scan").pll_mode == "scan"
    with pytest.raises(ValueError, match="use one of"):
        StereoFMDecoder(200000.0, 8, pll_mode="loop")


# --- Tee, Delay, flush and multi-rate trim ----------------------------------

def test_delay_flush_completes_delayed_branch():
    """tests/test_flush.py:27-41: with the flush each branch carries N + n
    samples, the live one input + zeros, the delayed one zeros + input."""
    n, N = 7, 1000
    x = np.random.default_rng(0).normal(size=N).astype(np.float32)
    sink = ct.CollectSink()
    total = ct.Pipeline(ct.chain(ct.Delay(n)), block_size=256, device=CPU).run(iter([x]), sink)
    live = np.concatenate([p[0] for p in sink.parts])
    delayed = np.concatenate([p[1] for p in sink.parts])
    assert total == N + n
    assert np.array_equal(live, np.concatenate([x, np.zeros(n, np.float32)]))
    assert np.array_equal(delayed, np.concatenate([np.zeros(n, np.float32), x]))


def test_delay_pairs_with_delayed_copy():
    d = ct.Delay(3)
    st = d.init(CPU)
    st, (a, b) = d.apply(st, torch.arange(8, dtype=torch.float32))
    assert b.tolist() == [0, 0, 0, 0, 1, 2, 3, 4]
    st, (a2, b2) = d.apply(st, torch.arange(8, 16, dtype=torch.float32))
    assert b2.tolist() == [5, 6, 7, 8, 9, 10, 11, 12] and a2.tolist() == list(range(8, 16))


def test_flush_is_noop_for_causal_graphs():
    """tests/test_flush.py:44-53: run (with the flush) equals stream."""
    g = ct.chain(ct.dc_blocker(), ct.fm_demodulator(0.6))
    assert g.flush_len() == 0
    x = np.exp(2j * np.pi * 0.05 * np.arange(4096)).astype(np.complex64)
    s1 = ct.CollectSink()
    assert ct.Pipeline(g, 1024, device=CPU).run(iter([x]), s1) == 4096
    streamed = list(ct.Pipeline(g, 1024, device=CPU).stream(iter([x])))
    assert np.array_equal(s1.concat(), np.concatenate(streamed))


def test_chain_flush_len_scales_by_rate_prefix():
    """tests/test_flush.py:56-63."""
    dec = ct.fir_decimator(4)
    assert ct.chain(dec, ct.Delay(5)).flush_len() == 20
    assert ct.chain(ct.Delay(5), dec).flush_len() == 5
    tee = ct.Tee(StereoFMDecoder(192000.0, 4), ct.Delay(300))
    assert tee.flush_len() == max(StereoFMDecoder(192000.0, 4).flush_len(), 300)


def test_stereo_flush_exact_count_and_tail_content():
    """tests/test_flush.py:66-95: the flushed run emits (N + flush)/decim
    frames and equals an unflushed run over the zero-padded input."""
    quad, decim = 192000.0, 4
    N = 1 << 15
    t = np.arange(N) / quad
    L, R = 0.5 * np.sin(2 * np.pi * 800.0 * t), 0.5 * np.sin(2 * np.pi * 2000.0 * t)
    mpx = (0.45 * (L + R) + 0.1 * np.cos(2 * np.pi * 19000.0 * t)
           + 0.45 * (L - R) * np.cos(2 * np.pi * 38000.0 * t)).astype(np.float32)
    dec = StereoFMDecoder(quad, decim)
    nf = dec.flush_len()
    assert nf >= dec.gdelay and nf % decim == 0
    assert nf == JStereo(quad, decim).flush_len()
    sink = ct.CollectSink()
    total = ct.Pipeline(ct.chain(StereoFMDecoder(quad, decim)), 4096, device=CPU).run(
        iter([mpx]), sink)
    assert total == (N + nf) // decim
    padded = np.concatenate([mpx, np.zeros(nf, np.float32)])
    ref = np.concatenate(list(ct.Pipeline(ct.chain(StereoFMDecoder(quad, decim)), 4096,
                                          device=CPU).stream(iter([padded]))), axis=-1)
    assert sink.concat().shape == ref.shape == (2, (N + nf) // decim)
    assert np.array_equal(sink.concat(), ref)


def test_rate_tree_multirate_tee_mid_chain():
    """tests/test_blocks_runtime.py:144-161: a Tee defines the per-branch
    rates, scaled by what comes before it; a block after it collapses them."""
    tee = ct.Tee(ct.chain(ct.fm_demodulator(0.5), ct.fir_decimator(4)), ct.Lambda(lambda x: x))
    assert tee.rate_tree() == (Fraction(1, 4), Fraction(1))
    same = ct.Tee(ct.Lambda(lambda x: x), ct.Lambda(lambda x: 2 * x))
    combine = ct.Lambda(lambda t: t[0] + t[1], name="combine")
    assert ct.chain(same, combine).rate_tree() == Fraction(1)
    assert ct.chain(same, combine, ct.fir_decimator(4)).rate_tree() == Fraction(1, 4)
    assert ct.chain(ct.fir_decimator(2), tee).rate_tree() == (Fraction(1, 8), Fraction(1, 2))


def test_multirate_tee_per_branch_trim():
    """tests/test_blocks_runtime.py:164-200: each Tee leaf trimmed by its own
    rate, the count the first branch's, short last blocks included."""
    n = 1 << 14
    msg = 0.3 * np.sin(2 * np.pi * 0.003 * np.arange(n))
    iq = np.exp(1j * 2 * np.pi * 0.1 * np.cumsum(msg)).astype(np.complex64)
    audio_path = ct.chain(ct.fm_demodulator(0.5), ct.fir_decimator(4))
    for m in (n, 4096 + 1000):
        a, r = ct.CollectSink(), ct.CollectSink()
        total = ct.Pipeline(ct.Tee(audio_path, ct.Lambda(lambda x: x, name="id")), 4096,
                            device=CPU).run(iter([iq[:m]]), ct.BranchSinks(a, r))
        assert len(a.concat()) == m // 4 == total
        assert np.array_equal(r.concat(), iq[:m])
        ref = ct.CollectSink()
        ct.Pipeline(audio_path, 4096, device=CPU).run(iter([iq[:m]]), ref)
        assert np.array_equal(a.concat(), ref.concat())


def test_multirate_tee_stream_and_granule():
    """tests/test_blocks_runtime.py:203-214."""
    tee = ct.Tee(ct.fir_decimator(8), ct.fir_decimator(4))
    assert tee.granule % 8 == 0
    x = np.random.default_rng(0).normal(size=1 << 13).astype(np.float32)
    outs = list(ct.Pipeline(tee, 2048, device=CPU).stream(iter([x])))
    assert sum(len(o[0]) for o in outs) == len(x) // 8
    assert sum(len(o[1]) for o in outs) == len(x) // 4


def test_branch_sinks_type_check():
    bs = ct.BranchSinks(ct.NullSink(), ct.NullSink())
    with pytest.raises(TypeError, match="2-tuple"):
        bs(np.zeros(4))
    bs((np.zeros(4), np.zeros(2)))
    bs.close()


def test_tee_matches_jax_tee():
    quad = 192000.0
    x = _mpx(quad, 3 * 19200, 3)
    jg = JTee(JStereo(quad, 4), jrds.rds_receiver(quad))
    tg = ct.Tee(StereoFMDecoder(quad, 4), rds.rds_receiver(quad))
    assert tg.granule == jg.granule and tg.rate_tree() == jg.rate_tree()
    for (ta, tb), (ja, jb) in _stream_handover(jg, tg, np.split(x, 3), handover=1):
        assert _rel(ta, ja) < TOL and np.array_equal(tb.numpy(), np.asarray(jb))
