"""The port's coded modem on the CPU against the JAX package: the
convolutional encoder and the Viterbi decoder (ties included), the modem's
constellations, decisions and LLRs, the coded packet link, the coded 4-FSK
beacon, ``FSKDemod``, and the golden anchors ``modem_payload`` and
``beacon_message``.

Tolerances: bits, decisions, indices, messages, offsets and frequency bins
exactly equal; float panels (soft LLRs, tone energies, constellation
points) 1e-5 relative (tests/test_modem.py:78, :108); the golden anchors
byte-exact (tests/test_golden.py:121-149)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.blocks import FSKDemod as JFSKDemod
from csdr_tpu.models import beacon as j_beacon
from csdr_tpu.models import modem as j_modem
from csdr_tpu.ops import demod as j_demod
from csdr_tpu.ops import fec as j_fec
from csdr_tpu.utils import testsig

import csdr_tpu_torch as ct
from csdr_tpu_torch.blocks import FSKDemod, fsk_demodulator
from csdr_tpu_torch.models import beacon, modem
from csdr_tpu_torch.ops import demod as demod_ops
from csdr_tpu_torch.ops import fec

torch.set_num_threads(1)

CPU = torch.device("cpu")
FLOAT_TOL = 1e-5   # tests/test_modem.py:78, :108
GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden_anchors.npz")


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _noisy(x, sigma, seed):
    r = np.random.default_rng(seed)
    return (x + sigma * (r.normal(size=len(x)) + 1j * r.normal(size=len(x)))).astype(np.complex64)


# ---- ops/fec ------------------------------------------------------------------

@pytest.mark.parametrize("polys,K,tail", [(fec.CCSDS_POLYS, 7, True), ((0o23, 0o35), 5, True),
                                          (fec.CCSDS_POLYS, 7, False)])
def test_conv_encode_and_tables_equal_jax(polys, K, tail):
    bits = np.random.default_rng(0).integers(0, 2, 300)
    assert np.array_equal(fec.conv_encode(bits, polys, K, tail),
                          j_fec.conv_encode(bits, polys, K, tail))
    for a, b in zip(fec._tables(polys, K), j_fec._tables(polys, K)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["random", "integer_ties", "no_tail", "k5"])
def test_viterbi_decode_equals_jax(case):
    """Random LLRs; small integer LLRs whose path metrics tie exactly (the
    first predecessor wins, as jnp.argmax); tail=False (traceback from the
    best end state); K=5."""
    rng = np.random.default_rng(1)
    polys, K, tail = fec.CCSDS_POLYS, 7, case != "no_tail"
    if case == "k5":
        polys, K = (0o23, 0o35), 5
    msg = rng.integers(0, 2, 400)
    coded = fec.conv_encode(msg, polys, K, tail)
    if case == "integer_ties":
        llr = (rng.integers(-2, 3, len(coded))).astype(np.float32)
    else:
        llr = ((1.0 - 2.0 * coded) * 2.0 + rng.normal(scale=1.2, size=len(coded))).astype(
            np.float32)
    got = fec.viterbi_decode(llr, polys, K, tail)
    want = np.asarray(j_fec.viterbi_decode(jnp.asarray(llr), polys, K, tail))
    assert got.dtype == torch.uint8 and got.device == CPU
    assert np.array_equal(got.numpy(), want)
    if case == "random":
        assert np.mean(got.numpy() != msg) < 0.01
    # the same on a torch tensor
    assert np.array_equal(fec.viterbi_decode(torch.from_numpy(llr), polys, K, tail).numpy(),
                          want)


def test_coded_ber_equals_jax():
    got = fec.coded_ber(2000, 1.0, seed=3)
    want = j_fec.coded_ber(2000, 1.0, seed=3)
    assert got == want
    assert got[0] < got[1]  # the coding gain


# ---- models/modem -------------------------------------------------------------

@pytest.mark.parametrize("ms", modem.CONSTELLATIONS)
def test_modem_functions_equal_jax(ms):
    rng = np.random.default_rng(4)
    assert np.array_equal(modem.constellation(ms), j_modem.constellation(ms))
    assert modem.bits_per_symbol(ms) == j_modem.bits_per_symbol(ms)
    bps = modem.bits_per_symbol(ms)
    bits = rng.integers(0, 2, 600 * bps)
    syms = modem.modulate(bits, ms)
    assert np.array_equal(syms, j_modem.modulate(bits, ms))
    y = _noisy(syms, 0.2, 5)
    idx, dec = modem.hard_decision(torch.from_numpy(y), ms)
    jidx, jdec = j_modem.hard_decision(jnp.asarray(y), ms)
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), np.asarray(jidx))
    assert _rel(dec.numpy(), np.asarray(jdec)) < FLOAT_TOL
    assert np.array_equal(modem.symbols_to_bits(idx.numpy(), ms),
                          j_modem.symbols_to_bits(np.asarray(jidx), ms))
    assert _rel(modem.soft_llrs(torch.from_numpy(y), ms, 0.05).numpy(),
                np.asarray(j_modem.soft_llrs(jnp.asarray(y), ms, 0.05))) < FLOAT_TOL
    assert _rel(modem._metric_panel(torch.from_numpy(y), ms).numpy(),
                np.asarray(j_modem._metric_panel(jnp.asarray(y), ms))) < FLOAT_TOL
    assert np.array_equal(modem._gray(16), j_modem._gray(16))


def test_hard_decision_ties_pick_the_first_point():
    """Points equidistant from two constellation points: the lower index
    wins in both packages (jnp.argmax)."""
    y = np.array([0.0, 1j, -1j, 0.0 + 0.0j], np.complex64)
    for ms in ("bpsk", "qpsk", "qam16"):
        assert np.array_equal(modem.hard_decision(torch.from_numpy(y), ms)[0].numpy(),
                              np.asarray(j_modem.hard_decision(jnp.asarray(y), ms)[0]))


def test_soft_decision_block_in_a_pipeline():
    """SoftDecision behind a Pipeline: the JAX block's (n, bps) LLRs, time
    last as the port's runtime streams them, (bps, n)."""
    rng = np.random.default_rng(2)
    y = _noisy(modem.modulate(rng.integers(0, 2, 2048), "qpsk"), 0.1, 6)
    sink = ct.CollectSink()
    ct.Pipeline(ct.chain(modem.soft_decision("qpsk", 0.1)), block_size=256,
                device=CPU).run(iter([y]), sink)
    got = sink.concat()
    want = np.asarray(j_modem.SoftDecision("qpsk", 0.1).apply((), jnp.asarray(y))[1])
    assert got.shape == (2, 1024) and _rel(got, want.T) < FLOAT_TOL


@pytest.mark.parametrize("ms,sigma,nbits", [("qpsk", 0.25, 1000), ("qam16", 0.05, 500),
                                            ("8psk", 0.05, 300)])
def test_coded_packet_loopback_equals_jax(ms, sigma, nbits):
    """tests/test_modem.py:250-280: the coded packet through AWGN decodes
    exactly, to the JAX package's bits."""
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 2, nbits)
    sym = modem.coded_packet_modulate(payload, ms)
    assert np.array_equal(sym, j_modem.coded_packet_modulate(payload, ms))
    noisy = _noisy(sym, sigma, 10)
    nv = 2 * sigma ** 2
    got = modem.coded_packet_demodulate(noisy, ms, noise_var=nv)
    want = j_modem.coded_packet_demodulate(noisy, ms, noise_var=nv)
    assert got is not None and np.array_equal(got, payload) and np.array_equal(got, want)
    assert modem.coded_packet_demodulate(torch.from_numpy(noisy), ms, noise_var=nv) is not None


def test_coded_packet_refuses_short_and_long():
    assert modem.coded_packet_demodulate(np.zeros(40, np.complex64), "qpsk") is None
    with pytest.raises(ValueError, match="16-bit length word"):
        modem.coded_packet_modulate(np.zeros(1 << 16, np.int64))


# ---- models/beacon --------------------------------------------------------------

def _message(seed):
    return np.random.default_rng(seed).integers(0, 2, beacon.MESSAGE_BITS)


def test_beacon_tables_equal_jax():
    assert np.array_equal(beacon.sync_chips(), j_beacon.sync_chips())
    m = _message(0)
    assert np.array_equal(beacon.crc8(m), j_beacon.crc8(m))
    assert np.array_equal(beacon._tone_matrix(64), j_beacon._tone_matrix(64))
    assert np.array_equal(beacon.beacon_modulate(m, 32), j_beacon.beacon_modulate(m, 32))
    with pytest.raises(ValueError):
        beacon.beacon_modulate(np.zeros(10, np.int64))


@pytest.mark.parametrize("case", ["clean", "below_noise", "offsets", "garbage"])
def test_beacon_decode_equals_jax(case):
    """tests/test_beacon.py:22-80 on the same noisy inputs: message, offset
    and frequency bin equal; pure noise refused by both."""
    rng = np.random.default_rng(11)
    m = _message(3)
    x = beacon.beacon_modulate(m, spsym=64)
    if case == "below_noise":   # −13 dB SNR in the full baseband bandwidth
        sigma = np.sqrt(10.0 ** 1.3 / 2.0)
        x = x + sigma * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
    elif case == "offsets":     # 23 samples late, +1 tone spacing
        t = np.arange(len(x) + 200)
        x = np.concatenate([np.zeros(23, np.complex64), x, np.zeros(177, np.complex64)])
        x = x * np.exp(2j * np.pi * t / 64) + 0.3 * (rng.normal(size=len(t))
                                                     + 1j * rng.normal(size=len(t)))
    elif case == "garbage":
        x = rng.normal(size=len(x)) + 1j * rng.normal(size=len(x))
    x = x.astype(np.complex64)
    got, info = beacon.beacon_decode(x, spsym=64)
    want, jinfo = j_beacon.beacon_decode(x, spsym=64)
    assert info == jinfo
    if case == "garbage":
        assert got is None and want is None
    else:
        assert got is not None and np.array_equal(got, m) and np.array_equal(got, want)


def test_tone_energies_device_equals_jax():
    x = _noisy(beacon.beacon_modulate(_message(5), 64), 0.5, 12)
    got = beacon.tone_energies_device(torch.from_numpy(x), 64).numpy()
    planes = np.stack([x.real, x.imag], 1).astype(np.float32)
    want = np.asarray(j_beacon.tone_energies_device(jnp.asarray(planes), 64))
    assert got.shape == (beacon.N_SYMBOLS, 4)
    assert _rel(got, want) < FLOAT_TOL
    assert _rel(got, beacon.tone_energies(x, 64)) < FLOAT_TOL


# ---- FSKDemod -------------------------------------------------------------------

@pytest.mark.parametrize("m_bits,k,bw", [(1, 8, 0.2), (2, 16, 0.25), (3, 32, 0.2)])
def test_fsk_demod_equals_jax(m_bits, k, bw):
    """FSKDemod symbols equal, uint32 as in the JAX package, through a
    Pipeline (two blocks, the last one trimmed)."""
    rng = np.random.default_rng(13)
    syms = rng.integers(0, 1 << m_bits, 300)
    x = _noisy(testsig.fsk_mod(syms, m_bits, k, bw), 0.3, 14)
    assert np.array_equal(demod_ops.fsk_tone_matrix(m_bits, k, bw),
                          j_demod.fsk_tone_matrix(m_bits, k, bw))
    sink = ct.CollectSink()
    ct.Pipeline(ct.chain(fsk_demodulator(m_bits, k, bw)), block_size=k * 128,
                device=CPU).run(iter([x]), sink)
    got = sink.concat()
    jsink = cs.CollectSink()
    cs.Pipeline(cs.chain(JFSKDemod(m_bits, k, bw)), block_size=k * 128,
                donate=False).run(iter([x]), jsink)
    want = np.asarray(jsink.concat())
    assert got.dtype == np.uint32 and want.dtype == np.uint32
    assert np.array_equal(got, want) and np.mean(got == syms) > 0.99
    assert FSKDemod(m_bits, k, bw).granule == k


# ---- golden anchors ---------------------------------------------------------------

@pytest.fixture(scope="module")
def gold():
    return np.load(GOLD)


def test_golden_coded_modem(gold):
    """tests/test_golden.py:141-149, byte-exact."""
    sym = (gold["in_modem_re"] + 1j * gold["in_modem_im"]).astype(np.complex64)
    got = modem.coded_packet_demodulate(sym, ms="qpsk", noise_var=0.25)
    assert got is not None
    assert np.array_equal(got, gold["modem_payload"]), "modem/FEC drifted"


def test_golden_beacon_decode(gold):
    """tests/test_golden.py:121-128, byte-exact."""
    noisy = (gold["in_beacon_re"] + 1j * gold["in_beacon_im"]).astype(np.complex64)
    got, info = beacon.beacon_decode(noisy, spsym=64)
    assert got is not None and info["crc_ok"]
    assert np.array_equal(got, gold["beacon_message"]), "beacon drifted"


def test_chip_smoke_beacon_set_decodes_as_jax():
    """The 32 beacons at −13 dB that chip_smoke.py decodes on the card
    (``torch_oracles.beacon_set``): the port decodes every one but those
    expected refused (the CRC refuses them: the mode's limit at this SNR),
    and on those and two decoded ones its result equals the JAX package's
    (message, offset, frequency bin, scores)."""
    import torch_oracles

    refused = []
    for i, (m, x) in enumerate(torch_oracles.beacon_set()):
        got, info = beacon.beacon_decode(x, spsym=64)
        if got is None:
            refused.append(i)
        else:
            assert np.array_equal(got, m), i
        if i in torch_oracles.BEACON_REFUSED or i < 2:
            want, jinfo = j_beacon.beacon_decode(x, spsym=64)
            assert info == jinfo and (got is None) == (want is None), i
    assert refused == torch_oracles.BEACON_REFUSED
