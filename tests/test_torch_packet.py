"""The port's packet protocol layers (models/hdlc, ais, aprs, adsb, pocsag,
rtty, morse) and the GMSK designs against the JAX package's functions on
the same numpy-seeded inputs.

Each case runs one host-side function (or a short chain of them) on both
sides and demands equal results: equal arrays (dtype aside where the JAX
function returns another integer width), equal message dicts, equal
text.  The GMSK pulse designs are held to 1e-12 (float64 design code)."""

import numpy as np
import pytest

from csdr_tpu.blocks import gmsk as j_gmsk
from csdr_tpu.models import adsb as j_adsb
from csdr_tpu.models import ais as j_ais
from csdr_tpu.models import aprs as j_aprs
from csdr_tpu.models import hdlc as j_hdlc
from csdr_tpu.models import morse as j_morse
from csdr_tpu.models import pocsag as j_pocsag
from csdr_tpu.models import rtty as j_rtty
from csdr_tpu.utils import firdes as j_firdes

from csdr_tpu_torch.blocks import gmsk as t_gmsk
from csdr_tpu_torch.models import adsb as t_adsb
from csdr_tpu_torch.models import ais as t_ais
from csdr_tpu_torch.models import aprs as t_aprs
from csdr_tpu_torch.models import hdlc as t_hdlc
from csdr_tpu_torch.models import morse as t_morse
from csdr_tpu_torch.models import pocsag as t_pocsag
from csdr_tpu_torch.models import rtty as t_rtty
from csdr_tpu_torch.utils import firdes as t_firdes

J = dict(hdlc=j_hdlc, ais=j_ais, aprs=j_aprs, adsb=j_adsb, pocsag=j_pocsag, rtty=j_rtty,
         morse=j_morse, gmsk=j_gmsk, firdes=j_firdes)
T = dict(hdlc=t_hdlc, ais=t_ais, aprs=t_aprs, adsb=t_adsb, pocsag=t_pocsag, rtty=t_rtty,
         morse=t_morse, gmsk=t_gmsk, firdes=t_firdes)


def _same(a, b):
    """Deep equality: arrays by value and shape, containers element-wise."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        assert np.array_equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


def _rng(seed):
    return np.random.default_rng(seed)


# ---- HDLC ------------------------------------------------------------------

def hdlc_crc(m):
    r = _rng(1)
    return [m["hdlc"].crc16_x25(bytes(r.integers(0, 256, n).tolist())) for n in (0, 1, 9, 64)]


def hdlc_nrzi(m):
    bits = _rng(2).integers(0, 2, 777).astype(np.uint8)
    enc = m["hdlc"].nrzi_encode(bits, start_level=1)
    return enc, m["hdlc"].nrzi_decode(enc)


def hdlc_stuffing(m):
    r = _rng(3)
    bits = "".join(r.choice(["0", "1", "1"], 600))
    s = m["hdlc"].stuff(bits)
    return s, m["hdlc"].destuff(s), m["hdlc"].destuff("0111111" + bits[:40])


def hdlc_frames_in_noise(m):
    r = _rng(4)
    payloads = [bytes(r.integers(0, 256, n).tolist()) for n in (3, 21, 40)]
    noise = lambda: r.integers(0, 2, 61).astype(np.uint8)  # noqa: E731
    levels = np.concatenate([noise()] + sum(([m["hdlc"].frame_to_wire_bits(p), noise()]
                                             for p in payloads), []))
    bad = levels.copy()
    bad[len(levels) // 2] ^= 1
    return levels, m["hdlc"].hdlc_frames(levels), m["hdlc"].hdlc_frames(bad)


def hdlc_sample_bits(m):
    r = _rng(5)
    score = np.repeat(r.choice([-1.0, 1.0], 300), 11) + 0.3 * r.normal(size=3300)
    return m["hdlc"].sample_bits(score[7:], 11)


# ---- AIS -------------------------------------------------------------------

def ais_payload(m):
    pb = [m["ais"].make_position_report(257123456, 59.91234, 10.75321, 14.2, 83.1),
          m["ais"].make_position_report(366998410, -33.85678, -151.21543, 0.3, 201.5, 3),
          m["ais"].make_position_report(1, 0.0, 0.0, msg_type=5)]
    return pb, [m["ais"].parse_payload(p) for p in pb], m["ais"].parse_payload("0" * 30)


def ais_bit_layer(m):
    reports = [m["ais"].make_position_report(200000000 + i, 10.0 * i, -20.0 * i, i, 3.0 * i)
               for i in range(4)]
    idle = np.array([0, 1] * 20, np.uint8)
    levels = np.concatenate([idle] + sum(([m["ais"].ais_burst_bits(p), idle]
                                          for p in reports), []))
    bad = levels.copy()
    bad[40 + 24 + 8 + 40] ^= 1  # the first report fails its CRC
    return levels, m["ais"].decode_bits(levels), m["ais"].decode_bits(bad)


# ---- AX.25 / APRS ----------------------------------------------------------

def ax25(m):
    frames = [m["aprs"].make_ax25_ui("N0CALL-7", "APRS", "!4903.50N/07201.75W-Test"),
              m["aprs"].make_ax25_ui("K1ABC", "BEACON", ">up", via=("WIDE1-1", "WIDE2-2"))]
    return (frames, [m["aprs"].parse_ax25(f) for f in frames], m["aprs"].parse_ax25(b"\x00" * 9),
            m["aprs"].aprs_burst_bits(frames[0]))


def afsk_tones(m):
    levels = _rng(6).integers(0, 2, 120).astype(np.uint8)
    return m["aprs"].afsk_modulate(levels, 48000.0)


def aprs_decode_score(m):
    frame = m["aprs"].make_ax25_ui("W1AW", "APRS", ">seeded")
    levels = np.concatenate([np.ones(30, np.uint8), m["aprs"].aprs_burst_bits(frame),
                             np.ones(30, np.uint8)])
    score = np.repeat(2.0 * levels - 1.0, 40) + 0.2 * _rng(7).normal(size=40 * len(levels))
    return m["aprs"].bits_from_score(score, 48000.0), m["aprs"].decode_score(score, 48000.0)


# ---- ADS-B -----------------------------------------------------------------

def adsb_frames(m):
    a = m["adsb"]
    icao = 0x4840D6
    frames = [a.make_es_ident(icao, "KLM1023"),
              a.make_es_position(icao, 52.2572, 3.91937, 38000, odd=False),
              a.make_es_position(icao, 52.2572, 3.91937, 38000, odd=True),
              a.make_es_velocity(icao, -120.0, 209.0, vrate_fpm=-640)]
    bad = frames[0].copy()
    bad[50] ^= 1
    msgs = [a.decode_frame(f) for f in frames]
    return frames, [a.crc24(f) for f in frames], msgs, a.decode_frame(bad), a.pair_positions(msgs)


@pytest.mark.parametrize("lat,lon", [(52.2572, 3.91937), (-33.86, 151.21), (0.5, -179.5),
                                     (86.9, 10.0)])
def test_cpr_codec_matches_jax(lat, lon):
    for odd in (False, True):
        assert t_adsb.cpr_encode(lat, lon, odd) == j_adsb.cpr_encode(lat, lon, odd)
    ye, xe = j_adsb.cpr_encode(lat, lon, False)
    yo, xo = j_adsb.cpr_encode(lat, lon, True)
    for newest_odd in (False, True):
        _same(t_adsb.cpr_global(ye, xe, yo, xo, newest_odd),
              j_adsb.cpr_global(ye, xe, yo, xo, newest_odd))


def adsb_ppm(m):
    a = m["adsb"]
    bits = a.make_es_velocity(0xABCDEF, 55.0, -180.0)
    env = a.adsb_modulate(bits, 4e6, amplitude=0.7)
    return env, a.to_iq(env, 0.3, 0.02)


def adsb_detect(m):
    a = m["adsb"]
    r = _rng(8)
    mag = np.abs(0.02 * r.normal(size=200)).astype(np.float32)
    for i in range(5):
        mag = np.concatenate([mag, a.adsb_modulate(a.make_es_ident(0x100000 + i, f"T{i}"), 2e6),
                              np.abs(0.02 * r.normal(size=80)).astype(np.float32)])
    tmpl = a._preamble_template(2)
    score = np.convolve(mag, tmpl[::-1])[:len(mag)]
    return a.detect_frames(mag, score, 2e6), a.decode_collected(np.zeros(0), 2e6)


# ---- POCSAG ----------------------------------------------------------------

def pocsag_bch(m):
    p = m["pocsag"]
    r = _rng(9)
    data = r.integers(0, 1 << 21, 6).tolist()
    cws = [p.bch_encode(d) for d in data]
    flips = [cw ^ (1 << int(r.integers(32))) ^ (1 << int(r.integers(32))) for cw in cws]
    return cws, [p.correct_codeword(c) for c in flips], p.correct_codeword(cws[0] ^ 0b10101)


def pocsag_bit_layer(m):
    p = m["pocsag"]
    gap = np.array([0, 1] * 300, np.uint8)
    lv = np.concatenate([p.make_transmission(1234568, "HELLO TPU-1!"), gap,
                         p.make_transmission(99, "0123*U-()9"), gap,
                         p.make_transmission(2000001, "73 42", fn=0)])
    bad = lv.copy()
    bad[600] ^= 1
    bad[610] ^= 1
    return lv, p.decode_bits(lv), p.decode_bits(1 - lv), p.decode_bits(bad)


def pocsag_fsk(m):
    p = m["pocsag"]
    lv = p.make_transmission(42, "PAGE")
    return p.pocsag_modulate(lv, 38400.0), p.pocsag_modulate(lv, 38400.0, invert=False)


def pocsag_score(m):
    p = m["pocsag"]
    lv = p.make_transmission(777, "SCORE")
    score = np.repeat(1.0 - 2.0 * lv, 32) + 0.3 * _rng(10).normal(size=32 * len(lv))
    return p.bits_from_score(score, 38400.0), p.decode_score(score, 38400.0)


def pocsag_channels(m):
    """Five channels, pages on 0, 2 and 3, the envelope gate open on 0 and 2
    only (channel 3's page is the leakage the gate holds back)."""
    p = m["pocsag"]
    r = _rng(11)
    rows = [np.repeat(1.0 - 2.0 * p.make_transmission(100 + c, f"CH {c}"), 16) for c in range(4)]
    n = max(map(len, rows))
    scores = np.stack([np.pad(x, (0, n - len(x))) for x in rows] + [r.normal(size=n)])
    scores += 0.2 * r.normal(size=(5, n))
    env = np.abs(r.normal(size=(5, n))) * np.array([[1.0], [0.05], [1.0], [0.05], [0.05]])
    return (p.decode_channels((scores, env), 19200.0),
            p.decode_channels(scores, 19200.0, min_snr=5.0))


# ---- RTTY / ITA2 -----------------------------------------------------------

def ita2(m):
    codes = m["rtty"].ita2_encode("CQ CQ DE TPU1 TPU1 599 73, ?()")
    return codes, m["rtty"].ita2_decode(codes + [31, 3, 27, 3])


def rtty_text(m):
    """The modulator, and the decoder on its exact-length level stream at
    22 samples per bit, with noise on the score."""
    audio = m["rtty"].rtty_modulate("RYRY 45", 2000.0)
    lv = [1] * 200
    for c in m["rtty"].ita2_encode("RYRY DE N0CLI 73"):
        lv += [0] * 22 + sum(([(c >> j) & 1] * 22 for j in range(5)), []) + [1] * 33
    score = np.asarray(lv + [1] * 200, np.float64) - 0.5
    score += 0.1 * _rng(15).normal(size=len(score))
    return audio, m["rtty"].decode_score(score, 1000.0)


def rtty_async_frames(m):
    """The asynchronous framing on a level stream with jitter: each bit's
    length is drawn around 22 samples."""
    r = _rng(12)
    lv = [1] * 60
    for c in m["rtty"].ita2_encode("TEST 123 RYRY"):
        lv += [0] * int(r.integers(21, 24))
        for j in range(5):
            lv += [(c >> j) & 1] * int(r.integers(21, 24))
        lv += [1] * int(r.integers(33, 40))
    score = np.asarray(lv, np.float64) - 0.5
    return m["rtty"].decode_score(score, 1000.0, baud=1000.0 / 22.0)


# ---- Morse -----------------------------------------------------------------

def _keyed(text: str, unit: int = 40) -> np.ndarray:
    key = [0] * 80
    for ch in text:
        if ch == " ":
            key += [0] * (4 * unit)
            continue
        for el in j_morse._CODE[ch]:
            key += [1] * (unit if el == "." else 3 * unit) + [0] * unit
        key += [0] * (2 * unit)
    return np.asarray(key, np.float64) + 0.05 * np.abs(_rng(13).normal(size=len(key)))


def morse_envelope(m):
    env = _keyed("CQ TPU 73")
    return (m["morse"].decode_envelope(env), m["morse"].decode_envelope(np.zeros(100)),
            m["morse"].decode_envelope(env, threshold=0.4))


# ---- GMSK designs and modulator ---------------------------------------------

def gmsk_modulator(m):
    bits = _rng(14).integers(0, 2, 90)
    return m["gmsk"].gmsk_mod(bits, 5, 3, 0.4), m["ais"].ais_modulate(bits, 4)


CASES = [hdlc_crc, hdlc_nrzi, hdlc_stuffing, hdlc_frames_in_noise, hdlc_sample_bits,
         ais_payload, ais_bit_layer, ax25, afsk_tones, aprs_decode_score, adsb_frames,
         adsb_ppm, adsb_detect, pocsag_bch, pocsag_bit_layer, pocsag_fsk, pocsag_score,
         pocsag_channels, ita2, rtty_text, rtty_async_frames, morse_envelope, gmsk_modulator]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_protocol_layer_matches_jax(case):
    _same(case(T), case(J))


@pytest.mark.parametrize("k,m,bt", [(5, 3, 0.4), (200, 3, 0.4), (4, 2, 0.3), (2, 4, 0.5)])
def test_gmsk_designs_match_jax(k, m, bt):
    for name in ("gmsk_tx", "gmsk_rx"):
        got, want = getattr(t_firdes, name)(k, m, bt), getattr(j_firdes, name)(k, m, bt)
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < 1e-12, name
    x = np.linspace(-3, 3, 101)
    assert np.max(np.abs(t_firdes.erf_vec(x) - j_firdes.erf_vec(x))) < 1e-12


def test_tables_and_constants_match_jax():
    assert t_morse.MORSE_TABLE == j_morse.MORSE_TABLE
    assert t_rtty._LETTERS == j_rtty._LETTERS and t_rtty._FIGURES == j_rtty._FIGURES
    assert (t_pocsag.SYNC, t_pocsag.IDLE, t_pocsag.POCSAG_BAUDS) == (
        j_pocsag.SYNC, j_pocsag.IDLE, j_pocsag.POCSAG_BAUDS)
    assert t_adsb._CALLSIGN_CS == j_adsb._CALLSIGN_CS
    assert np.array_equal(t_adsb._preamble_template(4), j_adsb._preamble_template(4))
    with pytest.raises(ValueError, match="ITA2"):
        t_rtty.ita2_encode("~")
