"""The port's packet receivers on the CPU against the JAX package: the
device chains (GMSK, the AFSK discriminator for APRS and RTTY, the POCSAG
discriminator, the ADS-B envelope Tee, the CW envelope and the POCSAG band
monitor) on the same numpy-seeded captures, JAX state handed over
mid-stream, the tree-aware ``CollectSink``, the CLI's packet flows (their
``.txt`` files byte for byte against the JAX CLI's; the refusals are in
tests/test_torch_cli.py) and the four offline decoders.

Tolerances: GMSK bit levels and the golden ``ais_levels`` anchor
byte-exact (tests/test_golden.py:91); float scores and magnitudes 2e-5
relative to the largest output (tests/test_golden.py); bits and decoded
messages exactly equal."""

import os

import numpy as np
import pytest
import scipy.signal as sig
import torch

import jax
import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.apps import adsb_decode as j_adsb_app
from csdr_tpu.apps import ais_decode as j_ais_app
from csdr_tpu.apps import aprs_decode as j_aprs_app
from csdr_tpu.apps import pocsag_decode as j_pocsag_app
from csdr_tpu.apps.soapy_sdr_cli import main as jax_main
from csdr_tpu.blocks.gmsk import GMSKDemod as JGMSKDemod
from csdr_tpu.models import adsb as j_adsb
from csdr_tpu.models import ais as j_ais
from csdr_tpu.models import aprs as j_aprs
from csdr_tpu.models import morse as j_morse
from csdr_tpu.models import pocsag as j_pocsag
from csdr_tpu.models import rtty as j_rtty

import csdr_tpu_torch as ct
from csdr_tpu_torch.apps import adsb_decode, ais_decode, aprs_decode, pocsag_decode
from csdr_tpu_torch.apps.soapy_sdr_cli import main
from csdr_tpu_torch.blocks.gmsk import GMSKDemod
from csdr_tpu_torch.core.block import PerChannel
from csdr_tpu_torch.models import adsb, ais, aprs, morse, pocsag, rtty
from csdr_tpu_torch.utils.convert import from_jax_chain_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-5
GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden_anchors.npz")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _noise(n, seed, sigma, cplx=True):
    r = np.random.default_rng(seed)
    if cplx:
        return (sigma * (r.normal(size=n) + 1j * r.normal(size=n))).astype(np.complex64)
    return (sigma * r.normal(size=n)).astype(np.float32)


def run_port(graph, x, block):
    sink = ct.CollectSink()
    ct.Pipeline(graph, block_size=block, device=CPU).run(iter([x]), sink, num_samples=len(x))
    return sink.concat()


def run_jax(graph, x, block):
    sink = cs.CollectSink()
    cs.Pipeline(graph, block_size=block, donate=False).run(iter([x]), sink,
                                                           num_samples=len(x))
    return jax.tree.map(np.asarray, sink.concat())


# ---- captures, made from a numpy seed with the JAX package's transmitters ---

def ais_levels(reports, idle_bits=40):
    idle = np.array([0, 1] * (idle_bits // 2), np.uint8)
    return np.concatenate([idle] + sum(([j_ais.ais_burst_bits(
        j_ais.make_position_report(*r)), idle] for r in reports), []))


AIS_REPORTS = [(257123456, 59.91234, 10.75321, 14.2, 83.1),
               (366998410, -33.85678, 151.21543, 0.3, 201.5, 3)]


def ais_iq(k, seed=1, noise=0.02):
    iq = j_ais.ais_modulate(ais_levels(AIS_REPORTS), k).astype(np.complex64)
    return iq + _noise(len(iq), seed, noise)


def aprs_audio(fs=48000.0, seed=1):
    frames = [j_aprs.make_ax25_ui("N0CALL-7", "APRS", "!4903.50N/07201.75W-Test"),
              j_aprs.make_ax25_ui("K1ABC", "BEACON", ">status ok", via=("WIDE1-1",))]
    idle = np.ones(96, np.uint8)
    levels = np.concatenate([idle] + sum(([j_aprs.aprs_burst_bits(f), idle]
                                          for f in frames), []))
    audio = j_aprs.afsk_modulate(levels, fs)
    return audio + _noise(len(audio), seed, 0.05, cplx=False)


def pocsag_iq(fs=38400.0, seed=5):
    lv = np.concatenate([j_pocsag.make_transmission(1234568, "TPU PAGER OK"),
                         np.array([0, 1] * 200, np.uint8),
                         j_pocsag.make_transmission(2000001, "73 42", fn=0)])
    iq = j_pocsag.pocsag_modulate(lv, fs)
    return iq + _noise(len(iq), seed, 0.05)


def adsb_iq(seed=1, noise=0.02, gap_us=40):
    icao = 0x4840D6
    frames = [j_adsb.make_es_ident(icao, "KLM1023"),
              j_adsb.make_es_position(icao, 52.2572, 3.91937, 38000, odd=False),
              j_adsb.make_es_position(icao, 52.2572, 3.91937, 38000, odd=True),
              j_adsb.make_es_velocity(icao, 120.0, 209.0, vrate_fpm=640)]
    gap = np.zeros(gap_us * 2, np.float32)
    mag = np.concatenate([gap] + sum(([j_adsb.adsb_modulate(f, 2e6), gap] for f in frames), []))
    iq = j_adsb.to_iq(mag)
    return iq + _noise(len(iq), seed, noise)


RTTY_TEXT = "RYRY DE N0CLI 599"


def rtty_audio(fs=8000.0):
    audio = j_rtty.rtty_modulate(RTTY_TEXT, fs)
    return audio + _noise(len(audio), 3, 0.1, cplx=False)


def rtty_usb_iq(fs=8000.0):
    audio = j_rtty.rtty_modulate(RTTY_TEXT, fs).astype(np.float64)
    return (0.5 * sig.hilbert(audio)).astype(np.complex64) + _noise(len(audio), 2, 0.01)


# ---- device chains ---------------------------------------------------------

@pytest.fixture(scope="module")
def gold():
    if not os.path.exists(GOLD):
        pytest.skip("golden anchors not generated")
    return np.load(GOLD)


def test_golden_ais_levels_anchor(gold):
    """tests/test_golden.py:86-94: the GMSK chain's levels byte for byte,
    block 4096·5, and both reports decoded."""
    lv = run_port(ais.ais_receiver(48000.0), gold["in_ais_iq"], 4096 * 5)
    assert lv.dtype == np.uint8
    assert np.array_equal(lv, gold["ais_levels"])
    assert [m["mmsi"] for m in ais.decode_bits(lv)] == [257123456, 366998410]


@pytest.mark.parametrize("k,block", [(2, 2 * 300), (5, 5 * 333), (10, 4096 * 10)])
def test_gmsk_levels_and_messages_equal_jax(k, block):
    iq = ais_iq(k, seed=k)
    got = run_port(ais.ais_receiver(9600.0 * k), iq, block)
    want = run_jax(j_ais.ais_receiver(9600.0 * k), iq, block)
    assert np.array_equal(got, want)
    msgs = ais.decode_bits(got)
    assert msgs == j_ais.decode_bits(want) and len(msgs) == 2


def test_gmsk_demod_per_channel_panel():
    """Inside PerChannel the demod strides along the last axis: three
    channels at once equal three single-channel runs."""
    k = 4
    rows = np.stack([ais_iq(k, seed=s) for s in range(3)])
    dm = GMSKDemod(3, k, 0.4)
    pc = PerChannel(dm, 3)
    _, panel = pc.apply(pc.init(CPU), torch.from_numpy(rows))
    assert panel.shape == (3, rows.shape[1] // k) and panel.dtype == torch.uint8
    for c in range(3):
        _, one = dm.apply(dm.init(CPU), torch.from_numpy(rows[c]))
        assert torch.equal(panel[c], one)


def _scores(name):
    """(port graph, JAX graph, input, block, host decode) of each float
    score chain."""
    if name == "afsk1200":
        return (aprs.afsk1200_receiver(48000.0), j_aprs.afsk1200_receiver(48000.0),
                aprs_audio(), 1 << 12,
                lambda s, mod: mod.decode_score(s, 48000.0))
    if name == "rtty":
        return (rtty.rtty_receiver(8000.0), j_rtty.rtty_receiver(8000.0),
                rtty_audio(), 1 << 13, lambda s, mod: mod.decode_score(s, 8000.0))
    return (pocsag.pocsag_receiver(38400.0), j_pocsag.pocsag_receiver(38400.0), pocsag_iq(),
            1 << 14, lambda s, mod: mod.decode_score(s, 38400.0))


@pytest.mark.parametrize("name,mods", [("afsk1200", (aprs, j_aprs)), ("rtty", (rtty, j_rtty)),
                                       ("pocsag", (pocsag, j_pocsag))])
def test_scores_match_jax(name, mods):
    tg, jg, x, block, decode = _scores(name)
    got, want = run_port(tg, x, block), run_jax(jg, x, block)
    assert got.dtype == np.float32
    assert _rel(got, want) < TOL
    msgs = decode(got, mods[0])
    assert msgs == decode(want, mods[1]) and msgs


def test_adsb_magnitude_and_correlation_match_jax():
    iq = adsb_iq()
    got, want = run_port(adsb.adsb_receiver(2e6), iq, 4096), run_jax(j_adsb.adsb_receiver(2e6),
                                                                    iq, 4096)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL
    msgs = adsb.pair_positions(adsb.decode_collected(got, 2e6))
    assert msgs == j_adsb.pair_positions(j_adsb.decode_collected(want, 2e6)) and len(msgs) == 4


def test_cw_envelope_matches_jax():
    fs, unit = 8000.0, 480
    key = np.repeat(np.array([0, 1, 0, 1, 1, 1, 0, 0, 0, 1, 0, 1, 0, 0, 0], np.float32), unit)
    iq = key.astype(np.complex64) + _noise(len(key), 4, 0.03)
    got = run_port(morse.cw_envelope(100.0 / fs), iq, 1 << 12)
    want = run_jax(j_morse.cw_envelope(100.0 / fs), iq, 1 << 12)
    assert _rel(got, want) < TOL
    assert morse.decode_envelope(got) == j_morse.decode_envelope(want) == "AI"


BAND_PAGES = {1: (100001, "CH ONE"), 4: (200002, "CH FOUR"), 6: (300003, "1234 5")}


@pytest.fixture(scope="module")
def band():
    """Three pages on three carriers of an 8-channel band at 24 kHz per
    channel (tests/test_pocsag.py:111-145)."""
    nch, rate = 8, 24000.0
    streams = {ch: j_pocsag.pocsag_modulate(j_pocsag.make_transmission(ric, text), rate)
               for ch, (ric, text) in BAND_PAGES.items()}
    n = max(len(b) for b in streams.values()) * nch
    t = np.arange(n)
    x = 0.01 * (np.random.default_rng(3).normal(size=n)
                + 1j * np.random.default_rng(4).normal(size=n))
    for ch, bb in streams.items():
        fc = (ch - (nch - 1) / 2) / nch
        x = x + 0.5 * np.repeat(bb, nch)[:n] * np.exp(2j * np.pi * np.mod(fc * t, 1.0))
    return nch, rate, x.astype(np.complex64)


def test_band_monitor_eager_matches_jax(band):
    nch, rate, x = band
    g = pocsag.pocsag_band_monitor(nch, rate)
    block = g.granule * 256
    got = run_port(g, x, block)
    want = run_jax(j_pocsag.pocsag_band_monitor(nch, rate), x, block)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (nch, len(x) // nch)
        assert _rel(a, b) < TOL
    msgs = pocsag.decode_channels(got, rate)
    assert msgs == j_pocsag.decode_channels(want, rate)
    assert {m["channel"]: (m["ric"], m["text"]) for m in msgs} == BAND_PAGES


def test_band_monitor_pfb_fused_matches_eager(band):
    """backend="pfb_fused" (K4's plain version on the CPU) against eager:
    the branch trims keep both leaves at n/nch, the pages land on the same
    channels."""
    nch, rate, x = band
    g = pocsag.pocsag_band_monitor(nch, rate, backend="pfb_fused")
    assert g.granule == nch * 64
    got = run_port(g, x, g.granule * 8)
    want = run_port(pocsag.pocsag_band_monitor(nch, rate), x, g.granule * 8)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (nch, len(x) // nch)
        assert _rel(a, b) < TOL
    assert pocsag.decode_channels(got, rate) == pocsag.decode_channels(want, rate)


def _handover(jg, tg, blocks, at):
    js, ts = jg.init(), tg.init(CPU)
    outs = []
    for i, blk in enumerate(blocks):
        if i == at:
            ts = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        outs.append((ty, jy))
    return outs


@pytest.mark.parametrize("name", ["gmsk", "afsk", "adsb_tee"])
def test_state_handover_from_jax(name):
    """The port takes a JAX block's state mid-stream and continues within
    the chain's bounds: GMSK bits equal, AFSK score and the ADS-B Tee's
    leaves within 2e-5."""
    if name == "gmsk":
        jg, tg, x = JGMSKDemod(3, 5, 0.4), GMSKDemod(3, 5, 0.4), ais_iq(5)[:2700]
    elif name == "afsk":
        jg, tg = j_aprs.AFSKDiscriminator(48000.0, 40), aprs.AFSKDiscriminator(48000.0, 40)
        x = aprs_audio()[:12000]
    else:
        jg, tg, x = j_adsb.adsb_receiver(2e6), adsb.adsb_receiver(2e6), adsb_iq()[:1350]
    for ty, jy in _handover(jg, tg, np.split(x, 3), at=1):
        if name == "gmsk":
            assert np.array_equal(ty.numpy(), np.asarray(jy))
        elif name == "afsk":
            assert _rel(ty, jy) < TOL
        else:
            for a, b in zip(ty, jy):
                assert _rel(a, b) < TOL


def test_collect_sink_on_a_tee_equals_jax():
    x = adsb_iq()
    port, jsink = ct.CollectSink(), cs.CollectSink()
    ct.Pipeline(adsb.adsb_receiver(2e6), 1000, device=CPU).run(iter([x]), port)
    cs.Pipeline(j_adsb.adsb_receiver(2e6), 1000, donate=False).run(iter([x]), jsink)
    got, want = port.concat(), jsink.concat()
    assert isinstance(got, tuple) and len(port.parts) == len(jsink.parts) > 1
    for a, b in zip(got, jax.tree.leaves(want)):
        assert isinstance(a, np.ndarray) and a.shape == np.asarray(b).shape
        assert _rel(a, b) < TOL
    empty = ct.CollectSink()
    ct.Pipeline(adsb.adsb_receiver(2e6), 1000, device=CPU).run(iter([x[:0]]), empty)
    assert isinstance(empty.concat(), np.ndarray) and empty.concat().shape == (0,)
    assert adsb.decode_collected(empty.concat(), 2e6) == []


# ---- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def packet_captures(tmp_path_factory):
    """One capture per packet flow: (file, CLI arguments)."""
    d = tmp_path_factory.mktemp("packet")
    caps = {}
    # AIS: 96 kS/s cu8, the burst 12 kHz above the tuning: --offset, -b 48000;
    # 6 leading samples put the half-band's 12-sample delay (at 48 kHz) on
    # the slicer's symbol grid (k = 5)
    iq = np.concatenate([_noise(6, 6, 0.02), ais_iq(10, seed=7)])
    t = np.arange(len(iq))
    iq = iq * np.exp(2j * np.pi * np.mod(12000.0 / 96000.0 * t, 1.0))
    q = np.clip(np.round(np.stack([iq.real, iq.imag], 1) * 100 + 127.5), 0, 255)
    q.astype(np.uint8).tofile(d / "ais.cu8")
    caps["DeAIS"] = (d / "ais.cu8", ["-s", "96000", "--offset", "12000", "-b", "48000",
                                     "-n", str(len(iq) // 2), "--demod", "DeAIS"])
    # APRS: NBFM at 48 kHz (kf 0.5), with an AGC in front
    audio = aprs_audio(seed=8)
    iq = np.exp(1j * 2 * np.pi * 0.5 * np.cumsum(audio * 0.4)).astype(np.complex64)
    iq.tofile(d / "aprs.cf32")
    caps["DeAPRS"] = (d / "aprs.cf32", ["-s", "48000", "-n", str(len(iq)), "-a", "-80",
                                        "--demod", "DeAPRS 0.5"])
    iq = adsb_iq(seed=9)
    iq.tofile(d / "adsb.cf32")
    caps["DeADSB"] = (d / "adsb.cf32", ["-s", "2000000", "-n", str(len(iq)), "--demod", "DeADSB"])
    iq = pocsag_iq(seed=10)
    iq.tofile(d / "pocsag.cf32")
    caps["DePOCSAG"] = (d / "pocsag.cf32", ["-s", "38400", "-n", str(len(iq)),
                                            "--demod", "DePOCSAG 1200"])
    iq = rtty_usb_iq()
    iq.tofile(d / "rtty.cf32")
    caps["DeRTTY"] = (d / "rtty.cf32", ["-s", "8000", "-n", str(len(iq)), "--demod", "DeRTTY"])
    return caps


SUFFIX = {"DeAIS": ".ais.txt", "DeAPRS": ".aprs.txt", "DeADSB": ".adsb.txt",
          "DePOCSAG": ".pocsag.txt", "DeRTTY": ".rtty.txt"}
WANT = {"DeAIS": "mmsi 257123456", "DeAPRS": "N0CALL-7>APRS:!4903.50N/07201.75W-Test",
        "DeADSB": "ident KLM1023", "DePOCSAG": "RIC 1234568 fn 3 [alpha] TPU PAGER OK",
        "DeRTTY": RTTY_TEXT}


@pytest.mark.parametrize("kind", list(SUFFIX))
def test_packet_flow_txt_equals_jax_cli(packet_captures, tmp_path, kind, capsys):
    path, argv = packet_captures[kind]
    common = ["--filename", str(path), "--blocksize", "4096"] + argv
    assert jax_main(common + ["-o", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out
    assert main(common + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    want = (tmp_path / f"j{SUFFIX[kind]}").read_bytes()
    got = (tmp_path / f"t{SUFFIX[kind]}").read_bytes()
    assert got == want
    assert WANT[kind] in got.decode()
    lines = got.decode().splitlines()
    # the decoded lines, then "N message(s)", as the JAX CLI prints them
    assert tout.splitlines()[-len(lines) - 1:] == jout.splitlines()[-len(lines) - 1:]
    assert tout.splitlines()[-1] == f"{len(lines)} message(s)"


# ---- the offline decoders ---------------------------------------------------

@pytest.mark.parametrize("app", ["ais", "aprs", "adsb", "pocsag"])
def test_offline_decoder_prints_jax_lines(tmp_path, app, capsys):
    if app == "ais":
        ais_iq(5, seed=11).tofile(tmp_path / "in.cf32")
        mods, argv = (ais_decode, j_ais_app), [str(tmp_path / "in.cf32"), "-s", "48000"]
    elif app == "aprs":
        aprs_audio(seed=12).tofile(tmp_path / "in.f32")
        mods, argv = (aprs_decode, j_aprs_app), [str(tmp_path / "in.f32"), "-s", "48000"]
    elif app == "adsb":
        adsb_iq(seed=13).tofile(tmp_path / "in.cf32")
        mods, argv = (adsb_decode, j_adsb_app), [str(tmp_path / "in.cf32"), "-s", "2e6"]
    else:
        pocsag_iq(seed=14).tofile(tmp_path / "in.cf32")
        mods, argv = (pocsag_decode, j_pocsag_app), [str(tmp_path / "in.cf32")]
    assert mods[1].main(argv + ["-o", str(tmp_path / "j.out"), "--blocksize", "4096"]) == 0
    want = capsys.readouterr().out
    assert mods[0].main(argv + ["-o", str(tmp_path / "t.out"), "--blocksize", "4096",
                                "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and int(got.splitlines()[-1].split()[0]) > 0
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()


def test_packet_modules_import_without_jax():
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import csdr_tpu_torch.models
        from csdr_tpu_torch.apps import ais_decode, aprs_decode, adsb_decode, pocsag_decode
        from csdr_tpu_torch.blocks import gmsk
        bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
               or m.startswith(("jax.", "jaxlib")) or m == "csdr_tpu"
               or m.startswith("csdr_tpu.")]
        assert not bad, bad
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
