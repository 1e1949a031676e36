"""The port's CLI with ``--mesh 2x1`` for DeFMS --rds and the five packet
flows (DeAIS, DeAPRS, DeADSB, DePOCSAG, DeRTTY) on gloo ranks, against the
serial CLI's files: the stereo WAV within 2e-3 relative to its largest
sample (tests/test_sharding_generic.py:60) and the ``.rds.txt`` equal
(tests/test_rds.py:147); each packet flow's ``.txt`` byte for byte, every
injected message in it.  The flows run through the CLI's own rank function
(``_mesh_rank``) on one module-scoped pair of ranks while this process runs
the serial CLI, and DeAIS once more whole through ``main`` (the parent's
static check, then ``spawn``).  The captures come from the port's own
transmitters, seeded, as tests/test_torch_packet_flows.py makes them from
the JAX ones; the ranks import this module, so it imports no JAX."""

import concurrent.futures
import os

import numpy as np
import pytest
import scipy.signal as sig
import torch

from csdr_tpu_torch.apps import soapy_sdr_cli as cli
from csdr_tpu_torch.models import adsb, ais, aprs, pocsag, rds, rtty
from csdr_tpu_torch.parallel import spawn

torch.set_num_threads(1)

QUAD = 192000.0
RDS_PI, RDS_PS = 0x52D4, "CSDR-TPU"
RTTY_TEXT = "RYRY DE N0CLI 599"
WANT = {"DeAIS": "mmsi 257123456", "DeAPRS": "N0CALL-7>APRS:!4903.50N/07201.75W-Test",
        "DeADSB": "ident KLM1023", "DePOCSAG": "RIC 1234568 fn 3 [alpha] TPU PAGER OK",
        "DeRTTY": RTTY_TEXT}


def _noise(n, seed, sigma, cplx=True):
    r = np.random.default_rng(seed)
    if cplx:
        return (sigma * (r.normal(size=n) + 1j * r.normal(size=n))).astype(np.complex64)
    return (sigma * r.normal(size=n)).astype(np.float32)


def _stereo_rds_iq(n):
    """FM of the stereo composite with RDS groups 0A (tests/test_rds.py:43,
    :147): L 800 Hz, R 2500 Hz, the pilot, RDS_PI and RDS_PS."""
    t = np.arange(n) / QUAD
    left, right = 0.6 * np.sin(2 * np.pi * 800.0 * t), 0.6 * np.sin(2 * np.pi * 2500.0 * t)
    pil = 2 * np.pi * 19000.0 * t + 0.7
    x = 0.45 * (left + right) + 0.1 * np.cos(pil) + 0.45 * (left - right) * np.cos(2 * pil)
    tx = rds.bits_from_groups([rds.make_group_0a(RDS_PI, s, RDS_PS[2 * s:2 * s + 2])
                               for s in range(4)])
    bit = np.floor(t * rds.RDS_BAUD).astype(np.int64) % len(tx)
    half = np.floor(t * 2 * rds.RDS_BAUD).astype(np.int64) % 2
    x = x + 0.12 * (tx[bit] * 2.0 - 1.0) * np.where(half == 0, 1.0, -1.0) * np.cos(3 * pil)
    return np.exp(1j * np.cumsum(2 * np.pi * 0.8 * 0.25 * x)).astype(np.complex64)


def _ais_levels(reports, idle_bits=40):
    idle = np.array([0, 1] * (idle_bits // 2), np.uint8)
    return np.concatenate([idle] + sum(([ais.ais_burst_bits(
        ais.make_position_report(*r)), idle] for r in reports), []))


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """One capture per flow: name → (file, CLI arguments); the packet ones
    as tests/test_torch_packet_flows.py:329 makes them."""
    d = tmp_path_factory.mktemp("mesh_flows")
    caps = {}
    n = 10 * 6144 * 4
    _stereo_rds_iq(n).tofile(d / "fms.cf32")
    caps["DeFMS --rds"] = (d / "fms.cf32", ["-s", str(QUAD), "-n", str(n), "--demod",
                                            "DeFMS 4 WAV", "--rds", "--blocksize", "61440"])
    reports = [(257123456, 59.91234, 10.75321, 14.2, 83.1),
               (366998410, -33.85678, 151.21543, 0.3, 201.5, 3)]
    iq = ais.ais_modulate(_ais_levels(reports), 10).astype(np.complex64)
    iq = np.concatenate([_noise(6, 6, 0.02), iq + _noise(len(iq), 7, 0.02)])
    t = np.arange(len(iq))
    iq = iq * np.exp(2j * np.pi * np.mod(12000.0 / 96000.0 * t, 1.0))
    q = np.clip(np.round(np.stack([iq.real, iq.imag], 1) * 100 + 127.5), 0, 255)
    q.astype(np.uint8).tofile(d / "ais.cu8")
    caps["DeAIS"] = (d / "ais.cu8", ["-s", "96000", "--offset", "12000", "-b", "48000",
                                     "-n", str(len(iq) // 2), "--demod", "DeAIS"])
    frames = [aprs.make_ax25_ui("N0CALL-7", "APRS", "!4903.50N/07201.75W-Test"),
              aprs.make_ax25_ui("K1ABC", "BEACON", ">status ok", via=("WIDE1-1",))]
    idle = np.ones(96, np.uint8)
    levels = np.concatenate([idle] + sum(([aprs.aprs_burst_bits(f), idle] for f in frames),
                                         []))
    audio = aprs.afsk_modulate(levels, 48000.0)
    audio = audio + _noise(len(audio), 8, 0.05, cplx=False)
    iq = np.exp(1j * 2 * np.pi * 0.5 * np.cumsum(audio * 0.4)).astype(np.complex64)
    iq.tofile(d / "aprs.cf32")
    caps["DeAPRS"] = (d / "aprs.cf32", ["-s", "48000", "-n", str(len(iq)), "-a", "-80",
                                        "--demod", "DeAPRS 0.5"])
    icao = 0x4840D6
    bursts = [adsb.make_es_ident(icao, "KLM1023"),
              adsb.make_es_position(icao, 52.2572, 3.91937, 38000, odd=False),
              adsb.make_es_position(icao, 52.2572, 3.91937, 38000, odd=True),
              adsb.make_es_velocity(icao, 120.0, 209.0, vrate_fpm=640)]
    gap = np.zeros(80, np.float32)
    mag = np.concatenate([gap] + sum(([adsb.adsb_modulate(f, 2e6), gap] for f in bursts), []))
    iq = adsb.to_iq(mag)
    iq = iq + _noise(len(iq), 9, 0.02)
    iq.tofile(d / "adsb.cf32")
    caps["DeADSB"] = (d / "adsb.cf32", ["-s", "2000000", "-n", str(len(iq)),
                                        "--demod", "DeADSB"])
    lv = np.concatenate([pocsag.make_transmission(1234568, "TPU PAGER OK"),
                         np.array([0, 1] * 200, np.uint8),
                         pocsag.make_transmission(2000001, "73 42", fn=0)])
    iq = pocsag.pocsag_modulate(lv, 38400.0)
    iq = iq + _noise(len(iq), 10, 0.05)
    iq.tofile(d / "pocsag.cf32")
    caps["DePOCSAG"] = (d / "pocsag.cf32", ["-s", "38400", "-n", str(len(iq)),
                                            "--demod", "DePOCSAG 1200"])
    audio = rtty.rtty_modulate(RTTY_TEXT, 8000.0).astype(np.float64)
    iq = (0.5 * sig.hilbert(audio)).astype(np.complex64) + _noise(len(audio), 2, 0.01)
    iq.tofile(d / "rtty.cf32")
    caps["DeRTTY"] = (d / "rtty.cf32", ["-s", "8000", "-n", str(len(iq)), "--demod", "DeRTTY"])
    return caps


def _argv(caps, name, out):
    path, argv = caps[name]
    block = [] if "--blocksize" in argv else ["--blocksize", "4096"]
    return ["--filename", str(path), *block, *argv, "-o", out, "--device", "cpu"]


def _mesh_flows(device, caps, outdir):
    """One gloo rank: every flow through the CLI's rank function on a 2x1
    mesh, as ``_run_mesh`` spawns it."""
    torch.set_num_threads(1)
    for name in caps:
        opts = cli.build_parser().parse_args(
            _argv(caps, name, os.path.join(outdir, f"mesh_{name.split()[0]}"))
            + ["--mesh", "2x1"])
        demod = cli.parse_demod(opts.demod)
        cli._mesh_rank(device, opts, demod, opts.agc if opts.agc != 0.0 else None)
    return True


@pytest.fixture(scope="module")
def runs(captures, tmp_path_factory):
    """The mesh ranks in a thread while the serial CLI writes each flow's
    files here; returns the directory."""
    outdir = str(tmp_path_factory.mktemp("mesh_flows_out"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        mesh = pool.submit(spawn, _mesh_flows, 2, "cpu", (captures, outdir), 300.0)
        for name in captures:
            assert cli.main(_argv(captures, name, os.path.join(
                outdir, f"serial_{name.split()[0]}"))) == 0, name
        mesh.result()
    return outdir


def test_defms_rds_mesh_matches_serial_cli(runs):
    """DeFMS 4 --rds: the Tee of the stereo panel and the RDS bits, each leaf
    gathered by its own layout; the 2-channel WAV within 2e-3 of the serial
    one, the decoded station equal."""
    def wav(k):
        return np.fromfile(os.path.join(runs, f"{k}_DeFMS.wav"), "<f4", offset=44)

    serial, mesh = wav("serial"), wav("mesh")
    # n / 4 frames and the group-delay line's flush (18 frames), interleaved
    assert serial.shape == mesh.shape == (2 * (10 * 6144 * 4 // 4 + 18),)
    assert np.abs(mesh - serial).max() / np.abs(serial).max() < 2e-3
    txt = {k: open(os.path.join(runs, f"{k}_DeFMS.rds.txt")).read() for k in ("serial", "mesh")}
    assert txt["mesh"] == txt["serial"]
    assert f"PI: {RDS_PI:04X}" in txt["mesh"] and f"PS: {RDS_PS}" in txt["mesh"]


@pytest.mark.parametrize("kind", list(cli.PACKET_SUFFIX))
def test_packet_flow_mesh_txt_equals_serial_cli(runs, kind):
    """The packet receiver over 2x1 (no DC blocker, as serial), rank 0
    decoding the collected output: its .txt byte for byte the serial one."""
    suffix = cli.PACKET_SUFFIX[kind]
    got, want = (open(os.path.join(runs, f"{k}_{kind}{suffix}")).read()
                 for k in ("mesh", "serial"))
    assert got == want
    assert WANT[kind] in got


def test_packet_mesh_main_prints_the_serial_lines(captures, runs, tmp_path, capfd):
    """DeAIS whole through ``main`` on 2x1: the parent validates the graph
    and spawns the ranks; rank 0 prints the decoded lines, then ``N
    message(s)``, as the serial CLI prints them, and writes the same
    .ais.txt."""
    out = str(tmp_path / "m")
    assert cli.main(_argv(captures, "DeAIS", out) + ["--mesh", "2x1", "-v"]) == 0
    stdout = capfd.readouterr().out
    want = open(os.path.join(runs, "serial_DeAIS.ais.txt")).read()
    assert open(out + ".ais.txt").read() == want
    lines, got = want.splitlines(), stdout.splitlines()
    end = got.index(f"{len(lines)} message(s)")
    assert lines and got[end - len(lines):end] == lines
    assert "ShardedChain" in stdout and stdout.count("Kernel launches on rank") == 2
