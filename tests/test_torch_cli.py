"""The port's soapy-sdr CLI on the CPU — the channelized NBFM, AGC and
raw-split flows, the single-channel and per-channel FIR demod flows
(DeCW, DeUSB/DeLSB, DeAM) with --offset and -b, the mixed sink (-m), the
broadcast flows (DeWBFM, DeFMS with --rds), and the file surface (mono WAV
input, AU output, --spectrum, --constellation, --play), held against the
JAX CLI on the same capture — the "pallas_fft_interpret" FIR strategy
against the JAX function of that name, and the package's independence from
JAX.

pfb_fused against eager: 2e-3 max from frame 1 for DeNBFM
(tests/test_pallas_fused.py:55); for the K4 flows, whose plain version on
the CPU is the eager channelizer's arithmetic, 2e-5 max-rel
(tests/test_golden.py).  Against the JAX CLI, relative to the largest
output: 2e-5 (tests/test_golden.py) where both run the same float32
arithmetic, 2e-3 where a long filter runs through FFTs of other
segmentations (tests/test_fir.py:36).  The plot scripts against the JAX
CLI's: 1e-4 of the largest value (the printed digits of two float32 orders)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from csdr_tpu.apps.soapy_sdr_cli import main as jax_main

from csdr_tpu_torch.apps.soapy_sdr_cli import main

torch.set_num_threads(1)

NCH = 8
N = NCH * 16 * 10 + 24  # ends mid-block: the last block is padded and trimmed
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def captures(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(N)
    iq = (0.5 * np.exp(2j * np.pi * np.mod(0.19 * t, 1.0))
          + 0.05 * (rng.normal(size=N) + 1j * rng.normal(size=N))).astype(np.complex64)
    cf32 = tmp_path / "cap.cf32"
    iq.tofile(cf32)
    cu8 = tmp_path / "cap.cu8"
    rng.integers(0, 256, 2 * N).astype(np.uint8).tofile(cu8)
    return {"cf32": str(cf32), "cu8": str(cu8)}


@pytest.mark.parametrize("ext,backend,fmt", [("cf32", "eager", "F32"), ("cf32", "fused", "WAV"),
                                             ("cu8", "eager", "WAV"), ("cu8", "fused", "F32"),
                                             ("cf32", "pfb_fused", "F32"),
                                             ("cu8", "pfb_fused", "WAV")])
def test_channelized_nbfm_flow_writes_one_file_per_channel(captures, tmp_path, ext, backend,
                                                           fmt):
    out = str(tmp_path / f"out_{backend}")
    rc = main(["--filename", captures[ext], "-n", str(N), "-c", str(NCH), "-o", out,
               "--blocksize", "512", "--demod", f"DeNBFM 0.6 {fmt}", "--backend", backend,
               "--device", "cpu"])
    assert rc == 0
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith(f"out_{backend}_ch"))
    suffix = ".f32" if fmt == "F32" else ".wav"
    assert files == sorted(f"out_{backend}_ch{i}{suffix}" for i in range(1, NCH + 1))
    header = 0 if fmt == "F32" else 44
    for f in files:
        assert os.path.getsize(tmp_path / f) == header + N // NCH * 4


def test_fused_and_eager_cli_outputs_agree(captures, tmp_path):
    outs = {}
    for backend in ("eager", "fused"):
        out = str(tmp_path / backend)
        assert main(["--filename", captures["cu8"], "-n", str(N), "-c", str(NCH), "-o", out,
                     "--blocksize", "1024", "--demod", "DeNBFM 0.6 F32",
                     "--backend", backend, "--device", "cpu"]) == 0
        outs[backend] = np.stack([np.fromfile(f"{out}_ch{i}.f32", np.float32)
                                  for i in range(1, NCH + 1)])
    # frame 0's demod seed differs by design (FMDemod starts from a unit sample)
    assert np.max(np.abs(outs["fused"][:, 1:] - outs["eager"][:, 1:])) < 1.2e-3


@pytest.mark.parametrize("extra", [["--mesh", "2x1", "--demod", "DeFMS 8 WAV"],
                                   ["--mesh", "2x1", "--demod", "DeNBFMSync 10",
                                    "--backend", "fused"],
                                   ["--devname", "synthetic", "--mesh", "2x1", "--demod",
                                    "DeFMS 8 WAV"]])
def test_unported_options_exit_nonzero(captures, tmp_path, extra, capsys):
    """An option set the JAX CLI refuses under --mesh is refused before its
    source opens, from a file or from an SDR device: DeFMS with -c N (exit
    1), the fused backend for DeNBFMSync (exit 2)."""
    args = ["--filename", captures["cf32"], "-c", str(NCH), "-o", str(tmp_path / "x"),
            "--demod", "DeNBFM 0.6 F32", "--device", "cpu"]
    if "--devname" in extra:
        args = args[2:]
    args += extra
    fused = "fused" in extra
    assert main(args) == (2 if fused else 1)
    err = capsys.readouterr().err
    assert ("--backend fused runs the whole channelized DeNBFM chain in one kernel" if fused
            else "DeFMS does not support channel splitting") in err
    assert "Traceback" not in err
    assert not any(f.startswith("x_ch") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("demod", ["DeRTTY 45.45", "DePOCSAG 1200", "DeADSB", "DeAIS",
                                   "DeAPRS 0.5"])
def test_packet_flows_refuse_channel_splitting_and_mesh(captures, tmp_path, demod, capsys):
    """The packet flows run on -c 1 only: -c N exits 1 with the JAX CLI's
    message, with or without --mesh (the mesh runs are in
    tests/test_torch_cli_mesh_packets.py)."""
    args = ["--filename", captures["cf32"], "-o", str(tmp_path / "x"), "--demod", demod,
            "--device", "cpu", "-c", str(NCH)]
    assert main(args) == 1
    assert f"{demod.split()[0]} does not support channel splitting" in capsys.readouterr().err
    assert main(args + ["--mesh", "2x1"]) == 1
    err = capsys.readouterr().err
    assert f"{demod.split()[0]} does not support channel splitting" in err
    assert "Traceback" not in err
    assert not any(f.startswith("x") for f in os.listdir(tmp_path))


def read_channels(prefix, ext, dtype, nch=NCH):
    return np.stack([np.fromfile(f"{prefix}_ch{i}.{ext}", dtype) for i in range(1, nch + 1)])


def test_pfb_fused_and_eager_cli_outputs_agree(captures, tmp_path):
    outs = {}
    for backend in ("eager", "pfb_fused"):
        out = str(tmp_path / backend)
        assert main(["--filename", captures["cf32"], "-n", str(N), "-c", str(NCH), "-o", out,
                     "--blocksize", "1024", "--demod", "DeNBFM 0.6 F32",
                     "--backend", backend, "--device", "cpu"]) == 0
        outs[backend] = read_channels(out, "f32", np.float32)
    assert outs["eager"].shape == (NCH, N // NCH)
    assert np.max(np.abs(outs["pfb_fused"][:, 1:] - outs["eager"][:, 1:])) < 2e-3


@pytest.fixture
def half_band_capture(tmp_path):
    """FM carriers on the even channels at −30 dB, the odd channels empty
    but for −100 dB of noise: far from the −60 dB squelch either way."""
    rng = np.random.default_rng(3)
    t = np.arange(N)
    x = 1e-5 * (rng.normal(size=N) + 1j * rng.normal(size=N))
    for k in range(0, NCH, 2):
        fc = (k - (NCH - 1) / 2) / NCH
        x += 0.03 * np.exp(1j * (2 * np.pi * np.mod(fc * t, 1.0)
                                 + 2.0 * np.sin(2 * np.pi * 0.004 * t)))
    path = tmp_path / "half.cf32"
    x.astype(np.complex64).tofile(path)
    return str(path)


def test_agc_squelch_flow_both_backends(half_band_capture, tmp_path):
    outs = {}
    for backend in ("eager", "pfb_fused"):
        out = str(tmp_path / backend)
        assert main(["--filename", half_band_capture, "-n", str(N), "-c", str(NCH), "-o", out,
                     "--blocksize", "1024", "--demod", "DeNBFM 0.6 F32", "-a", "-60",
                     "--backend", backend, "--device", "cpu"]) == 0
        for i in range(1, NCH + 1):
            assert os.path.getsize(f"{out}_ch{i}.f32") == N // NCH * 4
        outs[backend] = read_channels(out, "f32", np.float32)
    got, want = outs["pfb_fused"], outs["eager"]
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5
    assert not want[1::2].any()                           # squelched: all zeros
    assert np.all(np.abs(want[0::2]).max(axis=1) > 0.01)  # occupied: open


@pytest.mark.parametrize("ext", ["cf32", "cu8"])
@pytest.mark.parametrize("agc", [None, "-60"])
def test_raw_split_writes_cf32_channels(captures, tmp_path, ext, agc):
    nch = 4
    outs = {}
    for backend in ("eager", "pfb_fused"):
        out = str(tmp_path / backend)
        argv = ["--filename", captures[ext], "-n", str(N), "-c", str(nch), "-o", out,
                "--blocksize", "1024", "--demod", "DeNo", "--backend", backend,
                "--device", "cpu"]
        assert main(argv + (["-a", agc] if agc else [])) == 0
        for i in range(1, nch + 1):
            assert os.path.getsize(f"{out}_ch{i}.cf32") == N // nch * 8
        outs[backend] = read_channels(out, "cf32", np.complex64, nch)
    got, want = outs["pfb_fused"], outs["eager"]
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5
    if agc:  # the AGC brings every open channel to unit level
        assert abs(np.median(np.abs(want[:, N // nch // 2:])) - 1.0) < 0.2


@pytest.mark.parametrize("extra", [["-a", "-60"], ["--demod", "DeNo"],
                                   ["--demod", "DeCW 500 700 WAV"], ["-c", "1"]])
def test_fused_backend_refuses_agc_and_raw_flows(captures, tmp_path, extra, capsys):
    args = ["--filename", captures["cf32"], "-c", str(NCH), "-o", str(tmp_path / "x"),
            "--demod", "DeNBFM 0.6 F32", "--backend", "fused", "--device", "cpu"] + extra
    assert main(args) != 0
    assert "--backend pfb_fused" in capsys.readouterr().err
    assert not any(f.startswith("x_ch") for f in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def keyed_capture(tmp_path_factory):
    """Keyed CW carriers (just off the even channel centres of an 8-way
    split) and an FM carrier near 30 kHz, over noise; .cf32 and .cu8."""
    d = tmp_path_factory.mktemp("keyed")
    rng = np.random.default_rng(5)
    n = 8 * 1024 * 6 + 24
    t = np.arange(n)
    key = np.mod(t // 900, 3) != 2
    x = 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for k in range(0, 8, 2):
        x = x + 0.3 * key * np.exp(2j * np.pi * np.mod(((k - 3.5) / 8 + 4e-4) * t, 1.0))
    x = x + 0.3 * np.exp(1j * (2 * np.pi * np.mod(0.0117 * t, 1.0)
                               + 2 * np.sin(2 * np.pi * 7e-4 * t)))
    x = x.astype(np.complex64)
    x.tofile(d / "cap.cf32")
    q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 60 + 127.5), 0, 255)
    q.astype(np.uint8).tofile(d / "cap.cu8")
    return {"cf32": str(d / "cap.cf32"), "cu8": str(d / "cap.cu8"), "n": n}


def _outputs(prefix, nch, ext):
    names = [f"{prefix}.{ext}"] if nch == 1 else [f"{prefix}_ch{i}.{ext}"
                                                   for i in range(1, nch + 1)]
    if ext == "wav":
        return np.stack([wavfile.read(f)[1] for f in names])
    return np.stack([np.fromfile(f, np.complex64 if ext == "cf32" else np.float32)
                     for f in names])


# (argv, input, -n, output extension, bound, first output compared)
FLOWS = {
    "cw1": (["-c", "1", "--demod", "DeCW 500 700 WAV"], "cu8", None, "wav", 2e-3, 0),
    "am1_agc": (["-c", "1", "--demod", "DeAM WAV", "-a", "-60"], "cf32", None, "wav", 2e-5, 0),
    "usb1_offset": (["-c", "1", "--demod", "DeUSB 3000 WAV", "--offset", "25600"], "cf32",
                    None, "wav", 2e-3, 0),
    # the demod's first outputs see the resampler's near-zero start-up, where
    # atan2's branch is float32 rounding: compared from output 8
    "nbfm1_resampled": (["-c", "1", "--demod", "DeNBFM 0.6 WAV", "-b", "48000",
                         "--offset", "30000"], "cf32", 900, "wav", 2e-5, 8),
    "raw1_resampled": (["-c", "1", "--demod", "DeNo", "-b", "48000", "--offset", "30000"],
                       "cu8", 900, "cf32", 2e-5, 0),
    "cw8_agc": (["-c", "8", "--demod", "DeCW 500 700 F32", "-a", "-60"], "cu8", None, "f32",
                2e-3, 0),
    "lsb8": (["-c", "8", "--demod", "DeLSB 2000 WAV"], "cf32", None, "wav", 2e-3, 0),
    "am8_resampled": (["-c", "8", "--demod", "DeAM WAV", "-b", "1280000"], "cf32", 24000,
                      "wav", 2e-5, 0),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_flow_matches_jax_cli(keyed_capture, tmp_path, flow):
    argv, src, n, ext, bound, first = FLOWS[flow]
    n = n or keyed_capture["n"]
    nch = int(argv[1])
    common = ["--filename", keyed_capture[src], "-n", str(n), "--blocksize", "4096"]
    # the JAX CLI's "F32" audio is an AU file (ROADMAP Queue C): it writes WAV
    jargv = [a.replace("F32", "WAV") for a in argv]
    assert jax_main(common + jargv + ["-o", str(tmp_path / "j")]) == 0
    want = _outputs(str(tmp_path / "j"), nch, "wav" if ext == "f32" else ext)
    for backend in (["eager"] if nch == 1 else ["eager", "pfb_fused"]):
        out = str(tmp_path / backend)
        assert main(common + argv + ["-o", out, "--backend", backend, "--device", "cpu"]) == 0
        got = _outputs(out, nch, ext)
        assert got.shape == want.shape, (backend, got.shape, want.shape)
        err = np.max(np.abs(got[:, first:].astype(np.complex128) - want[:, first:]))
        assert err / np.max(np.abs(want)) < bound, (backend, err)


@pytest.fixture(scope="module")
def occupied_capture(tmp_path_factory):
    """An FM carrier on every channel centre of a 16-way split, each with
    its own tone, plus noise: no channel's magnitude nears zero, where
    atan2 would amplify float32 rounding."""
    d = tmp_path_factory.mktemp("occupied")
    nch, n = 16, 16 * 1024 * 3 + 40
    rng = np.random.default_rng(12)
    t = np.arange(n)
    x = 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for k in range(nch):
        ph = (2 * np.pi * np.mod((k - (nch - 1) / 2) / nch * t, 1.0)
              + 2.0 * np.sin(2 * np.pi * 0.0003 * (1 + k % 5) * t) + rng.uniform(0, 2 * np.pi))
        x = x + 0.15 * np.exp(1j * ph)
    x.astype(np.complex64).tofile(d / "occ.cf32")
    return {"path": str(d / "occ.cf32"), "n": n}


@pytest.mark.parametrize("extra", [["--demod", "DeNBFM 0.3 WAV"],
                                   ["--demod", "DeNBFM 0.3 F32", "-a", "-60"]])
def test_mix_flow_matches_jax_cli(occupied_capture, tmp_path, extra):
    """BASELINE config 4, -c 16 -m: the channels summed into one file, under
    eager and pfb_fused against the JAX CLI at 2e-5 relative
    (tests/test_golden.py), and equal to the sum of the same flow's
    per-channel files.  K3's demod history starts at zeros, so frame 0
    differs by design where pfb_fused runs DeNBFM without AGC."""
    nch = 16
    common = ["--filename", occupied_capture["path"], "-n", str(occupied_capture["n"]),
              "-c", str(nch), "--blocksize", "8192"]
    jargv = [a.replace("F32", "WAV") for a in extra]
    assert jax_main(common + ["-m", "-o", str(tmp_path / "j")] + jargv) == 0
    want = _outputs(str(tmp_path / "j"), 1, "wav")[0]
    ext = "f32" if "F32" in extra[1] else "wav"
    for backend in ("eager", "pfb_fused"):
        out = str(tmp_path / backend)
        argv = common + extra + ["--backend", backend, "--device", "cpu"]
        assert main(argv + ["-m", "-o", out]) == 0
        got = _outputs(out, 1, ext)[0]
        assert got.shape == want.shape == (occupied_capture["n"] // nch,)
        first = 1 if backend == "pfb_fused" and "-a" not in extra else 0
        err = np.max(np.abs(got[first:].astype(np.float64) - want[first:]))
        assert err / np.max(np.abs(want)) < 2e-5, (backend, err)
        assert main(argv + ["-o", out + "_split"]) == 0
        parts = _outputs(out + "_split", nch, ext).astype(np.float64).sum(axis=0)
        assert np.max(np.abs(got - parts)) / np.max(np.abs(parts)) < 1e-5


@pytest.fixture(scope="module")
def broadcast_capture(tmp_path_factory):
    """A stereo FM broadcast at 400 kS/s, 0.5 s: L and R tones, the 19 kHz
    pilot and RDS groups (PS "CSDR-TPU", PI 0x52D4), 75 kHz deviation."""
    from csdr_tpu_torch.models import rds

    d = tmp_path_factory.mktemp("broadcast")
    fs = 400000.0
    n = int(fs * 0.5)
    t = np.arange(n) / fs
    L, R = 0.6 * np.sin(2 * np.pi * 800 * t), 0.6 * np.sin(2 * np.pi * 2500 * t)
    pil = 2 * np.pi * 19000 * t + 0.7
    tx = rds.bits_from_groups([rds.make_group_0a(0x52D4, s, "CSDR-TPU"[2 * s:2 * s + 2])
                               for s in range(4)])
    bit = tx[np.floor(t * rds.RDS_BAUD).astype(np.int64) % len(tx)]
    half = np.floor(t * 2 * rds.RDS_BAUD).astype(np.int64) % 2
    lvl = (bit * 2.0 - 1.0) * np.where(half == 0, 1.0, -1.0)
    mpx = (0.45 * (L + R) + 0.1 * np.cos(pil) + 0.45 * (L - R) * np.cos(2 * pil)
           + 0.05 * lvl * np.cos(3 * pil))
    iq = np.exp(2j * np.pi * 75000 / fs * np.cumsum(mpx))
    iq += 0.01 * np.random.default_rng(11).normal(size=(n, 2)) @ np.array([1, 1j])
    iq.astype(np.complex64).tofile(d / "fm.cf32")
    return {"path": str(d / "fm.cf32"), "n": n // 2}


# (argv, output channels, compared from output)
BROADCAST = {
    "wbfm1": (["-c", "1", "--demod", "DeWBFM 8 WAV"], 1, 0),
    "wbfm4": (["-c", "4", "--demod", "DeWBFM 8 WAV"], 4, 0),
    "fms4_rds": (["-c", "1", "--demod", "DeFMS 4 WAV", "--rds"], 1, 0),
}


@pytest.mark.parametrize("flow", list(BROADCAST))
def test_broadcast_flow_matches_jax_cli(broadcast_capture, tmp_path, flow):
    """-s 400000 -b 200000: the front end, then DeWBFM (-c 1, and -c 4 under
    eager and pfb_fused) or DeFMS --rds, against the JAX CLI at 2e-5
    relative (tests/test_golden.py); the RDS report equal word for word."""
    argv, nch, first = BROADCAST[flow]
    common = ["--filename", broadcast_capture["path"], "-s", "400000", "-b", "200000",
              "-n", str(broadcast_capture["n"]), "--blocksize", "16000"]
    assert jax_main(common + argv + ["-o", str(tmp_path / "j")]) == 0
    want = _outputs(str(tmp_path / "j"), nch, "wav")
    for backend in (["eager"] if nch == 1 else ["eager", "pfb_fused"]):
        out = str(tmp_path / backend)
        assert main(common + argv + ["-o", out, "--backend", backend, "--device", "cpu"]) == 0
        got = _outputs(out, nch, "wav")
        assert got.shape == want.shape, (backend, got.shape, want.shape)
        err = np.max(np.abs(got[..., first:].astype(np.float64) - want[..., first:]))
        assert err / np.max(np.abs(want)) < 2e-5, (backend, err)
        if "--rds" in argv:
            assert got.shape[-1] == 2  # interleaved L/R frames
            report = open(out + ".rds.txt").read()
            assert report == open(str(tmp_path / "j") + ".rds.txt").read()
            assert "PS: CSDR-TPU" in report and "PI: 52D4" in report, report


def test_defms_refuses_channel_splitting(broadcast_capture, tmp_path, capsys):
    assert main(["--filename", broadcast_capture["path"], "-c", "4", "--demod", "DeFMS 4 WAV",
                 "-o", str(tmp_path / "x"), "--device", "cpu"]) != 0
    assert "channel splitting" in capsys.readouterr().err


@pytest.mark.parametrize("shape", ["real", "complex"])
def test_pallas_fft_interpret_strategy_matches_jax(shape):
    """conv_valid and FIRFilter accept "pallas_fft_interpret" and compute
    what the JAX conv_valid of that name does (K6 in interpret mode), at
    tests/test_fftfir.py:36's 2e-4 relative."""
    import jax.numpy as jnp
    from csdr_tpu.ops.fir import conv_valid as jax_conv_valid

    from csdr_tpu_torch.ops.fir import conv_valid
    from csdr_tpu_torch.blocks import FIRFilter

    rng = np.random.default_rng(4)
    K, n = 401, 20000
    if shape == "real":
        taps = rng.normal(size=K) / np.sqrt(K)
        xfull = rng.normal(size=n + K - 1).astype(np.float32)
    else:
        taps = np.hanning(K) * np.exp(2j * np.pi * 0.19 * np.arange(K)) / 40
        xfull = (rng.normal(size=n + K - 1) + 1j * rng.normal(size=n + K - 1)).astype(
            np.complex64)
    want = np.asarray(jax_conv_valid(jnp.asarray(xfull), taps, "pallas_fft_interpret"))
    got = conv_valid(torch.from_numpy(xfull), taps, "pallas_fft_interpret").numpy()
    scale = np.max(np.abs(want))
    assert got.shape == want.shape and np.max(np.abs(got - want)) / scale < 2e-4
    blk = FIRFilter(taps, complex_input=shape == "complex", strategy="pallas_fft_interpret")
    _, y = blk.apply(blk.init(torch.device("cpu")), torch.from_numpy(xfull[K - 1:]))
    y_jax = np.asarray(jax_conv_valid(jnp.asarray(np.concatenate(
        [np.zeros(K - 1, xfull.dtype), xfull[K - 1:]])), taps, "pallas_fft_interpret"))
    assert np.max(np.abs(y.numpy() - y_jax)) / np.max(np.abs(y_jax)) < 2e-4


@pytest.fixture(scope="module")
def mesh_captures(tmp_path_factory):
    """A 64-channel cu8 capture with an FM carrier on every channel centre
    (no channel's magnitude nears zero, where atan2 amplifies rounding), and
    an 8-channel cf32 capture with the even channels at −30 dB and the odd
    ones empty, ≥ 15 dB from a −48 dB squelch either way."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(31)
    n64 = 2 * 16384 + 520
    t = np.arange(n64)
    x = 0.005 * (rng.normal(size=n64) + 1j * rng.normal(size=n64))
    for k in range(64):
        x = x + 0.075 * np.exp(1j * (2 * np.pi * np.mod((k - 31.5) / 64 * t, 1.0)
                                     + 2.0 * np.sin(2 * np.pi * 3e-4 * (1 + k % 5) * t)
                                     + rng.uniform(0, 2 * np.pi)))
    q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 127.5 + 127.5), 0, 255)
    q.astype(np.uint8).tofile(d / "occ64.cu8")
    n8 = 3 * 4096 + 24
    t = np.arange(n8)
    x = 1e-5 * (rng.normal(size=n8) + 1j * rng.normal(size=n8))
    for k in range(0, 8, 2):
        x = x + 0.03 * np.exp(1j * (2 * np.pi * np.mod((k - 3.5) / 8 * t, 1.0)
                                    + 2.0 * np.sin(2 * np.pi * 0.004 * t)))
    x.astype(np.complex64).tofile(d / "half8.cf32")
    return {"fused": (str(d / "occ64.cu8"), n64), "pfb_fused": (str(d / "half8.cf32"), n8)}


# backend → (port argv, JAX argv; the blocks match: 16384 and 4096 samples)
MESH_FLOWS = {
    "fused": (["-c", "64", "--mesh", "2x1", "--backend", "fused", "--blocksize", "16384"],
              ["-c", "64", "--mesh", "2x1", "--blocksize", "16384"]),
    "pfb_fused": (["-c", "8", "--mesh", "2x2", "--backend", "pfb_fused", "-a", "-48",
                   "--blocksize", "4096"],
                  ["-c", "8", "--mesh", "2x2", "-a", "-48", "--blocksize", "4096"]),
}


@pytest.mark.parametrize("backend", list(MESH_FLOWS))
def test_mesh_flow_matches_jax_cli(mesh_captures, tmp_path, monkeypatch, backend):
    """--mesh on gloo ranks against the JAX CLI's --mesh files (its
    ShardedFlagship in interpret mode; its ShardedChannelizedFM with AGC):
    equal byte counts, and the samples within tests/test_sharded_flagship.py:
    61-66's bounds (fused) or tests/test_sharding.py:130's 5e-3 (AGC)."""
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")
    path, n = mesh_captures[backend]
    argv, jargv = MESH_FLOWS[backend]
    common = ["--filename", path, "-n", str(n), "--demod", "DeNBFM 0.6 WAV"]
    assert jax_main(common + jargv + ["-o", str(tmp_path / "j")]) == 0
    assert main(common + argv + ["-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    nch = int(argv[1])
    for i in range(1, nch + 1):
        assert (os.path.getsize(tmp_path / f"p_ch{i}.wav")
                == os.path.getsize(tmp_path / f"j_ch{i}.wav")), i
    got = _outputs(str(tmp_path / "p"), nch, "wav").astype(np.float64)
    want = _outputs(str(tmp_path / "j"), nch, "wav")
    assert got.shape == want.shape == (nch, n // nch)
    d = np.abs(got - want)
    if backend == "fused":
        assert float(np.mean(d > 0.01)) < 0.005, float(np.mean(d > 0.01))
        assert float(np.quantile(d, 0.99)) < 1e-4, float(np.quantile(d, 0.99))
    else:
        assert d.max() / np.abs(want).max() < 5e-3
        assert not want[1::2].any() and not got[1::2].any()   # the squelch holds


@pytest.mark.parametrize("extra,why", [
    (["--mesh", "64x1", "--device", "cuda"], "mesh 64x1: 64 ranks need 64 CUDA devices"),
    (["--mesh", "2x1", "--demod", "DeNBFMSync 10", "--blocksize", "1280"],
     "1 timing sub-windows cannot align with 2 time shards"),
    (["--mesh", "2x1", "--demod", "DeFMS 8 WAV"], "DeFMS does not support channel splitting"),
    (["--mesh", "2x2", "--backend", "fused"], "over time only"),
    (["--mesh", "2x3"], "does not split over 3 channel ranks"),
])
def test_mesh_refusals(captures, tmp_path, capsys, extra, why):
    args = ["--filename", captures["cf32"], "-c", str(NCH), "-o", str(tmp_path / "x"),
            "--demod", "DeNBFM 0.6 F32", "--device", "cpu"] + extra
    assert main(args) != 0
    assert why in capsys.readouterr().err
    assert not any(f.startswith("x") for f in os.listdir(tmp_path))


def test_dryrun_multichip_on_gloo_ranks():
    """One channelized step, two flagship steps and one ShardedChain step
    each of the WBFM, USB, multi-rate Tee and symbol-sync graphs on a 2x2
    mesh of four gloo ranks, shapes asserted in every rank."""
    from csdr_tpu_torch.parallel import dryrun_multichip

    out = dryrun_multichip(4, "cpu")
    chains = (((512,),), ((4096,),), ((512,), (2048,)), ((512,),))
    assert out == [((2, 2), (4, 40), (64, 32), chains)] * 4


def test_cuda_device_without_a_card_is_an_error(captures, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = main(["--filename", captures["cf32"], "-c", str(NCH), "-o", str(tmp_path / "x"),
               "--demod", "DeNBFM 0.6 F32", "--device", "cuda"])
    assert rc != 0
    assert not any(f.startswith("x_ch") for f in os.listdir(tmp_path))


def test_kernel_launch_tally_counts_the_eight_kernels():
    """``ops/cuda``'s launch tally, which the CLI's ``-v`` lines print and
    chip_smoke.py reads around every run: one count for each of the eight
    hand-written kernels, and ``reset_kernel_launches()`` sets every count
    to 0, the int counters and pfb_fused's dict alike."""
    from csdr_tpu_torch.ops import cuda
    from csdr_tpu_torch.ops.cuda import (fft_fir, fir_valid, flagship_fused, pfb_fused, pll_scan,
                                         symsync_block, symsync_scan)

    names = {"pfb_fm_fused", "pfb_channelize_fused", "flagship_fused", "fir_valid", "fft_fir",
             "pll_scan", "symsync_scan", "symsync_block"}
    saved = cuda.kernel_launches()
    assert set(saved) == names and len(saved) == 8
    try:
        fir_valid.launches += 3
        symsync_block.launches += 2
        pfb_fused.launches["pfb_channelize_fused"] += 5
        got = cuda.kernel_launches()
        assert got["fir_valid"] == saved["fir_valid"] + 3
        assert got["symsync_block"] == saved["symsync_block"] + 2
        assert got["pfb_channelize_fused"] == saved["pfb_channelize_fused"] + 5
        cuda.reset_kernel_launches()
        assert cuda.kernel_launches() == dict.fromkeys(names, 0)
    finally:
        for mod in (fft_fir, fir_valid, flagship_fused, pll_scan, symsync_block, symsync_scan):
            mod.launches = saved[mod.__name__.rsplit(".", 1)[1]]
        pfb_fused.launches.update({k: saved[k] for k in pfb_fused.launches})


def test_package_imports_without_jax():
    """Every module of csdr_tpu_torch (walked, not listed; csrc holds the
    CUDA sources) imports with ``jax`` made unimportable, and none of them
    loads jax or the JAX package."""
    code = textwrap.dedent("""
        import pkgutil, importlib, sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import csdr_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(csdr_tpu_torch.__path__,
                                                       "csdr_tpu_torch.")
                 if ".csrc" not in m.name]
        for name in names:
            importlib.import_module(name)
        for need in ("apps.helidecode", "models.symsync", "models.modem", "models.beacon",
                     "ops.fec", "models.pocsag", "apps.adsb_decode", "parallel.flagship",
                     "parallel.generic",
                     "io.rtl_tcp", "io.soapy", "io.native", "apps.rtl_tcp_server",
                     "utils.autotune", "utils.testsig"):
            assert "csdr_tpu_torch." + need in names, need
        bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
               or m.startswith(("jax.", "jaxlib")) or m == "csdr_tpu"
               or m.startswith("csdr_tpu.")]
        assert not bad, bad
        print("ok", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("ok "), r.stderr
    assert int(r.stdout.split()[1]) > 60


# ---- DeNBFMSync: FM demod + symbol sync → helidecode --------------------------

HELI_K = 10


def heli_fsk(nch: int, occupied: dict, n: int, seed: int) -> np.ndarray:
    """An nch-way capture with helicopter 2-FSK frames (tests/test_cli_apps.py:
    345-352; k = 10 at the channel rate, ±0.1 cycles/sample there) on the
    channels of ``occupied`` (channel → (start sample, fractional delay in
    input samples)), each on its channel centre, over weak noise."""
    from tests.test_torch_symsync import fractional_delay, heli_levels

    rng = np.random.default_rng(seed)
    x = 1e-3 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    t = np.arange(n)
    for ch, (start, delay) in occupied.items():
        lv = heli_levels(HELI_K, reps=12)
        inst = np.repeat(lv * 0.02 * HELI_K * 0.5 / nch, HELI_K * nch)[: n - start]
        fc = (ch - (nch - 1) / 2) / nch if nch > 1 else 0.0
        ph = 2 * np.pi * np.cumsum(inst)
        sig = np.zeros(n, np.complex128)
        sig[start:start + len(inst)] = fractional_delay(np.exp(1j * ph), delay)
        x = x + 0.5 * sig * np.exp(2j * np.pi * np.mod(fc * t, 1.0))
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def heli_captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("heli")
    one = heli_fsk(1, {0: (0, 0.0)}, 14 * 7100 * HELI_K // 10 + 3000, 31)
    four = heli_fsk(4, {0: (1200, 2.7), 2: (500, 13.1), 3: (3000, 29.4)}, 4 * 76800, 32)
    one.tofile(d / "one.cf32")
    four.tofile(d / "four.cf32")
    q = np.clip(np.round(np.stack([four.real, four.imag], 1) * 100 + 127.5), 0, 255)
    q.astype(np.uint8).tofile(d / "four.cu8")
    return {"one": str(d / "one.cf32"), "four": str(d / "four.cf32"),
            "four_cu8": str(d / "four.cu8"), "n_one": len(one), "n_four": len(four)}


def _run_with_ties(argv):
    """The port's CLI with every SymSync step's outputs of the other pick
    recorded (``torch_oracles.record_ties``): (rc, (nch, n) outputs)."""
    from torch_oracles import record_ties
    from tests.test_torch_symsync import TIE

    with record_ties(TIE) as rec:
        rc = main(argv)
    return rc, np.concatenate([np.atleast_2d(other) for _, other in rec], axis=-1)


def _heli_coords(path):
    from csdr_tpu_torch.apps import helidecode

    base = path[:-4]
    coords = helidecode.decode_file(path, base + ".kml", base + ".m")
    return ([(c.lat_deg, c.lat_min, c.lat_sec, c.lon_deg, c.lon_min, c.lon_sec)
             for c in coords], open(base + ".kml").read())


def test_denbfmsync_helicopter_chain_matches_jax(heli_captures, tmp_path):
    """The reference workflow (tests/test_cli_apps.py:339-368): 2-FSK capture
    → soapy-sdr "DeNBFMSync 10" → helidecode, the port's CLI and helidecode
    against the JAX CLI and the JAX helidecode: the same file length, the
    samples within 2e-3 (of either pick where float order picks), the same
    coordinates and the same KML text."""
    from csdr_tpu.apps import helidecode as j_heli
    from tests.test_torch_symsync import assert_sync_close

    common = ["--filename", heli_captures["one"], "-n", str(heli_captures["n_one"]),
              "--demod", f"DeNBFMSync {HELI_K}", "--blocksize", str(1 << 15)]
    assert jax_main(common + ["-o", str(tmp_path / "j")]) == 0
    rc, others = _run_with_ties(common + ["-o", str(tmp_path / "p"), "--device", "cpu"])
    assert rc == 0
    want = np.fromfile(tmp_path / "j.f32", np.float32)
    got = np.fromfile(tmp_path / "p.f32", np.float32)
    assert got.shape == want.shape == (heli_captures["n_one"] // HELI_K * 2,)
    assert_sync_close(got, others[0, :len(got)], want, "-c 1")
    coords, kml = _heli_coords(str(tmp_path / "p.f32"))
    jc = j_heli.decode_file(str(tmp_path / "j.f32"), str(tmp_path / "j.kml"),
                            str(tmp_path / "j.m"))
    assert coords == [(c.lat_deg, c.lat_min, c.lat_sec, c.lon_deg, c.lon_min, c.lon_sec)
                      for c in jc]
    assert len(coords) >= 10 and kml == open(tmp_path / "j.kml").read()
    assert abs(coords[0][0] + coords[0][1] / 60 + coords[0][2] / 3600
               - (52 + 30 / 60 + (45 / 100 * 60) / 3600)) < 1e-6


# (port argv, input, -a threshold); at the channelizer's output the occupied
# channels read −6 dB (cu8 −8), the empty one −46 (cu8 −43): ≥ 17 dB from
# a −25 dB squelch either way
SYNC_FLOWS = {
    "eager": (["--backend", "eager"], "four", None),
    "pfb_fused": (["--backend", "pfb_fused"], "four", None),
    "pfb_fused_cu8_agc": (["--backend", "pfb_fused"], "four_cu8", "-25"),
    "eager_agc": (["--backend", "eager"], "four", "-25"),
}


@pytest.mark.parametrize("flow", list(SYNC_FLOWS))
def test_denbfmsync_channelized_matches_jax(heli_captures, tmp_path, flow):
    """-c 4 "DeNBFMSync 10" under eager and pfb_fused (K4's plain version on
    the CPU), with and without -a, against the JAX CLI's files: every
    channel's length equal, the occupied channels within 2e-3 (of either
    pick where float order picks), helidecode's coordinates equal on every channel
    and none on the empty one."""
    from tests.test_torch_symsync import assert_sync_close

    extra, src, agc = SYNC_FLOWS[flow]
    common = ["--filename", heli_captures[src], "-n", str(heli_captures["n_four"]), "-c", "4",
              "--demod", f"DeNBFMSync {HELI_K}", "--blocksize", str(25600)]
    if agc:
        common += ["-a", agc]
    assert jax_main(common + ["-o", str(tmp_path / "j")]) == 0
    rc, others = _run_with_ties(common + extra + ["-o", str(tmp_path / "p"), "--device", "cpu"])
    assert rc == 0
    want = read_channels(str(tmp_path / "j"), "f32", np.float32, 4)
    got = read_channels(str(tmp_path / "p"), "f32", np.float32, 4)
    assert got.shape == want.shape == (4, heli_captures["n_four"] // 4 // HELI_K * 2)
    for ch in (0, 2, 3):
        assert_sync_close(got[ch], others[ch, :got.shape[1]], want[ch], f"{flow} channel {ch}")
    for ch in range(4):
        p, _ = _heli_coords(str(tmp_path / f"p_ch{ch + 1}.f32"))
        j, _ = _heli_coords(str(tmp_path / f"j_ch{ch + 1}.f32"))
        assert p == j and (len(p) >= 10 if ch != 1 else not p), (ch, len(p), len(j))
    if agc:
        assert not got[1].any() and not want[1].any()   # the squelch holds


def test_denbfmsync_front_end_matches_jax(heli_captures, tmp_path):
    """-c 1 --offset F -b B "DeNBFMSync 10": the front end tunes channel 2
    of the 4-way capture to DC and resamples it to a quarter rate, then the
    sync flow; the same samples (2e-3 of either pick) and coordinates."""
    from tests.test_torch_symsync import assert_sync_close

    fs = 2.56e6
    n = heli_captures["n_four"] // 4
    common = ["--filename", heli_captures["four"], "-s", str(fs), "--offset",
              str((2 - 1.5) / 4 * fs), "-b", str(fs / 4), "-n", str(n), "--demod",
              f"DeNBFMSync {HELI_K}", "--blocksize", str(1 << 14)]
    assert jax_main(common + ["-o", str(tmp_path / "j")]) == 0
    rc, others = _run_with_ties(common + ["-o", str(tmp_path / "p"), "--device", "cpu"])
    assert rc == 0
    want = np.fromfile(tmp_path / "j.f32", np.float32)
    got = np.fromfile(tmp_path / "p.f32", np.float32)
    assert got.shape == want.shape == (n // HELI_K * 2,)
    assert_sync_close(got, others[0, :len(got)], want, "--offset -b")
    p, _ = _heli_coords(str(tmp_path / "p.f32"))
    j, _ = _heli_coords(str(tmp_path / "j.f32"))
    assert p == j and len(p) >= 10


# ---- the file surface: WAV input, AU, --spectrum, --constellation, --play ----------

@pytest.fixture(scope="module")
def if_wav(tmp_path_factory):
    """A mono float32 WAV at 96 kHz (a sound-card IF recording): an FM
    carrier at every channel centre of an 8-way split of the IQ it lifts to
    (the Hilbert 2:1 then the mix by π put WAV frequency f at IQ frequency
    2f − 1/2), so no channel's magnitude nears zero where atan2 amplifies
    rounding, an AM carrier off DC, and noise; and a stereo WAV."""
    d = tmp_path_factory.mktemp("wav")
    rng = np.random.default_rng(21)
    n_iq = 8 * 1024 * 6 + 24
    t = np.arange(2 * n_iq)
    x = 0.003 * rng.normal(size=2 * n_iq)
    for k in range(8):
        f_iq = (k - 3.5) / 8
        ph = 2 * np.pi * np.mod((f_iq + 0.5) / 2 * t, 1.0) + 1.5 * np.sin(2 * np.pi * 2e-4 * (k + 1) * t)
        x += 0.08 * np.cos(ph + k)
    env = 1.0 + 0.5 * np.sin(2 * np.pi * 3e-4 * t)
    x += 0.05 * env * np.cos(2 * np.pi * np.mod((0.002 + 0.5) / 2 * t, 1.0))
    from csdr_tpu_torch.io.wav import write_wav

    write_wav(str(d / "if.wav"), x.astype(np.float32), 96000)
    write_wav(str(d / "st.wav"), np.zeros((256, 2), np.float32), 96000)
    return {"path": str(d / "if.wav"), "stereo": str(d / "st.wav"), "n": n_iq}


def _audio(prefix, nch, ext):
    from csdr_tpu_torch.io.wav import read_au

    names = [f"{prefix}.{ext}"] if nch == 1 else [f"{prefix}_ch{i}.{ext}"
                                                   for i in range(1, nch + 1)]
    if ext == "au":
        return np.stack([read_au(f)[0] for f in names])
    return _outputs(prefix, nch, ext)


# (argv, -n, output extension, backends: (name, compared from output, bound))
WAV_FLOWS = {
    "nbfm8_wav": (["-c", "8", "--demod", "DeNBFM 0.6 WAV"], None, "wav",
                  (("eager", 0, 2e-5), ("pfb_fused", 1, 2e-5))),
    "am1_au": (["-c", "1", "--demod", "DeAM AU"], None, "au", (("eager", 0, 2e-5),)),
    "am8_au_resampled": (["-c", "8", "--demod", "DeAM AU", "-b", "24000"], 12000, "au",
                         (("eager", 0, 2e-5), ("pfb_fused", 0, 2e-5))),
    "usb1_offset_au": (["-c", "1", "--demod", "DeUSB 3000 AU", "--offset", "-6000"], None,
                       "au", (("eager", 0, 2e-3),)),
}


@pytest.mark.parametrize("flow", list(WAV_FLOWS))
def test_wav_input_flow_matches_jax_cli(if_wav, tmp_path, flow):
    """A mono WAV in: the port's wav_iq_source (at --blocksize) and the
    flow, against the JAX CLI on the same file (its WAV source at
    2·--chunksize); AU output read back against the JAX CLI's AU files."""
    argv, n, ext, backends = WAV_FLOWS[flow]
    nch = int(argv[1])
    common = ["--filename", if_wav["path"], "-s", "48000", "-n", str(n or if_wav["n"]),
              "--blocksize", "4096"]
    assert jax_main(common + argv + ["-o", str(tmp_path / "j")]) == 0
    want = _audio(str(tmp_path / "j"), nch, ext)
    for backend, first, bound in backends:
        out = str(tmp_path / backend)
        assert main(common + argv + ["-o", out, "--backend", backend, "--device", "cpu"]) == 0
        got = _audio(out, nch, ext)
        assert got.shape == want.shape, (backend, got.shape, want.shape)
        err = np.max(np.abs(got[:, first:].astype(np.float64) - want[:, first:]))
        assert err / np.max(np.abs(want)) < bound, (backend, err)


def test_wav_input_fused_backend_holds_k1_bounds(if_wav, tmp_path):
    """-c 8 DeNBFM on the WAV through the fused backend (K1's plain version
    on the CPU) against eager: K1's 1.2e-3 max and 4e-5 RMS from frame 1
    (tests/test_flagship_fused_wide.py:66-67)."""
    outs = {}
    for backend in ("eager", "fused"):
        out = str(tmp_path / backend)
        assert main(["--filename", if_wav["path"], "-s", "48000", "-n", str(if_wav["n"]),
                     "-c", "8", "--blocksize", "4096", "--demod", "DeNBFM 0.6 F32",
                     "--backend", backend, "--device", "cpu", "-o", out]) == 0
        outs[backend] = read_channels(out, "f32", np.float32)
    d = outs["fused"][:, 1:].astype(np.float64) - outs["eager"][:, 1:]
    assert np.max(np.abs(d)) < 1.2e-3 and np.sqrt(np.mean(d ** 2)) < 4e-5


def test_wav_input_refuses_stereo(if_wav, tmp_path, capsys):
    assert main(["--filename", if_wav["stereo"], "-c", "1", "--demod", "DeAM WAV",
                 "-o", str(tmp_path / "x"), "--device", "cpu"]) == 1
    assert "only mono WAV supported" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def _plot_arrays(path):
    import re

    with open(path) as f:
        txt = f.read()
    if "f = [" in txt:
        return [np.array(txt.split(f"{k} = [")[1].split("];")[0].split(), float)
                for k in ("f", "p")]
    pts = re.findall(r"v\(end\+1\) = *(\S+) \+ j\* *(\S+);", txt)
    assert "print -dpng" in txt
    return [np.array(pts, float)]


@pytest.mark.parametrize("src", ["cu8", "wav"])
def test_spectrum_and_constellation_match_jax_cli(keyed_capture, if_wav, tmp_path, src):
    """--spectrum and --constellation (default names, and a given file) tap
    the IQ after the front end on the host: the scripts parse and their
    arrays are within 1e-4 of the JAX CLI's."""
    if src == "cu8":
        common = ["--filename", keyed_capture["cu8"], "-n", str(keyed_capture["n"]), "-c", "8",
                  "--demod", "DeNBFM 0.6 WAV"]
    else:
        common = ["--filename", if_wav["path"], "-s", "48000", "-n", "9000", "-b", "24000",
                  "-c", "1", "--demod", "DeAM WAV"]
    common += ["--blocksize", "4096"]
    for cli, name, extra in ((jax_main, "j", []), (main, "p", ["--device", "cpu"])):
        out = str(tmp_path / name)
        assert cli(common + extra + ["-o", out, "--spectrum", "--constellation",
                                     str(tmp_path / f"{name}_iq.m")]) == 0
    for want_f, got_f in (("j_spectrum.m", "p_spectrum.m"), ("j_iq.m", "p_iq.m")):
        for w, g in zip(_plot_arrays(tmp_path / want_f), _plot_arrays(tmp_path / got_f)):
            assert g.shape == w.shape and w.size > 0
            assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w))
    assert not os.path.exists(tmp_path / "p_constellation.m")


def test_play_tees_single_stream_audio(if_wav, tmp_path, capsys):
    """--play CMD feeds the player the file's samples as float32le PCM,
    within 2e-5 of what the JAX CLI plays from the same file; a split into
    files plays nothing and says so, as the JAX CLI does."""
    common = ["--filename", if_wav["path"], "-s", "48000", "-n", "9000"]
    for cli, name, extra in ((jax_main, "j", []), (main, "p", ["--device", "cpu"])):
        assert cli(common + extra + ["-c", "1", "--demod", "DeAM WAV",
                                     "-o", str(tmp_path / name),
                                     "--play", f"sh -c 'cat > {tmp_path / name}.raw'"]) == 0
        assert "--play ignored" not in capsys.readouterr().out
    from csdr_tpu_torch.io.wav import read_wav

    audio, rate = read_wav(str(tmp_path / "p.wav"))
    assert rate == 48000 and audio.size == 9000
    played = np.fromfile(tmp_path / "p.raw", np.float32)
    assert np.array_equal(played, audio)
    want = np.fromfile(tmp_path / "j.raw", np.float32)
    assert played.shape == want.shape
    assert np.max(np.abs(played - want)) / np.max(np.abs(want)) < 2e-5
    for cli, name, extra in ((jax_main, "jb", []), (main, "pb", ["--device", "cpu"])):
        assert cli(common + extra + ["-c", "8", "--demod", "DeAM WAV", "-o",
                                     str(tmp_path / name), "--play",
                                     f"sh -c 'cat > {tmp_path / name}.raw'"]) == 0
        assert "--play ignored: output is not a single audio stream" in capsys.readouterr().out
        assert not os.path.exists(tmp_path / f"{name}.raw")
