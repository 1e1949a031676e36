"""The port's SDR devices on the CPU: ``SdrSource``, ``SyntheticSdrSource``
and the driver registry (csdr_tpu_torch/io/sources.py), the SoapySDR shim
(io/soapy.py) against a fake ``SoapySDR`` module, ``utils/testsig``, and the
CLI's device path (``--devname synthetic | rtl_tcp | <SoapySDR driver>``)
against the JAX CLI on the same source.

The synthetic device and testsig are held to the JAX package's arrays
element for element.  The CLI flows, with the bounds tests/test_torch_cli.py
uses for the same flows from --filename: DeNo and eager DeNBFM 2e-5
relative to the largest output (tests/test_golden.py); the fused DeNBFM
(K1's plain version on the CPU) 1.2e-3 max and 4e-5 RMS from frame 1
(tests/test_flagship_fused_wide.py:66-67).  The synthetic device carries
four tones over noise, so on a 64-way split 60 channels hold noise alone,
where atan2 of a near-zero channel sample turns float32 rounding into any
error: there the JAX CLI is compared on the four occupied channels, and the
device run is held bit for bit to the port's own --filename run of the same
samples on every channel.  The rtl_tcp capture has a carrier on every
channel, and every channel is compared."""

import os
import socket
import sys
import types

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from csdr_tpu.apps.soapy_sdr_cli import main as jax_main
from csdr_tpu.io import sources as JSRC
from csdr_tpu.utils import testsig as jts

from csdr_tpu_torch.apps.soapy_sdr_cli import main
from csdr_tpu_torch.io import sources as SRC
from csdr_tpu_torch.io import soapy
from csdr_tpu_torch.io.rtl_tcp import RtlTcpServer
from csdr_tpu_torch.io.soapy import SoapySdrSource, register_if_available
from csdr_tpu_torch.utils import testsig

torch.set_num_threads(1)

N64 = 2 * 16384 + 520  # ends mid-block: the last block is padded and trimmed
TONES = (-0.3, -0.05, 0.1, 0.27)  # SyntheticSdrSource's default tones
OCCUPIED = np.rint(np.array(TONES) * 64 + 31.5).astype(int)  # their channels of 64


# ---- SdrSource, the synthetic device and the registry -------------------------

@pytest.mark.parametrize("kw", [dict(total_samples=300_000),
                                dict(total_samples=(1 << 17) * 2, seed=9, tones=(0.01,))])
def test_synthetic_source_equals_jax(kw):
    got = list(SRC.SyntheticSdrSource(**kw))
    want = list(JSRC.SyntheticSdrSource(**kw))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert all(c.dtype == np.complex64 for c in got)
    assert np.array_equal(np.concatenate(got), np.concatenate(want))


def test_sdr_source_ends_on_none_or_empty_and_closes():
    class Dev(SRC.SdrSource):
        def __init__(self, reads):
            self.reads, self.closed = list(reads), 0

        def read(self):
            return self.reads.pop(0)

        def close(self):
            self.closed += 1

    for end in (None, np.zeros(0, np.complex64)):
        d = Dev([np.ones(3, np.complex64), end, np.ones(2, np.complex64)])
        assert [len(c) for c in d] == [3] and d.closed == 1
    d = Dev([np.ones(4, np.complex64)] * 5)
    it = iter(d)
    next(it)
    it.close()  # a consumer that stops early (take_n) still closes the device
    assert d.closed == 1


def test_registry_enumerate_and_open():
    assert [d["driver"] for d in SRC.enumerate_devices()][:2] == ["synthetic", "rtl_tcp"]
    src = SRC.open_sdr("synthetic", 1e6, 90e6, 0.0, total_samples=1000)
    assert isinstance(src, SRC.SyntheticSdrSource) and src.frequency == 90e6
    with pytest.raises(KeyError, match="not found"):
        SRC.open_sdr("no_such_radio", 1e6, 90e6, 0.0)
    made = {}
    SRC.register_sdr_driver("unit_test_radio", lambda **kw: made.setdefault("kw", kw))
    try:
        SRC.open_sdr("unit_test_radio", 1e6, 91e6, 3.0, extra=1)
        assert made["kw"] == dict(sample_rate=1e6, frequency=91e6, gain=3.0, extra=1)
        assert {"driver": "unit_test_radio"} in SRC.enumerate_devices()
    finally:
        SRC._DRIVERS.pop("unit_test_radio", None)


# ---- testsig -------------------------------------------------------------------

def test_testsig_equals_jax():
    rng = np.random.default_rng(3)
    msg = rng.normal(size=4096).astype(np.float32)
    sym = rng.integers(0, 4, 300)
    pairs = [
        (testsig.tone(1000, 0.013, 1.0, 0.7, 0.3), jts.tone(1000, 0.013, 1.0, 0.7, 0.3)),
        (testsig.tone(999, 440.0, 8000.0, complex_out=False),
         jts.tone(999, 440.0, 8000.0, complex_out=False)),
        (testsig.fm_mod(msg, 0.05), jts.fm_mod(msg, 0.05)),
        (testsig.am_mod(msg, 0.8), jts.am_mod(msg, 0.8)),
        (testsig.am_mod(msg, 0.5, suppressed=True), jts.am_mod(msg, 0.5, suppressed=True)),
        (testsig.fsk_mod(sym, 2, 8, 0.1), jts.fsk_mod(sym, 2, 8, 0.1)),
        (testsig.awgn(testsig.fm_mod(msg, 0.05), 12.0),
         jts.awgn(jts.fm_mod(msg, 0.05), 12.0)),
        (testsig.awgn(msg, 3.0, np.random.default_rng(5)),
         jts.awgn(msg, 3.0, np.random.default_rng(5))),
    ]
    for k, (got, want) in enumerate(pairs):
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    ref = testsig.tone(5000, 0.01)
    test = np.roll(ref, 3) * 0.5 + testsig.awgn(ref, 30.0) * 0.01
    for kw in (dict(), dict(skip=7), dict(align=False), dict(scale=False)):
        assert testsig.snr_db(ref, test, **kw) == jts.snr_db(ref, test, **kw), kw


# ---- the SoapySDR shim against a fake module ------------------------------------

def _fake_soapy(mtu=4096, total=3 * 4096 + 100, devices=({"driver": "rtlsdr",
                                                          "serial": "0001"},)):
    """The Python binding's surface: Device (enumerate, configure, stream),
    StreamResult and the module constants."""
    mod = types.ModuleType("SoapySDR")
    mod.SOAPY_SDR_RX = 1
    mod.SOAPY_SDR_CF32 = "CF32"
    calls = {"devices": [], "closed": []}
    mod._calls = calls

    class StreamResult:
        def __init__(self, ret):
            self.ret = ret

    class Device:
        @staticmethod
        def enumerate():
            return list(devices)

        def __init__(self, args):
            self.args = dict(args)
            self.cfg = {}
            self.remaining = total
            self.n = 0
            calls["devices"].append(self)

        def setSampleRate(self, d, ch, v):
            self.cfg["samplerate"] = (d, ch, v)

        def setFrequency(self, d, ch, v):
            self.cfg["frequency"] = (d, ch, v)

        def setGain(self, d, ch, v):
            self.cfg["gain"] = (d, ch, v)

        def setGainMode(self, d, ch, on):
            self.cfg["agc"] = (d, ch, on)

        def setupStream(self, d, fmt, chans, args):
            self.cfg["stream"] = (d, fmt, tuple(chans), dict(args))
            return object()

        def activateStream(self, s):
            self.cfg["active"] = True

        def getStreamMTU(self, s):
            return mtu

        def readStream(self, s, bufs, num, timeoutUs=0):
            assert timeoutUs == 1_000_000  # the reference's 1 s timeout
            if self.remaining <= 0:
                return StreamResult(-1)  # a timeout ends the stream
            m = min(num, self.remaining)
            t = np.arange(self.n, self.n + m)
            bufs[0][:m] = np.exp(2j * np.pi * 0.125 * t).astype(np.complex64)
            self.n += m
            self.remaining -= m
            return StreamResult(m)

        def deactivateStream(self, s):
            self.cfg["active"] = False

        def closeStream(self, s):
            calls["closed"].append(self)

    mod.Device = Device
    return mod


def test_soapy_stream_protocol():
    mod = _fake_soapy()
    src = SoapySdrSource(2.56e6, 100e6, gain=20.0, driver="rtlsdr", _module=mod)
    dev = mod._calls["devices"][0]
    assert dev.args == {"driver": "rtlsdr"}
    assert dev.cfg["samplerate"] == (1, 0, 2.56e6) and dev.cfg["frequency"] == (1, 0, 100e6)
    assert dev.cfg["gain"] == (1, 0, 20.0) and "agc" not in dev.cfg
    assert dev.cfg["stream"][1] == "CF32" and dev.cfg["stream"][3] == {"buffers": "30"}
    assert src.mtu == 4096
    chunks = list(src)
    x = np.concatenate(chunks)
    assert x.dtype == np.complex64 and len(x) == 3 * 4096 + 100 and len(chunks[-1]) == 100
    # each read is a copy: the buffer the device fills is reused
    assert np.allclose(x, np.exp(2j * np.pi * 0.125 * np.arange(len(x))), atol=1e-5)
    assert dev.cfg["active"] is False and mod._calls["closed"] == [dev]


def test_soapy_gain_zero_is_agc():
    mod = _fake_soapy()
    SoapySdrSource(1e6, 90e6, gain=0.0, _module=mod)
    dev = mod._calls["devices"][0]
    assert dev.cfg["agc"] == (1, 0, True) and "gain" not in dev.cfg


@pytest.fixture
def fake_soapy_module(monkeypatch):
    """A fake SoapySDR in sys.modules; the drivers it registers in either
    package's registry are removed afterwards."""
    mod = _fake_soapy()
    monkeypatch.setitem(sys.modules, "SoapySDR", mod)
    try:
        yield mod
    finally:
        for reg in (SRC._DRIVERS, JSRC._DRIVERS):
            reg.pop("soapy", None)
            reg.pop("rtlsdr", None)


def test_registry_integration(fake_soapy_module):
    assert register_if_available()
    devs = [d["driver"] for d in SRC.enumerate_devices()]
    assert "soapy" in devs and "rtlsdr" in devs
    src = SRC.open_sdr("rtlsdr", 1e6, 90e6, 10.0)
    assert isinstance(src, SoapySdrSource)
    assert sum(len(c) for c in src) == 3 * 4096 + 100


def test_without_soapy_module_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "SoapySDR", None)  # import SoapySDR fails
    assert not soapy.available() and not register_if_available()
    assert soapy.enumerate_soapy_devices() == []
    with pytest.raises(RuntimeError, match="SoapySDR is not importable"):
        SoapySdrSource(1e6, 90e6, _module=None)


def test_soapy_int_return_and_mtu_fallback():
    """Bindings whose readStream returns an int and whose MTU reads 0."""
    mod = _fake_soapy(mtu=0, total=5000)
    orig_read = mod.Device.readStream
    mod.Device.readStream = lambda self, s, bufs, num, timeoutUs=0: int(
        orig_read(self, s, bufs, num, timeoutUs).ret)
    src = SoapySdrSource(1e6, 90e6, _module=mod)
    assert src.mtu == 1 << 17
    assert sum(len(c) for c in src) == 5000


def test_soapy_close_is_idempotent_and_survives_errors():
    mod = _fake_soapy(total=10)
    src = SoapySdrSource(1e6, 90e6, _module=mod)
    dev = mod._calls["devices"][0]

    def boom(s):
        raise RuntimeError("device unplugged")

    dev.deactivateStream = boom
    src.close()   # the teardown's errors are ignored
    src.close()   # a second close does nothing
    assert src.read() is None and mod._calls["closed"] == [dev]


def test_cli_default_device_is_the_soapy_rtlsdr(fake_soapy_module, tmp_path, capsys):
    """Without --filename and --devname the CLI opens SoapySDR's rtlsdr, as
    the JAX CLI does: the same DeNo file from the same fake device."""
    n = 3 * 4096 + 100
    common = ["-s", "1e6", "-f", "90e6", "-g", "12", "-n", str(n), "--blocksize", "4096"]
    assert jax_main(common + ["-o", str(tmp_path / "j")]) == 0
    assert main(common + ["-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert "Using device: rtlsdr" in capsys.readouterr().out
    devs = fake_soapy_module._calls["devices"]
    assert len(devs) == 2 and devs[1].cfg["gain"] == (1, 0, 12.0)
    assert devs[1].cfg["frequency"] == (1, 0, 90e6)
    want = np.fromfile(tmp_path / "j.cf32", np.complex64)
    got = np.fromfile(tmp_path / "p.cf32", np.complex64)
    assert got.shape == want.shape == (n,)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-5


# ---- the CLI's device path against the JAX CLI ---------------------------------

@pytest.fixture(scope="module")
def occupied_cu8(tmp_path_factory):
    """A 64-channel cu8 capture with an FM carrier on every channel centre."""
    rng = np.random.default_rng(41)
    t = np.arange(N64)
    x = 0.005 * (rng.normal(size=N64) + 1j * rng.normal(size=N64))
    for k in range(64):
        x = x + 0.075 * np.exp(1j * (2 * np.pi * np.mod((k - 31.5) / 64 * t, 1.0)
                                     + 2.0 * np.sin(2 * np.pi * 3e-4 * (1 + k % 5) * t)
                                     + rng.uniform(0, 2 * np.pi)))
    q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 127.5 + 127.5), 0, 255)
    path = tmp_path_factory.mktemp("dev") / "occ64.cu8"
    q.astype(np.uint8).tofile(path)
    return str(path)


def _read(prefix, nch, ext):
    names = [f"{prefix}.{ext}"] if nch == 1 else [f"{prefix}_ch{i}.{ext}"
                                                   for i in range(1, nch + 1)]
    if ext == "wav":
        return np.stack([wavfile.read(f)[1] for f in names]).astype(np.float64)
    return np.stack([np.fromfile(f, np.complex64) for f in names]).astype(np.complex128)


# flow → (argv, nch, output extension, port backends)
DEVICE_FLOWS = {
    "deno1": (["-c", "1", "--demod", "DeNo"], 1, "cf32", ("eager",)),
    "nbfm64": (["-c", "64", "--demod", "DeNBFM 0.6 WAV"], 64, "wav", ("eager", "fused")),
}


@pytest.mark.parametrize("flow", list(DEVICE_FLOWS))
@pytest.mark.parametrize("device", ["synthetic", "rtl_tcp"])
def test_device_flow_matches_jax_cli(occupied_cu8, tmp_path, monkeypatch, device, flow):
    argv, nch, ext, backends = DEVICE_FLOWS[flow]
    common = ["--devname", device, "-s", "2.56e6", "-f", "100e6", "-n", str(N64),
              "--blocksize", "16384", *argv]
    srv = None
    if device == "rtl_tcp":
        # every client (the JAX CLI's, then each of the port's) gets the capture anew
        u8 = np.fromfile(occupied_cu8, np.uint8).reshape(-1, 2)
        srv = RtlTcpServer(lambda: iter([u8[:10_000], u8[10_000:]]))
        monkeypatch.setenv("CSDR_RTLTCP_ADDR", f"127.0.0.1:{srv.port}")
    try:
        assert jax_main(common + ["-o", str(tmp_path / "j")]) == 0
        outs = {}
        for backend in backends:
            out = str(tmp_path / backend)
            assert main(common + ["-o", out, "--backend", backend, "--device", "cpu"]) == 0
            outs[backend] = _read(out, nch, ext)
    finally:
        if srv is not None:
            srv.close()
    want = _read(str(tmp_path / "j"), nch, ext)
    rows = OCCUPIED if device == "synthetic" and nch == 64 else slice(None)
    for backend, got in outs.items():
        assert got.shape == want.shape == (nch, N64 // nch), backend
        if backend == "fused":  # frame 0's demod seed differs by design
            d = np.abs(got[rows, 1:] - want[rows, 1:])
            assert d.max() < 1.2e-3 and np.sqrt(np.mean(d ** 2)) < 4e-5, (d.max(), backend)
        else:
            err = np.max(np.abs(got[rows] - want[rows]))
            assert err / np.max(np.abs(want[rows])) < 2e-5, (err, backend)
    if device == "synthetic":
        # the device path adds nothing: the same samples from a file, bit for bit
        iq = np.concatenate(list(SRC.SyntheticSdrSource(2.56e6, total_samples=N64)))
        iq.tofile(tmp_path / "syn.cf32")
        for backend, got in outs.items():
            out = str(tmp_path / f"file_{backend}")
            assert main(["--filename", str(tmp_path / "syn.cf32"), "-n", str(N64),
                         "--blocksize", "16384", *argv, "-o", out, "--backend", backend,
                         "--device", "cpu"]) == 0
            assert np.array_equal(_read(out, nch, ext), got), backend


def _closed_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


@pytest.mark.parametrize("case", ["no_devices", "not_found", "failed_to_open"])
def test_device_failures_match_jax_cli(tmp_path, monkeypatch, capsys, case):
    """"No SDR devices detected", "Device X not found" and "Failed to open
    device X: …", then "Unable to open source", exit 1: the JAX CLI's lines
    (on stdout there; the port prints the failures on stderr)."""
    argv = ["-n", "4096", "-o", str(tmp_path / "x")]
    if case == "no_devices":
        monkeypatch.setattr(SRC, "_DRIVERS", {})
        monkeypatch.setattr(JSRC, "_DRIVERS", {})
        monkeypatch.setitem(sys.modules, "SoapySDR", None)
    elif case == "not_found":
        argv += ["--devname", "no_such_radio"]
    else:
        monkeypatch.setenv("CSDR_RTLTCP_ADDR", f"127.0.0.1:{_closed_port()}")
        argv += ["--devname", "rtl_tcp"]
    assert jax_main(argv) == 1
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 1
    got = capsys.readouterr()
    assert got.out + got.err == want
    assert want.endswith("Unable to open source\n")
    assert not os.listdir(tmp_path)


def test_mesh_flow_from_a_device_equals_its_file_run(tmp_path, capfd):
    """--mesh 2x1 --backend fused on gloo ranks from the synthetic device:
    rank 0 alone opens it (one "Using device" line), and the files equal
    the same mesh run from the device's samples saved as CF32."""
    iq = np.concatenate(list(SRC.SyntheticSdrSource(2.56e6, total_samples=N64)))
    iq.tofile(tmp_path / "syn.cf32")
    common = ["-n", str(N64), "-c", "64", "--mesh", "2x1", "--backend", "fused", "--demod",
              "DeNBFM 0.6 F32", "--blocksize", "16384", "--device", "cpu"]
    assert main(["--devname", "synthetic", "-s", "2.56e6", *common,
                 "-o", str(tmp_path / "d")]) == 0
    assert capfd.readouterr().out.count("Using device: synthetic") == 1  # the ranks' fds
    assert main(["--filename", str(tmp_path / "syn.cf32"), *common,
                 "-o", str(tmp_path / "f")]) == 0
    for i in range(1, 65):
        d = np.fromfile(tmp_path / f"d_ch{i}.f32", np.float32)
        assert d.shape == (N64 // 64,) and np.array_equal(d, np.fromfile(tmp_path / f"f_ch{i}.f32",
                                                                          np.float32)), i
