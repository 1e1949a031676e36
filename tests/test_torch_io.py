"""The port's file surface on the CPU against the JAX package: the WAV and AU
codecs (float32, int16 and int32 PCM), the header-only ``probe_wav``,
``raw_bytes_source``, ``wav_iq_source`` (and its refusal of a WAV of more
than one channel), the Hilbert real ↔ complex blocks, ``FIRInterp``,
``fir_filter_rnyquist``, the four FIR designs, and every sink of
``io/sinks.py`` as ``tests/test_io.py`` tests the JAX ones.

Bounds: the designs are numpy on both sides, 1e-12; streams against the
JAX package 2e-5 relative to the largest output (tests/test_golden.py);
``wav_iq_source`` across block sizes 2e-6 of the largest output (the same
streaming state, another partition); codecs and sinks byte for byte where
both write the same bytes, else as stated."""

import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csdr_tpu as cs
from csdr_tpu.io import sources as jsrc
from csdr_tpu.io import wav as jwav
from csdr_tpu.ops import hilbert as jhil
from csdr_tpu.utils import firdes as jfirdes
from csdr_tpu.utils import testsig

import csdr_tpu_torch as ct
from csdr_tpu_torch.io import sinks as S
from csdr_tpu_torch.io import sources as src
from csdr_tpu_torch.io import wav
from csdr_tpu_torch.ops import hilbert
from csdr_tpu_torch.utils import firdes

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 2e-5


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got).astype(np.complex128) - want))
                 / np.max(np.abs(want)))


# ---- codecs ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (500, 2)])
def test_wav_roundtrip_float(tmp_path, shape):
    p = str(tmp_path / "t.wav")
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 0.5
    wav.write_wav(p, x, 48000)
    y, sr = wav.read_wav(p)
    assert sr == 48000 and np.array_equal(x, y)
    assert Path(p).read_bytes() == _jax_bytes(tmp_path, jwav.write_wav, x, 48000, "wav")


def _jax_bytes(tmp_path, write, x, rate, ext) -> bytes:
    p = str(tmp_path / f"jax.{ext}")
    write(p, x, rate)
    return Path(p).read_bytes()


def _pcm_wav(path, data: np.ndarray, rate: int, channels: int = 1):
    """A PCM WAV (format tag 1) of int16 or int32 samples, with a LIST chunk
    ahead of the data chunk."""
    payload = data.astype("<" + data.dtype.str[1:]).tobytes()
    bits = data.dtype.itemsize * 8
    ba = channels * data.dtype.itemsize
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * ba, ba, bits)
    extra = b"LIST" + struct.pack("<I", 5) + b"INFOx\x00"
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + extra + b"data" + struct.pack(
        "<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_reads_pcm_like_jax(tmp_path, dtype, channels):
    info = np.iinfo(dtype)
    x = np.random.default_rng(1).integers(info.min, info.max, size=(700, channels), dtype=dtype)
    p = str(tmp_path / "pcm.wav")
    _pcm_wav(p, x, 22050, channels)
    got, sr = wav.read_wav(p)
    want, jsr = jwav.read_wav(p)
    assert sr == jsr == 22050 and got.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got.reshape(700, channels),
                          x.astype(np.float32) / np.float32(-float(info.min)))
    assert wav.probe_wav(p) == jwav.probe_wav(p) == (22050, channels, 1)


def test_au_roundtrip_and_int16(tmp_path):
    p = str(tmp_path / "t.au")
    x = np.random.default_rng(2).normal(size=256).astype(np.float32)
    wav.write_au(p, x, 8000)
    y, sr = wav.read_au(p)
    assert sr == 8000 and np.array_equal(x, y)
    assert Path(p).read_bytes() == _jax_bytes(tmp_path, jwav.write_au, x, 8000, "au")
    # encoding 3 (16-bit linear) with the size left unknown, read as the JAX package reads it
    q = str(tmp_path / "i16.au")
    v = np.arange(-300, 300, 7, dtype=">i2")
    with open(q, "wb") as f:
        f.write(struct.pack(">4sIIIII", b".snd", 24, 0xFFFFFFFF, 3, 11025, 1) + v.tobytes())
    got, sr = wav.read_au(q)
    assert sr == 11025 and np.array_equal(got, jwav.read_au(q)[0])
    bad = str(tmp_path / "bad.au")
    with open(bad, "wb") as f:
        f.write(b"RIFF" + bytes(20))
    with pytest.raises(ValueError, match="not an AU file"):
        wav.read_au(bad)


def test_probe_wav_reads_the_header_only(tmp_path):
    """A header that announces 2 GB of data it does not hold still probes
    (the payload is never read); a non-WAV file raises ValueError."""
    p = str(tmp_path / "huge.wav")
    fmt = struct.pack("<HHIIHH", 3, 1, 96000, 96000 * 4, 4, 32)
    with open(p, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 0x7FFFFFF0) + b"WAVE" + b"JUNK"
                + struct.pack("<I", 3) + b"abc\x00" + b"fmt " + struct.pack("<I", 16) + fmt
                + b"data" + struct.pack("<I", 0x7FFFFF00))
    assert wav.probe_wav(p) == jwav.probe_wav(p) == (96000, 1, 3)
    bad = str(tmp_path / "bad.cf32")
    np.zeros(64, np.complex64).tofile(bad)
    with pytest.raises(ValueError):
        wav.probe_wav(bad)
    odd = str(tmp_path / "odd.wav")
    with open(odd, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 28) + b"WAVE" + b"fmt " + struct.pack("<I", 16)
                + struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8))
    with pytest.raises(ValueError, match="unsupported"):
        wav.probe_wav(odd)


# ---- sources --------------------------------------------------------------------

def test_raw_bytes_source_matches_jax(tmp_path):
    p = str(tmp_path / "raw.bin")
    payload = np.arange(1000, dtype=np.uint8)
    payload.tofile(p)
    chunks = list(src.raw_bytes_source(p, chunk_bytes=256))
    assert [len(c) for c in chunks] == [256, 256, 256, 232]
    want = list(jsrc.raw_bytes_source(p, chunk_bytes=256))
    assert all(np.array_equal(a, b) for a, b in zip(chunks, want))


@pytest.fixture(scope="module")
def if_wav(tmp_path_factory):
    """A mono float32 WAV: three tones and noise, an odd sample count."""
    p = str(tmp_path_factory.mktemp("wav") / "if.wav")
    rng = np.random.default_rng(3)
    n = 3 * 4096 + 1001
    t = np.arange(n)
    x = (0.3 * np.cos(2 * np.pi * 0.1 * t) + 0.2 * np.cos(2 * np.pi * 0.31 * t + 1)
         + 0.1 * np.sin(2 * np.pi * 0.42 * t) + 0.01 * rng.normal(size=n))
    wav.write_wav(p, x.astype(np.float32), 48000)
    return p, n


def test_wav_iq_source_matches_jax(if_wav):
    path, n = if_wav
    want = np.concatenate(list(jsrc.wav_iq_source(path, chunk_size=1024)))
    got = np.concatenate(list(src.wav_iq_source(path, 2048, device=CPU)))
    assert got.dtype == np.complex64 and got.shape == want.shape == (n // 2,)
    assert _rel(got, want) < TOL


def test_wav_iq_source_does_not_depend_on_the_block_size(if_wav):
    path, n = if_wav
    outs = [np.concatenate(list(src.wav_iq_source(path, b, device=CPU)))
            for b in (256, 2048, 1 << 16)]
    for o in outs[1:]:
        assert o.shape == outs[0].shape
        assert np.max(np.abs(o - outs[0])) / np.max(np.abs(outs[0])) < 2e-6


def test_wav_iq_source_tone_lands_at_minus_0_3(tmp_path):
    """A real tone at 0.1 of the WAV rate: 0.2 of the IQ rate, then mixed by
    π to −0.3 (tests/test_io.py's check)."""
    p = str(tmp_path / "tone.wav")
    wav.write_wav(p, (0.5 * np.cos(2 * np.pi * 0.1 * np.arange(8192))).astype(np.float32),
                  48000)
    iq = np.concatenate(list(ct.wav_iq_source(p, 2048, device=CPU)))
    assert iq.shape == (4096,)
    spec = np.abs(np.fft.fft(iq[512:3584]))
    assert abs(np.fft.fftfreq(len(spec))[np.argmax(spec)] + 0.3) < 0.01


def test_wav_iq_source_refuses_stereo_before_reading(tmp_path):
    p = str(tmp_path / "st.wav")
    wav.write_wav(p, np.zeros((64, 2), np.float32), 8000)
    with pytest.raises(ValueError, match="only mono WAV supported"):
        src.wav_iq_source(p, device=CPU)
    with pytest.raises(ValueError, match="only mono WAV supported"):
        list(jsrc.wav_iq_source(p))


# ---- Hilbert, interpolator, rnyquist, designs -----------------------------------

def test_hilbert_blocks_match_jax_streamed():
    """real → complex (complex taps on a real input through the polyphase
    path) and complex → real, three blocks with the state carried, against
    the JAX streams; the imaginary part must survive the promotion."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=3 * 2048).astype(np.float32)
    r2c, c2r = ct.real_to_complex(), ct.complex_to_real()
    sp, sq = r2c.init(CPU), c2r.init(CPU)
    jp, jq = jhil.real_to_complex_init(), jhil.complex_to_real_init()
    for blk in np.split(x, 3):
        sp, c = r2c.apply(sp, torch.from_numpy(blk))
        jp, jc = jhil.real_to_complex_stream(jp, jnp.asarray(blk))
        assert c.dtype == torch.complex64 and c.shape == (1024,)
        assert _rel(c.numpy(), np.asarray(jc)) < TOL
        assert np.max(np.abs(c.numpy().imag)) > 0.1
        sq, y = c2r.apply(sq, c)
        jq, jy = jhil.complex_to_real_stream(jq, jc)
        assert y.dtype == torch.float32 and y.shape == (2048,)
        assert _rel(y.numpy(), np.asarray(jy)) < TOL
    assert (ct.real_to_complex().tail_len, ct.complex_to_real().tail_len) == (
        cs.real_to_complex().tail_len, cs.complex_to_real().tail_len)


def test_hilbert_roundtrip_and_analytic_tone():
    """real → complex → real recovers a delayed, scaled copy of a
    band-limited input (> 20 dB after the JAX package's delay and gain fit,
    tests/test_pfb_resamp_hilbert.py); a real tone maps to one
    complex tone, its image > 40 dB down."""
    import scipy.signal as sig

    rng = np.random.default_rng(2)
    n = 8192
    x = sig.lfilter(sig.firwin(51, [0.1, 0.8], pass_zero=False), [1.0],
                    rng.normal(size=n)).astype(np.float32)
    _, c = hilbert.real_to_complex_stream(hilbert.real_to_complex_init(CPU),
                                          torch.from_numpy(x))
    _, y = hilbert.complex_to_real_stream(hilbert.complex_to_real_init(CPU), c)
    assert testsig.snr_db(x[200:-200], y.numpy()[200:-200]) > 20.0
    tone = np.cos(2 * np.pi * 0.1 * np.arange(n)).astype(np.float32)
    _, c = hilbert.real_to_complex_stream(hilbert.real_to_complex_init(CPU),
                                          torch.from_numpy(tone))
    c = c.numpy()[200:]
    spec = np.abs(np.fft.fft(c * np.hanning(len(c))))
    peak = np.argmax(spec)
    assert spec[peak] / (spec[(len(c) - peak) % len(c)] + 1e-9) > 100.0


@pytest.mark.parametrize("p,cplx", [(3, True), (4, False)])
def test_fir_interpolator_matches_jax(p, cplx):
    rng = np.random.default_rng(p)
    n = 3 * 500
    x = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0)
    x = x.astype(np.complex64 if cplx else np.float32)
    port, ref = ct.fir_interpolator(p, complex_input=cplx), cs.fir_interpolator(
        p, complex_input=cplx)
    assert port.tail_len == ref.tail_len and port.rate == ref.rate
    assert np.array_equal(port.taps, ref.taps)
    sp, sj = port.init(CPU), ref.init()
    for blk in np.split(x, 3):
        sp, y = port.apply(sp, torch.from_numpy(blk))
        sj, yj = ref.apply(sj, jnp.asarray(blk))
        assert y.shape == (p * 500,) and _rel(y.numpy(), np.asarray(yj)) < TOL


@pytest.mark.parametrize("mu", [0.0, 0.35, -0.4])
def test_fir_filter_rnyquist_matches_jax(mu):
    port, ref = ct.fir_filter_rnyquist(4, 3, 0.3, mu), cs.fir_filter_rnyquist(4, 3, 0.3, mu)
    assert np.max(np.abs(port.taps - ref.taps)) < 1e-12 and port.tail_len == ref.tail_len
    x = np.random.default_rng(9).normal(size=2 * 777).astype(np.float32)
    sp, sj = port.init(CPU), ref.init()
    for blk in np.split(x, 2):
        sp, y = port.apply(sp, torch.from_numpy(blk))
        sj, yj = ref.apply(sj, jnp.asarray(blk))
        assert _rel(y.numpy(), np.asarray(yj)) < TOL
    g0 = firdes.group_delay(ct.fir_filter_rnyquist(4, 3, 0.3).taps, 0.01)
    assert abs(firdes.group_delay(ct.fir_filter_rnyquist(4, 3, 0.3, 0.5).taps, 0.01)
               - g0 - 0.5) < 1e-3


@pytest.mark.parametrize("name,args", [
    ("hilbert_halfband", ()), ("hilbert_halfband", (7, 80.0)),
    ("root_nyquist_kaiser", (4, 3, 0.3)), ("root_nyquist_kaiser", (2, 7, 0.0)),
    ("fractional_delay", ("h", 0.25)), ("fractional_delay", ("h", -0.4, True)),
    ("fractional_delay", ("h", 0.3, True)), ("cached_kaiser_lowpass", (101, 0.2, 60.0, 0.1))])
def test_designs_match_jax(name, args):
    h = jfirdes.kaiser_lowpass(101, 0.2, 60.0)
    args = tuple(h if a == "h" else a for a in args)
    got, want = getattr(firdes, name)(*args), getattr(jfirdes, name)(*args)
    assert got.shape == want.shape and np.max(np.abs(got - want)) < 1e-12


def test_fractional_delay_edges():
    h = firdes.kaiser_lowpass(101, 0.2, 60.0)
    assert firdes.fractional_delay(h, 0.0) is h
    with pytest.raises(ValueError, match="mu"):
        firdes.fractional_delay(h, 1.5)
    assert firdes.cached_kaiser_lowpass(51, 0.1) is firdes.cached_kaiser_lowpass(51, 0.1)


# ---- sinks ----------------------------------------------------------------------

def test_stdout_sink(capsysbinary):
    sink = ct.StdoutSink()
    sink(np.arange(4, dtype=np.float32))
    sink.close()
    assert np.array_equal(np.frombuffer(capsysbinary.readouterr().out, np.float32),
                          np.arange(4))


def test_constellation_sink_matches_jax(tmp_path):
    x = (np.random.default_rng(5).normal(size=40) + 1j).astype(np.complex64)
    files = []
    for mod, name in ((S, "p.m"), (cs, "j.m")):
        with mod.ConstellationPlotSink(str(tmp_path / name), max_points=25) as sink:
            sink(x[:10])
            sink(x[10:])
        files.append((tmp_path / name).read_text())
    assert files[0].count("v(end+1)") == 25 and "print -dpng" in files[0]
    assert files[0].replace("print -dpng -color \"-S1200,600\" p.png",
                            "print -dpng -color \"-S1200,600\" j.png") == files[1]


def test_spectrum_plot_sink_matches_welch_and_jax(tmp_path):
    """tests/test_io.py's Welch check: a tone at fs/8 peaks in its bin, the
    top 20 dB within 0.5 dB of scipy.signal.welch; fed in uneven blocks the
    script equals the JAX sink's."""
    from scipy import signal as sp_signal

    fs, nfft, n = 1.0e6, 256, 256 * 40
    t = np.arange(n)
    rng = np.random.default_rng(0)
    x = (np.exp(2j * np.pi / 8 * t) + 0.001 * (rng.standard_normal(n)
                                               + 1j * rng.standard_normal(n))).astype(np.complex64)
    texts = []
    for mod, name in ((S, "p.m"), (cs, "j.m")):
        snk = mod.SpectrumPlotSink(str(tmp_path / name), nfft=nfft, sample_rate=fs)
        for seg in np.split(x, [1000, 5000, 7777]):
            snk(seg)
        snk.close()
        texts.append((tmp_path / name).read_text())
    txt = texts[0]
    assert txt.replace("p.png", "j.png") == texts[1]
    fvals = np.array(txt.split("f = [")[1].split("];")[0].split(), float)
    pvals = np.array(txt.split("p = [")[1].split("];")[0].split(), float)
    assert len(fvals) == len(pvals) == nfft
    assert abs(fvals[np.argmax(pvals)] - fs / 8) < fs / nfft
    _, p_sp = sp_signal.welch(x, fs=fs, nperseg=nfft, noverlap=0, window="hann",
                              detrend=False, return_onesided=False, scaling="spectrum")
    ref_db = 10 * np.log10(np.fft.fftshift(p_sp) + 1e-30)
    mask = ref_db > ref_db.max() - 20.0
    assert np.max(np.abs(pvals[mask] - ref_db[mask])) < 0.5


@pytest.mark.parametrize("fmt", ["wav", "au"])
def test_audio_sink_formats_and_layouts(tmp_path, fmt):
    """(channels, n) runtime-layout blocks and tuples are interleaved into
    frames across several writes; the file equals the JAX sink's."""
    L = np.arange(10, dtype=np.float32)
    R = -np.arange(10, dtype=np.float32)
    outs = []
    for mod, name in ((S, "p"), (cs, "j")):
        snk = mod.AudioFileSink(str(tmp_path / name), 8000, 2, fmt)
        snk(np.stack([L[:6], R[:6]]))
        snk((L[6:], R[6:]))
        snk.close()
        assert snk.path.endswith("." + fmt)
        outs.append(Path(snk.path).read_bytes())
    assert outs[0] == outs[1]
    audio, sr = (wav.read_wav if fmt == "wav" else wav.read_au)(str(tmp_path / f"p.{fmt}"))
    assert sr == 8000 and np.array_equal(audio[:, 0], L) and np.array_equal(audio[:, 1], R)
    with pytest.raises(ValueError, match="'wav' or 'au'"):
        S.AudioFileSink(str(tmp_path / "x"), 8000, 1, "flac")


def test_tee_sink(tmp_path):
    p = tmp_path / "tee.f32"
    col = ct.CollectSink()
    tee = ct.TeeSink(ct.RawFileSink(str(p)), col)
    data = np.arange(100, dtype=np.float32)
    tee(data[:60])
    tee(data[60:])
    tee.close()
    assert np.array_equal(np.fromfile(str(p), dtype=np.float32), data)
    assert np.array_equal(col.concat(), data)


def test_playback_sink_streams_pcm_to_a_file(tmp_path):
    out = tmp_path / "pcm.bin"
    log = tmp_path / "argv.txt"
    cmd = f"sh -c 'echo $0 $1 > {log}; cat > {out}' {{rate}} {{channels}}"
    snk = ct.PlaybackSink(48000, channels=2, command=cmd)
    blk = np.arange(8, dtype=np.float32).reshape(2, 4)  # (channels, n)
    snk(blk)
    snk.close()
    assert log.read_text().split() == ["48000", "2"]
    assert np.array_equal(np.frombuffer(out.read_bytes(), np.float32), blk.T.ravel())


def test_playback_sink_dead_player_is_nonfatal():
    snk = ct.PlaybackSink(8000, command="true")
    snk.proc.wait()
    for _ in range(64):  # overflows the pipe buffer: EPIPE
        snk(np.zeros(1 << 16, np.float32))
    assert not snk.alive
    snk.close()


def test_playback_sink_no_player_raises(monkeypatch):
    import shutil

    monkeypatch.delenv("CSDR_PLAYER", raising=False)
    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(FileNotFoundError):
        ct.PlaybackSink(8000)
