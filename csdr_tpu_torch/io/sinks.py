"""Sample sinks: callables fed trimmed numpy arrays by the runtime;
``close()`` finalizes headers.

Copied from ``csdr_tpu/io/sinks.py`` (every sink of it), numpy only, host
code: the runtime hands each sink blocks it has already copied to the host.
A graph emits one array per block, or a tuple of them from a ``Tee``, which
``BranchSinks`` routes one branch per sink; ``TeeSink`` copies one stream
to several sinks."""

from __future__ import annotations

import os
import sys

import numpy as np

from . import wav as wavio

__all__ = ["RawFileSink", "StdoutSink", "AudioFileSink", "ConstellationPlotSink",
           "SpectrumPlotSink", "TeeSink", "PlaybackSink", "ChannelFileSinks", "BranchSinks",
           "NullSink", "CollectSink"]


class SinkBase:
    def __call__(self, data):
        raise NotImplementedError

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RawFileSink(SinkBase):
    """Raw little-endian sample writer (.cf32 complex64 / .f32 float32)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")

    def __call__(self, data):
        np.asarray(data).tofile(self.f)

    def close(self):
        self.f.close()


class AudioFileSink(SinkBase):
    """Float32 WAV or AU writer (reference audioFileSink), ``fmt`` "wav" or
    "au"; interleaves (n,) mono, (channels, n) runtime-layout blocks (the
    stereo decoder's), (n, channels) frames, or a tuple of per-channel
    arrays."""

    def __init__(self, path: str, sample_rate: int, channels: int = 1, fmt: str = "wav"):
        fmt = fmt.lower()
        if fmt not in ("wav", "au"):
            raise ValueError(f"audio format must be 'wav' or 'au', got {fmt!r}")
        cls = wavio.WavWriter if fmt == "wav" else wavio.AuWriter
        if not path.endswith("." + fmt):
            path += "." + fmt
        self.w = cls(path, sample_rate, channels)
        self.channels = int(channels)
        self.path = path

    def __call__(self, data):
        if isinstance(data, tuple):
            data = np.stack([np.asarray(d) for d in data], axis=-1)
        data = np.asarray(data)
        if data.ndim == 2 and data.shape[0] == self.channels > 1:
            data = data.T  # (channels, n) runtime layout → interleaved frames
        self.w.write(data)

    def close(self):
        self.w.close()


class StdoutSink(SinkBase):
    """Raw samples to standard output (reference stdOutSink)."""

    def __call__(self, data):
        sys.stdout.buffer.write(np.asarray(data).tobytes())

    def close(self):
        sys.stdout.buffer.flush()


class ConstellationPlotSink(SinkBase):
    """A GNU Octave scatter-plot script of the first ``max_points`` IQ
    samples (reference constellationPlotSink)."""

    def __init__(self, path: str, max_points: int = 20000):
        self.f = open(path, "w")
        self.f.write("clear all; close all;\nv = [];\n")
        self.base = os.path.splitext(os.path.basename(path))[0]
        self.left = max_points

    def __call__(self, data):
        data = np.asarray(data).reshape(-1)
        take = data[: max(self.left, 0)]
        self.left -= len(take)
        for s in take:
            self.f.write(f"v(end+1) = {s.real:12.4e} + j*{s.imag:12.4e};\n")

    def close(self):
        self.f.write(
            "n = length(v);\n"
            "figure('color','white','position',[100 100 1200 400]);\n"
            "plot(real(v), imag(v), 'x', 'Color',[0 0.2 0.4]);\n"
            "xlabel('In-Phase');\nylabel('Quadrature');\ngrid on;\n"
            f'print -dpng -color "-S1200,600" {self.base}.png\n'
        )
        self.f.close()


class SpectrumPlotSink(SinkBase):
    """Welch-averaged power spectral density as a GNU Octave plot script,
    the spectral companion of ``ConstellationPlotSink``.

    Accumulates Hann-windowed periodograms of ``nfft`` points over every
    block received, the partial segment carried to the next block (complex
    input: the full band, fftshifted; real input: the same, conjugate-
    symmetric).  ``close()`` writes the averaged spectrum in dB and the
    plotting code."""

    def __init__(self, path: str, nfft: int = 1024, sample_rate: float = 1.0):
        self.f = open(path, "w")
        self.base = os.path.splitext(os.path.basename(path))[0]
        self.nfft = nfft
        self.fs = float(sample_rate)
        self.win = np.hanning(nfft).astype(np.float64)
        # 'spectrum' scaling (scipy.signal.welch convention): a unit tone
        # peaks at 0 dB regardless of nfft/window
        self.scale = 1.0 / (np.sum(self.win) ** 2 + 1e-30)
        self.acc = np.zeros(nfft, dtype=np.float64)
        self.count = 0
        self._tail = np.zeros(0, dtype=np.complex128)

    def __call__(self, data):
        x = np.asarray(data).reshape(-1).astype(np.complex128)
        x = np.concatenate([self._tail, x])
        nseg = len(x) // self.nfft
        if nseg:
            segs = x[: nseg * self.nfft].reshape(nseg, self.nfft) * self.win
            spec = np.fft.fft(segs, axis=1)
            self.acc += (np.abs(spec) ** 2).sum(axis=0) * self.scale
            self.count += nseg
        self._tail = x[nseg * self.nfft:]

    def close(self):
        psd = np.fft.fftshift(self.acc / max(self.count, 1))
        db = 10.0 * np.log10(psd + 1e-30)
        freqs = np.fft.fftshift(np.fft.fftfreq(self.nfft, d=1.0 / self.fs))
        self.f.write("clear all; close all;\n")
        self.f.write("f = [" + " ".join(f"{v:.6e}" for v in freqs) + "];\n")
        self.f.write("p = [" + " ".join(f"{v:.3f}" for v in db) + "];\n")
        self.f.write(
            "figure('color','white','position',[100 100 1200 400]);\n"
            "plot(f, p, 'Color',[0 0.2 0.4]);\n"
            "xlabel('Frequency [Hz]');\nylabel('PSD [dB]');\ngrid on;\n"
            f'print -dpng -color "-S1200,600" {self.base}.png\n'
        )
        self.f.close()


class TeeSink(SinkBase):
    """Copy one output stream into several sinks (the sink-side counterpart
    of ``core/block.Tee``)."""

    def __init__(self, *sinks):
        self.sinks = sinks

    def __call__(self, data):
        for s in self.sinks:
            s(data)

    def close(self):
        for s in self.sinks:
            s.close()


class PlaybackSink(SinkBase):
    """Live audio playback through an external player's stdin.

    Streams little-endian float32 PCM (interleaved for multi-channel) to the
    first player found — ``pacat`` (PulseAudio), ``aplay`` (ALSA), ``play``
    (sox) — or to an explicit ``command`` / ``$CSDR_PLAYER`` (shell-split;
    ``{rate}``/``{channels}`` are substituted).  Raises if no player exists;
    a dead player ends playback silently (like pulling headphones out
    mid-stream) rather than killing the capture."""

    _CANDIDATES = (
        "pacat --rate {rate} --channels {channels} --format float32le",
        "aplay -q -f FLOAT_LE -r {rate} -c {channels} -t raw -",
        "play -q -t raw -r {rate} -e floating-point -b 32 -c {channels} -",
    )

    def __init__(self, sample_rate: int, channels: int = 1,
                 command: str | None = None):
        import shlex
        import shutil
        import subprocess

        command = command or os.environ.get("CSDR_PLAYER")
        if command is None:
            for cand in self._CANDIDATES:
                if shutil.which(cand.split()[0]):
                    command = cand
                    break
            else:
                raise FileNotFoundError(
                    "no audio player found (tried pacat/aplay/play); install "
                    "one or set CSDR_PLAYER / pass command=")
        argv = [a.format(rate=int(sample_rate), channels=int(channels))
                for a in shlex.split(command)]
        self.proc = subprocess.Popen(argv, stdin=subprocess.PIPE)
        self.alive = True

    def __call__(self, data):
        if not self.alive:
            return
        a = np.asarray(data)
        if a.ndim == 2:  # (channels, n) runtime layout → interleaved frames
            a = a.T
        try:
            self.proc.stdin.write(np.ascontiguousarray(a, np.float32).tobytes())
        except (BrokenPipeError, OSError):
            self.alive = False

    def close(self):
        if self.proc.stdin and not self.proc.stdin.closed:
            try:
                self.proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass
        self.proc.wait()


class ChannelFileSinks(SinkBase):
    """Fan a (nch, n) channelized block out to per-channel sinks (files
    name_ch1 .. name_chN)."""

    def __init__(self, make_sink, nch: int):
        self.sinks = [make_sink(i) for i in range(nch)]

    def __call__(self, data):
        arr = np.asarray(data)
        for i, s in enumerate(self.sinks):
            s(arr[i])

    def close(self):
        for s in self.sinks:
            s.close()


class BranchSinks(SinkBase):
    """Route a tuple-output graph (a ``Tee``, multi-rate ones included) to
    one sink per branch: element i of every output tuple goes to
    ``sinks[i]``, so each branch keeps its own rate and file."""

    def __init__(self, *sinks):
        self.sinks = sinks

    def __call__(self, data):
        if not isinstance(data, tuple) or len(data) != len(self.sinks):
            raise TypeError(f"BranchSinks expects a {len(self.sinks)}-tuple per block, "
                            f"got {type(data).__name__}")
        for s, d in zip(self.sinks, data):
            s(d)

    def close(self):
        for s in self.sinks:
            s.close()


class NullSink(SinkBase):
    """Count the samples per stream and drop them."""

    def __init__(self):
        self.samples = 0

    def __call__(self, data):
        self.samples += np.asarray(data).shape[-1]


class CollectSink(SinkBase):
    """Accumulate outputs in memory.  ``concat()`` joins them leaf by leaf
    along the last axis, so a ``Tee`` graph's tuple (or a dict) of outputs
    comes back as one array per leaf; a run that collected nothing returns
    a flat ``np.zeros(0)``, whatever the graph's output structure."""

    def __init__(self):
        self.parts: list = []

    def __call__(self, data):
        self.parts.append(_tree_map(_host, data))

    def concat(self):
        if not self.parts:
            return np.zeros(0)
        return _tree_map(lambda *xs: np.concatenate(xs, axis=-1), *self.parts)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is moved off its device)."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured tuple/list/dict trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)
