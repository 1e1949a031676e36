"""NOAA APT weather-satellite image receiver.

Counterpart of ``csdr_tpu/models/apt.py``.  NOAA POES satellites send
weather imagery as a 2400 Hz AM subcarrier inside a wideband-FM downlink at
137 MHz: two image lines per second, 2080 words per line, two channels
(visible + IR) side by side with sync trains and telemetry wedges (NOAA KLM
User's Guide §4.2).

The sample-rate part (coherent product detection of the 2400 Hz
subcarrier: mix to baseband, image-reject low-pass, the signed real part
against the block's carrier phase; decimation to the 4160 Hz word rate) is
a Block chain on the device; sync correlation, line framing and level
calibration against the sync's known black and white run on the host over
the 4.2 kB/s word stream.

Line format (2080 words, 0..255 luminance):
    [sync A 39][space A 47][video A 909][telemetry A 45]
    [sync B 39][space B 47][video B 909][telemetry B 45]
Sync A is a 1040 Hz square train (4 lows, then 7 cycles of 2 high / 2 low,
then 7 lows) at the word rate; its highs are spec white (244) and lows spec
black (11).  ``apt_modulate`` makes exactly the signal the receiver
inverts.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import blocks as B
from ..core.block import Block, Lambda, chain

__all__ = [
    "WORD_RATE", "LINE_WORDS", "CARRIER_HZ", "SYNC_A", "SYNC_B",
    "apt_receiver", "apt_modulate", "find_sync", "decode_words",
    "decode_audio", "split_channels",
]

WORD_RATE = 4160.0      # words/s (2 lines/s x 2080 words)
LINE_WORDS = 2080
CARRIER_HZ = 2400.0
_WHITE, _BLACK = 244, 11   # spec luminance of sync high/low

# sync A: 4 low, 7 cycles of (2 high, 2 low) = a 1040 Hz square, 7 low
SYNC_A = np.concatenate([np.zeros(4), np.tile([1, 1, 0, 0], 7),
                         np.zeros(7)]).astype(np.float64)
# sync B: 4 low, 7 cycles of (3 high, 2 low) = an 832 pps pulse train
SYNC_B = np.concatenate([np.zeros(4), np.tile([1, 1, 1, 0, 0], 7)]
                        ).astype(np.float64)

_VIDEO_A = slice(39 + 47, 39 + 47 + 909)
_VIDEO_B = slice(1040 + 39 + 47, 1040 + 39 + 47 + 909)


def _bandlimited_sync() -> np.ndarray:
    """Sync A as it appears in a 4160 Hz word stream (the correlation
    template): reaching the word rate band-limits to < 2080 Hz, which cuts
    the 1040 Hz square's 3rd harmonic, so the template is the band-limited
    train (×8 upsample, Kaiser low-pass at 2080 Hz, word-rate resample,
    context padded with lows)."""
    from ..utils import firdes

    up = 8
    pad = 8
    ctx = np.concatenate([np.zeros(pad), SYNC_A, np.zeros(pad)])
    x = np.repeat(ctx, up)
    taps = firdes.kaiser_lowpass(8 * up + 1, 0.5 / up, 60.0)
    y = np.convolve(x, taps, mode="same")
    return y[pad * up + up // 2::up][:len(SYNC_A)]


_SYNC_A_BL = _bandlimited_sync()


def _coherent(x: torch.Tensor) -> torch.Tensor:
    """2·Re(x·conj(p)), p the unit phasor of the block's sum along the last
    axis: the carrier phase of the block (a CUDA sum reduces in another
    order than the CPU's, which the golden 2e-5 covers)."""
    ph = x.sum(dim=-1, keepdim=True)
    ph = ph / torch.clamp(ph.abs(), min=1e-12)
    return 2.0 * (x * ph.conj()).real


def apt_receiver(sample_rate: float) -> Block:
    """f32 FM-demodulated audio at ``sample_rate`` (n × 4160 Hz, n ≥ 3) →
    envelope word stream at 4160 Hz (uncalibrated luminance;
    ``decode_words`` maps it to 0..255 against the sync levels).

    Coherent product detector: x·e^{−jωt} puts the AM envelope at DC
    (rotated by the unknown carrier phase) and the double-frequency image at
    −4800 Hz; the Kaiser low-pass passes the ±2080 Hz video band flat and
    rejects the image.  The carrier phase is taken per block from the
    DC-dominant sum (the mixer is phase-continuous, so it is one constant),
    and the SIGNED real part kept: a magnitude detector would rectify the
    ringing below the black sync level.  The decimator resamples to one
    sample per word.  Assumes a tuned carrier (Doppler is upstream's)."""
    n = sample_rate / WORD_RATE
    if abs(n - round(n)) > 1e-9 or round(n) < 3:
        raise ValueError(
            f"APT needs sample_rate = n·{WORD_RATE:g} with n ≥ 3, "
            f"got {sample_rate}")
    n = int(round(n))
    omega = 2.0 * np.pi * CARRIER_HZ / sample_rate
    # cutoff centred in the 2080 (video edge) .. 2720 (image edge) gap
    fc = 0.5 * (2080.0 + 2720.0) / sample_rate
    return chain(
        B.mix_down(omega),
        B.fir_filter_c_kaiser(121, fc, as_db=60.0),
        Lambda(_coherent, name="coherent_envelope"),
        B.fir_decimator(n, complex_input=False),
    )


def apt_modulate(image: np.ndarray, sample_rate: float,
                 amplitude: float = 0.8) -> np.ndarray:
    """(lines, 2080) uint8 luminance rows → f32 audio (the exact signal the
    receiver inverts): words upsampled to ``sample_rate`` and AM-modulated
    onto the 2400 Hz subcarrier with envelope ∝ luminance."""
    if image.ndim != 2 or image.shape[1] != LINE_WORDS:
        raise ValueError(f"image must be (lines, {LINE_WORDS})")
    n = int(round(sample_rate / WORD_RATE))
    w = np.repeat(image.astype(np.float64).reshape(-1) / 255.0, n)
    t = np.arange(len(w))
    return (amplitude * w * np.cos(2.0 * np.pi * CARRIER_HZ / sample_rate * t)
            ).astype(np.float32)


def find_sync(words: np.ndarray) -> np.ndarray:
    """Positions of sync-A trains in a 4160 Hz word stream.

    True normalized cross-correlation (windowed local mean/variance, so
    the score lives in [−1, 1]) against the band-limited template, an
    ABSOLUTE floor of 0.55, dedup to one candidate per line, and a
    structural gate: a real APT transmission repeats the train every
    LINE_WORDS, so candidates without a partner one line away (±2 words)
    are rejected — pure noise, whose best 39-word NCC can reach ~0.6 by
    chance over thousands of offsets, produces no consistent spacing and
    decodes to zero lines (a relative threshold fabricated lines from
    noise)."""
    w = np.asarray(words, np.float64)
    tpl = _SYNC_A_BL - _SYNC_A_BL.mean()
    tpl /= np.sqrt((tpl ** 2).sum())
    k = len(tpl)
    if len(w) < k:
        return np.zeros(0, np.int64)
    c = np.correlate(w, tpl, mode="valid")     # tpl is zero-mean
    csum = np.concatenate([[0.0], np.cumsum(w)])
    csum2 = np.concatenate([[0.0], np.cumsum(w ** 2)])
    mean = (csum[k:] - csum[:-k]) / k
    var = np.maximum((csum2[k:] - csum2[:-k]) - k * mean ** 2, 1e-12)
    score = c / np.sqrt(var)                   # NCC in [-1, 1]
    cand = np.flatnonzero(score >= 0.55)
    out = []
    for i in cand:
        if out and i - out[-1] < LINE_WORDS // 2:
            if score[i] > score[out[-1]]:
                out[-1] = i
        else:
            out.append(i)
    out = np.asarray(out, np.int64)
    if len(out) < 2:
        return np.zeros(0, np.int64)
    d = np.abs(out[:, None] - out[None, :])
    has_partner = (np.abs(d - LINE_WORDS) <= 2).any(axis=1)
    out = out[has_partner]
    return out if len(out) >= 2 else np.zeros(0, np.int64)


def decode_words(words: np.ndarray) -> tuple[np.ndarray, dict]:
    """4160 Hz envelope words → (lines, 2080) uint8 image + info dict.

    Levels are calibrated against the sync-A train itself: its highs are
    spec white (244) and lows spec black (11), so the per-image linear map
    needs no AGC assumptions about the link."""
    w = np.asarray(words, np.float64)
    syncs = find_sync(w)
    syncs = syncs[syncs + LINE_WORDS <= len(w)]
    if len(syncs) == 0:
        return np.zeros((0, LINE_WORDS), np.uint8), {"lines": 0, "syncs": []}
    # Phase-free level fit on the 7-cycle 1040 Hz square (words 4..31 of
    # the train).  Reaching the word rate band-limits the square to DC +
    # fundamental (3rd harmonic 3120 Hz > the 2080 Hz Nyquist), and the
    # receiver's decimation phase vs word centers is unknown — so fit
    # w[s+k] ≈ c0 + c1·cos(πk/2) + c2·sin(πk/2) and recover the flat-top
    # levels analytically: a 50% square of span S has fundamental amplitude
    # (2/π)·S and no even harmonics, so S = (π/2)·hypot(c1,c2), centered
    # on c0.  Immune to both the harmonic sag and the sampling phase.
    # interior 5 cycles only: the band-limited rise from the preceding lows
    # leaks into the first cycle (and the trailing lows into the last),
    # shaving the fitted amplitude by ~6% if included
    k = np.arange(8, 28)
    A = np.stack([np.ones_like(k, np.float64),
                  np.cos(0.5 * np.pi * k), np.sin(0.5 * np.pi * k)], axis=1)
    his, los = [], []
    for s in syncs:
        (c0, c1, c2), *_ = np.linalg.lstsq(A, w[s + k], rcond=None)
        span = 0.5 * np.pi * float(np.hypot(c1, c2))
        los.append(c0 - 0.5 * span)
        his.append(c0 + 0.5 * span)
    hi, lo = float(np.median(his)), float(np.median(los))
    scale = (_WHITE - _BLACK) / max(hi - lo, 1e-9)
    rows = [np.clip((w[s:s + LINE_WORDS] - lo) * scale + _BLACK, 0, 255)
            for s in syncs]
    img = np.asarray(np.rint(rows), np.uint8)
    return img, {"lines": len(rows), "syncs": syncs.tolist(),
                 "level_lo": lo, "level_hi": hi}


def decode_audio(audio: np.ndarray, sample_rate: float, block_size: int = 1 << 16, *,
                 device="cuda") -> tuple[np.ndarray, dict]:
    """End to end: f32 audio → image, the chain on ``device`` in blocks of
    ``block_size`` (rounded to the granule), the framing on the host.  For
    files use Pipeline + CollectSink (``apps/apt_decode.py``)."""
    rx = apt_receiver(sample_rate)
    dev = torch.device(device)
    g = rx.granule
    n = (len(audio) // g) * g
    st = rx.init(dev)
    outs = []
    step = max(block_size // g * g, g)
    for i in range(0, n, step):
        x = torch.from_numpy(np.ascontiguousarray(audio[i:min(i + step, n)], np.float32))
        st, y = rx.apply(st, x.to(dev))
        outs.append(y.cpu().numpy())
    return decode_words(np.concatenate(outs) if outs else np.zeros(0))


def split_channels(image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Full 2080-word rows → (video A, video B) 909-px channel images."""
    return image[:, _VIDEO_A], image[:, _VIDEO_B]
