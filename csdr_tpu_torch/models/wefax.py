"""HF WEFAX (radiofax) image receiver for marine weather charts.

Counterpart of ``csdr_tpu/models/wefax.py``.  WEFAX is the shortwave
facsimile service (DWD, NOAA marine charts): an audio subcarrier whose
instantaneous frequency carries luminance, 1500 Hz = black → 2300 Hz =
white, preceded by a PHASING train (lines all white but for a 5 % black
pulse) that anchors the line phase, at 120 lines/min with 1810 pixels per
line (IOC 576: π·576 ≈ 1809.6).

Scope, as in the JAX package: modulation, phasing alignment and line
decode; the 300/450 Hz start/stop tones of real broadcasts are out of
scope, so ``lpm`` is given (the broadcast schedules publish it).  The
decode drops the last image line, as the JAX decode does (its golden
anchor has it).

The product discriminator to instantaneous frequency runs on the device
(``models/sstv.py``'s shape with a wider low-pass); the phasing search and
fractional-sample line resampling run on the host.
"""

from __future__ import annotations

import numpy as np

from .. import blocks as B
from ..core.block import Block, chain
from .sstv import freq_to_hz, track

__all__ = [
    "wefax_receiver", "wefax_modulate", "find_phasing", "decode_freq",
    "decode_audio", "PX_PER_LINE",
]

_F_BLACK, _F_WHITE = 1500.0, 2300.0
_F_CENTER = 1900.0
PX_PER_LINE = 1810          # IOC 576: round(pi * 576)
_PULSE_FRAC = 0.05          # phasing: 5% black pulse at the line start


def wefax_receiver(sample_rate: float, kf: float = 0.5) -> Block:
    """f32 WEFAX audio at ``sample_rate`` → instantaneous frequency in Hz.

    Same product-discriminator shape as models/sstv.py but with a wider
    video lowpass: at 120 lpm the pixel rate is ~3.6 kHz, so the baseband
    video spans ±2.2 kHz around the 1900 Hz center while the mixing image
    sits at −(3400..6000) Hz — cutoff centered in the 1.2 kHz gap."""
    if sample_rate < 10000.0:
        raise ValueError(
            f"WEFAX needs sample_rate >= 10000 (video band ±2.2 kHz), "
            f"got {sample_rate}")
    omega = 2.0 * np.pi * _F_CENTER / sample_rate
    fc = 0.5 * (2200.0 + 3400.0) / sample_rate
    return chain(
        B.mix_down(omega),
        B.fir_filter_c_kaiser(161, fc, as_db=60.0),
        B.fm_demodulator(kf),
        freq_to_hz(kf, sample_rate),
    )


def _lum_to_freq(v: np.ndarray) -> np.ndarray:
    return _F_BLACK + (_F_WHITE - _F_BLACK) * np.asarray(v, np.float64) / 255.0


def wefax_modulate(image: np.ndarray, sample_rate: float, lpm: float = 120.0,
                   phasing_lines: int = 10, amplitude: float = 0.7
                   ) -> np.ndarray:
    """(lines, PX_PER_LINE) uint8 rows → f32 audio: ``phasing_lines`` of
    white-with-5%-black-pulse alignment lines, then the image, all
    phase-continuous FM at ``lpm`` lines/min."""
    if image.ndim != 2 or image.shape[1] != PX_PER_LINE:
        raise ValueError(f"image must be (lines, {PX_PER_LINE})")
    line_s = 60.0 / lpm
    n_line = int(round(line_s * sample_rate))
    n_pulse = int(round(_PULSE_FRAC * n_line))
    ph_line = np.full(n_line, 255.0)
    ph_line[:n_pulse] = 0.0                     # black pulse AT line start
    lum = [ph_line] * phasing_lines
    t_px = np.arange(n_line) * PX_PER_LINE / n_line
    for row in image.astype(np.float64):
        lum.append(np.interp(t_px, np.arange(PX_PER_LINE), row))
    freq = _lum_to_freq(np.concatenate(lum))
    ph = 2.0 * np.pi * np.cumsum(freq) / sample_rate
    return (amplitude * np.cos(ph)).astype(np.float32)


def find_phasing(freq: np.ndarray, sample_rate: float, lpm: float = 120.0):
    """Phase of the line raster from the phasing train: correlate a
    one-line template (black pulse + white remainder) against the first
    seconds of the frequency track, folded modulo the line period.
    Returns (line_start_sample_offset, score) — score is the fraction of
    the fold that matched the template's black/white split (≈1 on a real
    phasing train, ≈0.5 on noise)."""
    n_line = int(round(60.0 / lpm * sample_rate))
    n_pulse = int(round(_PULSE_FRAC * n_line))
    use = freq[: min(len(freq), 8 * n_line)]
    m = (len(use) // n_line) * n_line
    if m < 2 * n_line:
        return 0, 0.0
    fold = use[:m].reshape(-1, n_line).mean(axis=0)
    black = fold < 1700.0
    # the pulse is n_pulse contiguous black samples: correlate circularly
    k = np.concatenate([black.astype(np.float64)] * 2)
    win = np.convolve(k, np.ones(n_pulse), mode="valid")[:n_line]
    start = int(np.argmax(win))
    score = float(win[start]) / n_pulse
    return start, score


def decode_freq(freq: np.ndarray, sample_rate: float, lpm: float = 120.0,
                min_phasing_score: float = 0.9):
    """Frequency track → (image uint8 (lines, PX_PER_LINE), info)."""
    n_line = int(round(60.0 / lpm * sample_rate))
    start, score = find_phasing(freq, sample_rate, lpm)
    if score < min_phasing_score:
        return np.zeros((0, PX_PER_LINE), np.uint8), {
            "lines": 0, "phasing_score": score}
    # skip the phasing lines themselves: a phasing line is black pulse AND
    # white remainder (the pulse alone mistakes image lines that start dark
    # for phasing)
    pos = start
    n_pulse = int(round(_PULSE_FRAC * n_line))
    while pos + n_line <= len(freq):
        pulse = np.median(freq[pos: pos + n_pulse])
        rest = np.median(freq[pos + n_pulse: pos + n_line])
        if not (pulse < 1700.0 and rest > 2100.0):
            break
        pos += n_line
    rows = []
    t_px = (np.arange(PX_PER_LINE) + 0.5) * n_line / PX_PER_LINE
    while pos + n_line <= len(freq):
        # interpolate within the line's own samples (the same neighbours and
        # values as over the whole track, without an O(track) pass per line)
        hi = min(len(freq), pos + n_line + 1)
        f = np.interp(pos + t_px, np.arange(pos, hi), freq[pos:hi])
        rows.append(np.clip((f - _F_BLACK) * (255.0 / (_F_WHITE - _F_BLACK)),
                            0.0, 255.0))
        pos += n_line
    img = (np.asarray(np.rint(rows), np.uint8) if rows
           else np.zeros((0, PX_PER_LINE), np.uint8))
    return img, {"lines": len(rows), "phasing_score": score,
                 "line_start": start}


def decode_audio(audio: np.ndarray, sample_rate: float, lpm: float = 120.0,
                 block_size: int = 1 << 16, *, device="cuda"):
    """End to end: f32 audio → chart image (the discriminator on
    ``device``, the framing on the host)."""
    return decode_freq(track(wefax_receiver(sample_rate), audio, block_size, device),
                       sample_rate, lpm)
