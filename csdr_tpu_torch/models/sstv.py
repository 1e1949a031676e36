"""SSTV (slow-scan television) image receiver, Martin M1/M2 modes.

Counterpart of ``csdr_tpu/models/sstv.py``.  SSTV is an audio subcarrier
whose instantaneous frequency carries the picture, 1500 Hz = black →
2300 Hz = white, with 1200 Hz sync pulses and a 1900/1100/1300 Hz VIS
header naming the mode (Martin timing per JL Barber N7CXI's "Proposal for
SSTV Mode Specifications").

Martin line structure (each line, GBR order):
    sync 4.862 ms @1200 | porch 0.572 @1500 |
    G scan | sep 0.572 @1500 | B scan | sep 0.572 | R scan | sep 0.572
with scan = 146.432 ms (M1, 320 px) or 73.216 ms (M2), 256 lines.

VIS header: 300 ms leader @1900, 10 ms break @1200, 300 ms leader, then
30 ms/bit: start @1200, 7 data bits LSB-first (1100 = "1", 1300 = "0"),
even-parity bit, stop @1200.  Martin M1 = 44, M2 = 40.

The product discriminator to instantaneous frequency in Hz (mix to the
1900 Hz band centre, image-reject low-pass, phase-difference FM demod, the
map to Hz) is a Block chain on the device; the VIS decode, sync search and
fractional-sample scanline resampling run on the host over the frequency
track.  ``sstv_modulate`` makes exactly the signal the receiver inverts.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import blocks as B
from ..core.block import Block, Lambda, chain

__all__ = [
    "MODES", "sstv_receiver", "sstv_modulate", "decode_vis", "find_syncs",
    "decode_freq", "decode_audio", "freq_to_hz", "track",
]

_F_BLACK, _F_WHITE, _F_SYNC = 1500.0, 2300.0, 1200.0
_F_CENTER = 1900.0
_T_SYNC, _T_PORCH = 4.862e-3, 0.572e-3
_T_BIT = 30e-3

# mode name -> (VIS code, pixels/scan, scan seconds, lines)
MODES = {
    "martin1": (44, 320, 146.432e-3, 256),
    "martin2": (40, 320, 73.216e-3, 256),
}
_BY_VIS = {v[0]: k for k, v in MODES.items()}


def freq_to_hz(kf: float, sample_rate: float) -> Block:
    """The FM demod's output (cycles per sample / kf) → Hz about the
    1900 Hz centre, in float32 torch ops: x·float32(kf·fs) + 1900."""
    scale = float(np.float32(kf * sample_rate))
    return Lambda(lambda x: x * scale + _F_CENTER, name="freq_to_hz")


def sstv_receiver(sample_rate: float, kf: float = 0.5) -> Block:
    """f32 SSTV audio at ``sample_rate`` → instantaneous frequency in Hz
    (same rate).  Product discriminator: mix the 1100–2300 Hz band to the
    1900 Hz centre, reject the −(3000..4200) Hz mixing image with a Kaiser
    low-pass, then the phase-difference FM demod and the map back to Hz."""
    if sample_rate < 8000.0:
        raise ValueError(f"SSTV needs sample_rate >= 8000, got {sample_rate}")
    omega = 2.0 * np.pi * _F_CENTER / sample_rate
    # pass ±800 Hz (sync 1200 = centre − 700), stop by the image at −3000
    fc = 0.5 * (800.0 + 3000.0) / sample_rate
    return chain(
        B.mix_down(omega),
        B.fir_filter_c_kaiser(161, fc, as_db=60.0),
        B.fm_demodulator(kf),
        freq_to_hz(kf, sample_rate),
    )


def _events_for(image: np.ndarray, mode: str):
    """(freq_hz, seconds) event list: VIS header + every scanline."""
    vis, px, t_scan, _ = MODES[mode]
    lum = lambda v: _F_BLACK + (_F_WHITE - _F_BLACK) * float(v) / 255.0
    ev = [(_F_CENTER, 300e-3), (_F_SYNC, 10e-3), (_F_CENTER, 300e-3),
          (_F_SYNC, _T_BIT)]
    par = 0
    for b in range(7):
        bit = (vis >> b) & 1
        par ^= bit
        ev.append((1100.0 if bit else 1300.0, _T_BIT))
    ev.append((1100.0 if par else 1300.0, _T_BIT))   # even parity
    ev.append((_F_SYNC, _T_BIT))
    t_px = t_scan / px
    for row in image:
        ev.append((_F_SYNC, _T_SYNC))
        ev.append((_F_BLACK, _T_PORCH))
        for chan in (1, 2, 0):                        # G, B, R
            for v in row[:, chan]:
                ev.append((lum(v), t_px))
            ev.append((_F_BLACK, _T_PORCH))
    return ev


def sstv_modulate(image: np.ndarray, sample_rate: float,
                  mode: str = "martin1", amplitude: float = 0.7) -> np.ndarray:
    """(lines, px, 3) uint8 RGB → f32 audio (phase-continuous FM of the
    event list — the exact signal the receiver inverts)."""
    vis, px, t_scan, _ = MODES[mode]
    if image.ndim != 3 or image.shape[1] != px or image.shape[2] != 3:
        raise ValueError(f"image must be (lines, {px}, 3) for {mode}")
    ev = _events_for(image, mode)
    # build the per-sample frequency track from event boundaries (exact
    # fractional durations: accumulate in float time, round per boundary)
    edges = np.cumsum([0.0] + [d for _, d in ev])
    n = int(round(edges[-1] * sample_rate))
    t_idx = np.arange(n) / sample_rate
    which = np.searchsorted(edges, t_idx, side="right") - 1
    which = np.clip(which, 0, len(ev) - 1)
    freqs = np.asarray([f for f, _ in ev])[which]
    phase = 2.0 * np.pi * np.cumsum(freqs) / sample_rate
    return (amplitude * np.cos(phase)).astype(np.float32)


def decode_vis(freq: np.ndarray, sample_rate: float):
    """Find the VIS header in a frequency track → (mode, sample index of
    the first scanline) or (None, 0)."""
    nbit = int(round(_T_BIT * sample_rate))
    # threshold 1250: must separate the 1200 Hz sync from the 1300 Hz "0"
    # data bit (1350 would merge the whole VIS into one run)
    sync = freq < 1250.0
    lead_win = int(20e-3 * sample_rate)
    i = 0
    n = len(freq)
    while i < n - 10 * nbit:
        if not sync[i]:
            i += 1
            continue
        run = i
        while run < n and sync[run]:
            run += 1
        dur = run - i
        # start-bit candidate: a ~30 ms sync run preceded by 1900 Hz leader
        lead = freq[max(0, i - lead_win):max(1, i - lead_win // 10)]
        if abs(dur - nbit) < nbit // 3 and np.mean(lead > 1700.0) > 0.7:
            # 8 bit cells (7 data LSB-first + even parity) after the start
            # bit; 1100 Hz = "1", 1300 Hz = "0" — read the cell median
            bits = []
            for b in range(8):
                c = i + nbit * (b + 1) + nbit // 2
                m = float(np.median(freq[c - nbit // 4:c + nbit // 4]))
                bits.append(1 if abs(m - 1100.0) < 100.0 else 0)
            data = sum(bit << k for k, bit in enumerate(bits[:7]))
            if sum(bits[:7]) % 2 == bits[7] and data in _BY_VIS:
                return _BY_VIS[data], i + 10 * nbit
        i = run
    return None, 0


def find_syncs(freq: np.ndarray, sample_rate: float, start: int = 0):
    """Start indices of line sync pulses (≥3 ms below 1250 Hz — the
    same 1200-vs-1300 separating threshold decode_vis explains)."""
    sync = (freq[start:] < 1250.0).astype(np.int8)
    d = np.diff(np.concatenate([[0], sync, [0]]))
    begins = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    min_len = int(3e-3 * sample_rate)
    keep = (ends - begins) >= min_len
    return begins[keep] + start


def decode_freq(freq: np.ndarray, sample_rate: float, mode: str | None = None):
    """Frequency track → (RGB image uint8, info).  VIS selects the mode
    when present; pass ``mode`` to force one."""
    detected, img_start = decode_vis(freq, sample_rate)
    if mode is None:
        mode = detected
    if mode is None:
        return np.zeros((0, 0, 3), np.uint8), {"mode": None, "lines": 0}
    _, px, t_scan, _ = MODES[mode]
    syncs = find_syncs(freq, sample_rate, img_start)
    t_px = t_scan / px
    rows = []
    for s in syncs:
        # line layout after the sync pulse: porch, G, sep, B, sep, R
        t0 = s / sample_rate + _T_SYNC + _T_PORCH
        line = np.zeros((px, 3), np.float64)
        for ci, chan in enumerate((1, 2, 0)):          # G, B, R slots
            base = t0 + ci * (t_scan + _T_PORCH)
            pos = (base + (np.arange(px) + 0.5) * t_px) * sample_rate
            if pos[-1] >= len(freq):
                break
            # interpolate within the scan's own samples (the same neighbours
            # and values as over the whole track)
            lo, hi = int(pos[0]), min(len(freq), int(pos[-1]) + 2)
            f = np.interp(pos, np.arange(lo, hi), freq[lo:hi])
            line[:, chan] = (f - _F_BLACK) * (255.0 / (_F_WHITE - _F_BLACK))
        else:
            rows.append(np.clip(line, 0.0, 255.0))
    img = (np.asarray(np.rint(rows), np.uint8) if rows
           else np.zeros((0, px, 3), np.uint8))
    return img, {"mode": mode, "lines": len(rows),
                 "vis_detected": detected is not None}


def track(rx: Block, audio: np.ndarray, block_size: int, device) -> np.ndarray:
    """``rx`` over ``audio`` in blocks of ``block_size`` on ``device``
    (state carried, the last block short); the host track."""
    dev = torch.device(device)
    st = rx.init(dev)
    outs = []
    for i in range(0, len(audio), block_size):
        x = torch.from_numpy(np.ascontiguousarray(audio[i:i + block_size], np.float32))
        st, y = rx.apply(st, x.to(dev))
        outs.append(y.cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros(0)


def decode_audio(audio: np.ndarray, sample_rate: float, mode: str | None = None,
                 block_size: int = 1 << 16, *, device="cuda"):
    """End to end: f32 audio → RGB image (the discriminator on ``device``,
    the framing on the host).  For files use Pipeline + CollectSink
    (``apps/sstv_decode.py``)."""
    freq = track(sstv_receiver(sample_rate), audio, block_size, device)
    return decode_freq(freq, sample_rate, mode)
