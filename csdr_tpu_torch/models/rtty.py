"""RTTY receiver — ITA2/Baudot radioteletype from dual-tone AFSK audio.

Counterpart of ``csdr_tpu/models/rtty.py``: 45.45 Bd (22 ms bits), 170 Hz
shift (mark 2125 / space 2295 Hz), 5-bit ITA2 characters framed as [1 start
space][5 data bits LSB first][≥ 1.5 stop marks], LTRS/FIGS shifts selecting
the page.  The sample-rate part is ``models/aprs.AFSKDiscriminator`` with
the RTTY tone pair, on the device; the asynchronous character framing (the
1.5-bit stop element is not on a fixed bit grid) and the ITA2 shift state
run on the host over the ~45 bit/s stream.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Block, chain
from .aprs import AFSKDiscriminator

__all__ = ["rtty_receiver", "decode_score", "ita2_decode", "ita2_encode", "rtty_modulate",
           "RTTY_BAUD", "RTTY_MARK", "RTTY_SPACE"]

RTTY_BAUD = 1000.0 / 22.0  # 45.45… Bd: the standard 22 ms bit
RTTY_MARK, RTTY_SPACE = 2125.0, 2295.0
_LTRS, _FIGS = 31, 27

# ITA2 pages (index = 5-bit code; \x00 entries are unused controls)
_LETTERS = list("\x00E\nA SIU\rDRJNFCKTZLWHYPQOBG\x00MXV\x00")
_FIGURES = list("\x003\n- '87\r$4\x07,!:(5+)2#6019?&\x00./=\x00")


def rtty_receiver(sample_rate: float, baud: float = RTTY_BAUD, mark: float = RTTY_MARK,
                  space: float = RTTY_SPACE) -> Block:
    """f32 audio at ``sample_rate`` (n·baud, n ≥ 8; 48 kHz = 1,056 samples
    per bit at 45.45 Bd) → per-sample mark/space score (> 0 = mark)."""
    k = sample_rate / baud
    if abs(k - round(k)) > 1e-6 * k or round(k) < 8:
        raise ValueError(f"RTTY needs sample_rate = n·{baud:.4g} with n ≥ 8, got {sample_rate}")
    return chain(AFSKDiscriminator(sample_rate, int(round(k)), mark, space,
                                   name=f"rtty(fs={sample_rate:g})"))


def _frames(levels: np.ndarray, k: float):
    """Start-edge hunt on per-sample mark levels: yields the 5 data bits of
    every well-framed character (start space held, stop mark)."""
    n = len(levels)
    pos = 1
    while True:
        edges = np.flatnonzero((levels[pos:-1] == 0) & (levels[pos - 1:-2] == 1))
        if not len(edges):
            return
        i = pos + int(edges[0])
        if i + 7.0 * k >= n:
            return
        if levels[i + round(0.5 * k)] != 0:  # the start bit did not hold
            pos = i + 1
            continue
        bits = [int(levels[i + round((1.5 + j) * k)]) for j in range(5)]
        if levels[i + round(6.5 * k)] != 1:  # the stop element must be mark
            pos = i + 1
            continue
        yield bits
        pos = i + round(7.0 * k)  # start + 5 data + 1.5 stop, then hunt again


def ita2_decode(codes: list[int]) -> str:
    out = []
    page = _LETTERS
    for c in codes:
        if c == _LTRS:
            page = _LETTERS
        elif c == _FIGS:
            page = _FIGURES
        else:
            out.append(page[c])
    return "".join(out)


def decode_score(score: np.ndarray, sample_rate: float, baud: float = RTTY_BAUD) -> str:
    """Per-sample score → text: asynchronous framing + ITA2 shift state."""
    k = sample_rate / baud
    levels = (np.asarray(score) > 0).astype(np.uint8)
    codes = [sum(b << j for j, b in enumerate(bits)) for bits in _frames(levels, k)]
    return ita2_decode(codes)


def ita2_encode(text: str) -> list[int]:
    """Text → ITA2 codes with LTRS/FIGS shifts (LTRS assumed at the start)."""
    codes = []
    page = _LETTERS
    for ch in text.upper():
        if ch in page:
            codes.append(page.index(ch))
            continue
        other = _FIGURES if page is _LETTERS else _LETTERS
        if ch not in other:
            raise ValueError(f"{ch!r} is not an ITA2 character")
        codes.append(_FIGS if other is _FIGURES else _LTRS)
        page = other
        codes.append(page.index(ch))
    return codes


def rtty_modulate(text: str, sample_rate: float, baud: float = RTTY_BAUD,
                  mark: float = RTTY_MARK, space: float = RTTY_SPACE,
                  idle_bits: float = 8.0) -> np.ndarray:
    """Text → continuous-phase dual-tone audio (the test transmitter): idle
    mark, then per character [start space][5 data LSB first][1.5 stop
    marks], trailing idle."""
    k = sample_rate / baud
    lv = [1.0] * round(idle_bits * k)
    for c in ita2_encode(text):
        lv += [0.0] * round(k)                      # start
        for j in range(5):
            lv += [float((c >> j) & 1)] * round(k)  # data, LSB first
        lv += [1.0] * round(1.5 * k)                # stop element
    lv += [1.0] * round(idle_bits * k)
    freqs = np.where(np.asarray(lv) > 0, mark, space)
    phase = 2.0 * np.pi * np.cumsum(freqs) / sample_rate
    return np.sin(phase).astype(np.float32)
