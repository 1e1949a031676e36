"""Morse (CW) decoder — keyed-carrier envelope to text.

Counterpart of ``csdr_tpu/models/morse.py``, the decoder behind the DeCW
audio (``blocks.cw_demodulator`` makes the audible side tone; this decodes
the keying).  On the device ``cw_envelope`` is the narrow CW low-pass and
the magnitude, |lowpass(x)|: ``cw_demodulator``'s path without the BFO.  On
the host: an adaptive threshold and run-length classification against the
ITU-R M.1677 element ratios (dit 1, dah 3, gap 1 within a character, 3
between characters, 7 between words), the unit time estimated from the
run lengths, so any speed decodes without configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import FIRFilter
from ..core.block import Block, Lambda, chain
from ..utils import firdes

__all__ = ["cw_envelope", "decode_envelope", "MORSE_TABLE"]

_CODE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "/": "-..-.", "=": "-...-",
    "+": ".-.-.", "-": "-....-", "@": ".--.-.",
}
MORSE_TABLE = {v: k for k, v in _CODE.items()}


def cw_envelope(bandwidth: float = 0.002, as_db: float = 60.0) -> Block:
    """Complex baseband (carrier at DC) → keying envelope |lowpass(x)| at
    the same rate; ``bandwidth`` is normalized to the sample rate."""
    if not (0.0 < bandwidth < 0.5):
        raise ValueError(f"cw bandwidth {bandwidth} not in (0, 0.5) of fs")
    n = firdes.kaiser_filter_len(max(0.5 * bandwidth, 0.001), as_db)
    lp = FIRFilter(firdes.kaiser_lowpass(n, bandwidth / 2.0, as_db),
                   complex_input=True, name=f"cw_env({bandwidth:.4g})")
    return chain(lp, Lambda(torch.abs, name="mag"))


def _runs(keyed: np.ndarray) -> list[tuple[int, int]]:
    """(value, length) run-length encoding."""
    edges = np.flatnonzero(np.diff(keyed)) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [len(keyed)]])
    return [(int(keyed[s]), int(e - s)) for s, e in zip(starts, ends)]


def decode_envelope(env: np.ndarray, threshold: float | None = None) -> str:
    """Envelope → text.  Threshold defaults to half the 95th percentile
    (robust to absolute level); the dit length is the median ON run (dits
    outnumber dahs in natural text and the two cluster 1:3 apart)."""
    env = np.asarray(env, np.float64)
    if threshold is None:
        threshold = 0.5 * np.percentile(env, 95)
    if threshold <= 0:
        return ""
    keyed = (env > threshold).astype(np.uint8)
    runs = [r for r in _runs(keyed)]
    on_lens = np.array([ln for v, ln in runs if v == 1], np.float64)
    if len(on_lens) == 0:
        return ""
    shortest = np.percentile(on_lens, 10)
    unit = float(np.median(on_lens[on_lens < 2.0 * shortest]))
    out: list[str] = []
    sym = ""

    def flush(sym: str) -> str:
        return MORSE_TABLE.get(sym, "�") if sym else ""

    for v, ln in runs:
        u = ln / unit
        if v == 1:
            sym += "." if u < 2.0 else "-"
        else:
            if u < 2.0:
                continue  # intra-character gap
            out.append(flush(sym))
            sym = ""
            if u >= 5.0:
                out.append(" ")  # word gap
    out.append(flush(sym))
    return "".join(out).strip()
