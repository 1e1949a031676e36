"""APRS receiver — AFSK1200 (Bell 202) AX.25 UI frames from NBFM audio.

Counterpart of ``csdr_tpu/models/aprs.py``: 1200 baud AFSK, mark 1200 Hz /
space 2200 Hz, NRZI, HDLC and CRC-16/X-25 (``models/hdlc.py``, shared with
AIS), AX.25 addressing.  On the device (``afsk1200_receiver``) a
non-coherent dual-tone discriminator: two NCO mixers bring each tone to DC,
a one-bit moving-average FIR integrates it, and the score is |mark| −
|space|.  On the host: bit-centre sampling, the HDLC layer and the AX.25
address parse.
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import FIRFilter, mix_down
from ..core.block import Block, chain
from .hdlc import frame_to_wire_bits, hdlc_frames, sample_bits

__all__ = ["AFSKDiscriminator", "afsk1200_receiver", "bits_from_score", "decode_score",
           "parse_ax25", "make_ax25_ui", "aprs_burst_bits", "afsk_modulate", "APRS_BAUD"]

APRS_BAUD = 1200.0
F_MARK, F_SPACE = 1200.0, 2200.0
_TWO_PI = 2.0 * np.pi


class AFSKDiscriminator(Block):
    """Dual-tone non-coherent discriminator: per tone a ``Mixer`` (mix down)
    and a one-bit moving-average ``FIRFilter`` over the complex product;
    score = |mark| − |space| (float32).  Tones default to Bell 202;
    ``models/rtty.py`` reuses it with the 170 Hz RTTY pair.  State: per
    tone (mixer phase, FIR history), the JAX block's nesting."""

    def __init__(self, sample_rate: float, k: int, f_mark: float = F_MARK,
                 f_space: float = F_SPACE, name: str | None = None):
        ma = np.ones(k) / k
        self.parts = tuple(
            (mix_down(_TWO_PI * f / sample_rate),
             FIRFilter(ma, complex_input=True, name=f"ma({f:g})"))
            for f in (f_mark, f_space))
        self.name = name or f"afsk1200(fs={sample_rate:g})"

    def init(self, device: torch.device):
        return tuple((mx.init(device), fr.init(device)) for mx, fr in self.parts)

    def _run(self, state, x, step):
        new_state, mags = [], []
        for (mx, fr), (sm, sf) in zip(self.parts, state):
            sm, y = step(mx, sm, x)
            sf, y = step(fr, sf, y)
            new_state.append((sm, sf))
            mags.append(y.abs())
        return tuple(new_state), mags[0] - mags[1]

    def apply(self, state, x):
        return self._run(state, x, lambda b, s, v: b.apply(s, v))

    def shard_apply(self, state, x, ctx):
        """Each part on its own ctx: the mixers' per-rank float64 phase
        (no collective), the moving averages' left halos."""
        return self._run(state, x, lambda b, s, v: b.shard_apply(s, v, ctx.clone()))

    def shard_validate(self, nloc, ctx):
        for mx, fr in self.parts:
            mx.shard_validate(nloc, ctx.clone())
            fr.shard_validate(nloc, ctx.clone())
        return nloc


def afsk1200_receiver(sample_rate: float) -> Block:
    """f32 NBFM audio at ``sample_rate`` (n·1200, n ≥ 8) → the mark/space
    score at the same rate (> 0 = mark = bit level 1)."""
    k = sample_rate / APRS_BAUD
    if abs(k - round(k)) > 1e-9 or round(k) < 8:
        raise ValueError(f"AFSK1200 needs sample_rate = n·1200 with n ≥ 8, got {sample_rate}")
    return chain(AFSKDiscriminator(sample_rate, int(round(k))))


def bits_from_score(score: np.ndarray, sample_rate: float) -> np.ndarray:
    """Bit-centre sampling (``models/hdlc.sample_bits``)."""
    return sample_bits(score, int(round(sample_rate / APRS_BAUD)))


def decode_score(score: np.ndarray, sample_rate: float) -> list[dict]:
    levels = bits_from_score(score, sample_rate)
    out = []
    for frame in hdlc_frames(levels):
        msg = parse_ax25(frame)
        if msg is not None:
            out.append(msg)
    return out


def parse_ax25(frame: bytes) -> dict | None:
    """AX.25 UI frame: 7-byte address units (callsign characters shifted
    left by 1; the SSID byte's LSB ends the list), control, PID, info."""
    addrs = []
    i = 0
    while True:
        if i + 7 > len(frame) or len(addrs) > 10:
            return None
        unit = frame[i:i + 7]
        call = "".join(chr(b >> 1) for b in unit[:6]).strip()
        ssid = (unit[6] >> 1) & 0x0F
        addrs.append(f"{call}-{ssid}" if ssid else call)
        i += 7
        if unit[6] & 1:
            break
    if len(addrs) < 2 or i + 2 > len(frame):
        return None
    return {"dst": addrs[0], "src": addrs[1], "via": addrs[2:],
            "control": frame[i], "pid": frame[i + 1],
            "info": frame[i + 2:].decode("latin1")}


def make_ax25_ui(src: str, dst: str, info: str, via: tuple = ()) -> bytes:
    def unit(call: str, last: bool) -> bytes:
        base, _, ssid = call.partition("-")
        b = bytes((ord(c) << 1) & 0xFF for c in f"{base:<6}"[:6])
        return b + bytes([((int(ssid or 0) & 0x0F) << 1) | 0x60 | (1 if last else 0)])

    addrs = [dst, src] + list(via)
    hdr = b"".join(unit(a, i == len(addrs) - 1) for i, a in enumerate(addrs))
    return hdr + bytes([0x03, 0xF0]) + info.encode("latin1")


def aprs_burst_bits(frame: bytes, training: int = 48) -> np.ndarray:
    """AX.25 frame bytes → over-the-air bit levels (the shared HDLC encoder)."""
    return frame_to_wire_bits(frame, training)


def afsk_modulate(levels: np.ndarray, sample_rate: float) -> np.ndarray:
    """Continuous-phase Bell 202 tones: level 1 = 1200 Hz mark, level 0 =
    2200 Hz space (the test transmitter)."""
    k = int(round(sample_rate / APRS_BAUD))
    freqs = np.where(np.repeat(np.asarray(levels, np.uint8), k) == 1, F_MARK, F_SPACE)
    phase = _TWO_PI * np.cumsum(freqs) / sample_rate
    return np.sin(phase).astype(np.float32)
