"""RDS (Radio Data System): PS name and RadioText from the 57 kHz
subcarrier of an FM broadcast composite.

Counterpart of ``csdr_tpu/models/rds.py``:

  * the 57 kHz carrier is the third harmonic of the 19 kHz pilot, so it is
    u³ of the normalized analytic pilot (``stereo.pilot_subcarrier``), for
    every sample at once;
  * the 1187.5 baud bit clock: a biphase matched filter, then the bit phase
    of greatest energy over the 16 samples per bit at the exact rational
    rate 19 kHz = 16 × 1187.5;
  * differential decoding (m[n] = t[n] ⊕ t[n−1]) removes the BPSK polarity;
  * time-sharded, the baseband uses the stereo decoder's primitives and the
    slicer sums its 16 phase energies over the time ranks, so every rank
    takes the block's one bit phase;
  * block and group sync and the text are bit-level protocol work on the
    host (EN 50067): 26-bit blocks of 16 data bits and a 10-bit CRC xor an
    offset word, whose syndrome is the offset word itself.  That layer is
    pure Python and numpy, copied.

Typical graph, a Tee with the stereo decoder off one FM demod:
``Tee(stereo_fm_decoder(q, d), rds_receiver(q))``, the bits into
``decode_groups``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, chain
from ..ops import fir as fir_ops
from ..utils import firdes
from .. import blocks as B
from .stereo import delay_line, pilot_phases, pilot_subcarrier, shard_delay_line

__all__ = ["RDSBaseband", "RDSBitSlicer", "rds_receiver", "crc10", "encode_block",
           "syndrome", "make_group_0a", "make_group_2a", "bits_from_groups", "decode_groups",
           "RDS_BAUD", "SAMPLES_PER_BIT"]

_TWO_PI = 2.0 * np.pi

RDS_CARRIER_HZ = 57000.0
RDS_BAUD = 1187.5          # = 57000 / 48
SAMPLES_PER_BIT = 16       # at the internal 19 kHz rate
RDS_RATE_HZ = RDS_BAUD * SAMPLES_PER_BIT  # 19 kHz, the pilot's frequency


class RDSBaseband(Block):
    """FM composite (real, quad_rate) → RDS baseband (real, quad_rate):
    Re{cd · conj(u³)} low-passed to the ±2.4 kHz biphase band, cd the
    composite delayed by the pilot filter's group delay.  The data filter
    has round(quad_rate/600) | 1 taps (333 at 200 kHz), so on the card the
    ``auto`` FIR strategy runs it on K5."""

    def __init__(self, quad_rate: float, pilot_fir_halfband_hz: float = 800.0,
                 data_cutoff_hz: float = 2400.0):
        self.quad_rate = quad_rate
        self.omega19 = _TWO_PI * 19000.0 / quad_rate
        nfir = int(round(quad_rate / 1350.0))
        self.h_pilot = firdes.kaiser_lowpass(nfir, pilot_fir_halfband_hz / quad_rate, 60.0)
        self.gdelay = int(round(firdes.group_delay(self.h_pilot, 100.0 / quad_rate)))
        ntaps = int(round(quad_rate / 600.0)) | 1
        self.h_data = firdes.kaiser_lowpass(ntaps, data_cutoff_hz / quad_rate, 60.0)
        self.name = f"rds_baseband({quad_rate:.0f})"

    def init(self, device: torch.device):
        return dict(
            phase19=torch.zeros((), dtype=torch.float32, device=device),
            pilot_hist=torch.zeros((len(self.h_pilot) - 1,), dtype=torch.complex64,
                                   device=device),
            delay_buf=torch.zeros((self.gdelay,), dtype=torch.float32, device=device),
            data_hist=torch.zeros((len(self.h_data) - 1,), dtype=torch.float32, device=device),
        )

    def apply(self, state, c):
        theta0, new_phase = pilot_phases(self.omega19, state["phase19"], c.shape[-1])
        return self._process(state, c, theta0, new_phase, fir_ops.fir_stream, delay_line)

    def _process(self, state, c, theta0, new_phase, fir_fn, delay_fn):
        s = dict(state)
        s["pilot_hist"], u = pilot_subcarrier(self.omega19, self.gdelay, theta0, c,
                                              self.h_pilot, s["pilot_hist"], fir_fn)
        s["phase19"] = new_phase
        sub57 = u * u * u  # e^{j3(ω19(n−gd)+θp)}: the RDS carrier
        s["delay_buf"], cd = delay_fn(s["delay_buf"], c)
        bb = (cd.to(torch.complex64) * sub57.conj()).real
        s["data_hist"], y = fir_fn(self.h_data, s["data_hist"], bb)
        return s, y

    def shard_apply(self, state, c, ctx):
        """The stereo decoder's sharded primitives: the pilot NCO from the
        per-rank float64 phase, the FIRs (the data filter on K5 on the
        card) and the group-delay line from the left neighbour."""
        theta0, new_phase = pilot_phases(self.omega19, state["phase19"], c.shape[-1], ctx)
        return self._process(state, c, theta0, new_phase, ctx.fir,
                             lambda buf, x: shard_delay_line(ctx, buf, x))

    def shard_validate(self, nloc, ctx):
        halo = max(len(self.h_pilot) - 1, len(self.h_data) - 1, self.gdelay)
        if nloc < halo:
            raise ValueError(f"{self.name}: local segment {nloc} shorter than the largest "
                             f"halo {halo}: use a larger block or fewer time shards")
        return nloc


class RDSBitSlicer(Block):
    """RDS baseband at 19 kHz → data bits at 1187.5 bps: a biphase matched
    filter ([+1]×8 ++ [−1]×8)/16, the bit phase of greatest energy over the
    16 stride offsets (the clock is pilot-locked, so the phase is steady),
    the sign, and the differential decode across blocks.  The bit phase is
    the first maximum, as ``jnp.argmax`` and ``torch.argmax`` both take it."""

    rate = Fraction(1, SAMPLES_PER_BIT)
    granule = SAMPLES_PER_BIT

    def __init__(self):
        k = SAMPLES_PER_BIT
        self.h_bi = np.concatenate([np.ones(k // 2), -np.ones(k // 2)]) / k
        self.name = "rds_bits"

    def init(self, device: torch.device):
        # (matched filter history, previous raw bit); the JAX package keeps
        # the bit as uint32, the port as uint8 (utils/convert maps it)
        return (torch.zeros((SAMPLES_PER_BIT - 1,), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.uint8, device=device))

    def matched(self, hist, x):
        """(new history, the matched filter's output as (bits, 16) rows,
        the chosen bit phase)."""
        k = SAMPLES_PER_BIT
        hist, y = fir_ops.fir_stream(self.h_bi, hist, x)
        rows = y[..., : (x.shape[-1] // k) * k].reshape(-1, k)
        return hist, rows, torch.argmax((rows * rows).sum(dim=0))

    def apply(self, state, x):
        hist, prev_raw = state
        hist, rows, ph = self.matched(hist, x)
        raw = (rows[:, ph] > 0).to(torch.uint8)
        prevs = torch.cat([prev_raw.reshape(1), raw[:-1]])
        return (hist, raw[-1].clone()), torch.bitwise_xor(raw, prevs)

    def shard_apply(self, state, x, ctx):
        """The bit phase is one decision for the whole block: the per-phase
        energies are summed over the time ranks (``sum_time``), so every
        rank takes the same phase (16 | nloc keeps the bit grid aligned
        across ranks).  The differential decode takes its previous raw bit
        from the left neighbour."""
        hist, prev_raw = state
        k = SAMPLES_PER_BIT
        new_hist, y = ctx.fir(self.h_bi, hist, x)
        rows = y[..., : (x.shape[-1] // k) * k].reshape(-1, k)
        ph = torch.argmax(ctx.sum_time((rows * rows).sum(dim=0)))
        raw = (rows[:, ph] > 0).to(torch.uint8)
        prev0 = ctx.left_halo(raw, prev_raw.reshape(1), 1)
        bits = torch.bitwise_xor(raw, torch.cat([prev0, raw[:-1]]))
        return (new_hist, ctx.from_last_time(raw[-1].clone())), bits

    def shard_validate(self, nloc, ctx):
        if nloc % SAMPLES_PER_BIT:
            raise ValueError(f"{self.name}: local segment {nloc} not a multiple of "
                             f"{SAMPLES_PER_BIT}")
        return nloc // SAMPLES_PER_BIT


def rds_receiver(quad_rate: float) -> Block:
    """Composite (real, quad_rate) → RDS data bits (uint8, 1187.5 bps)."""
    ratio = Fraction(int(round(RDS_RATE_HZ)), int(round(quad_rate)))
    stages = [RDSBaseband(quad_rate)]
    if ratio != 1:
        stages.append(B.RationalResampler(ratio.numerator, ratio.denominator,
                                          complex_input=False))
    stages.append(RDSBitSlicer())
    return chain(*stages)


# ---------------------------------------------------------------------------
# Host-side protocol layer (EN 50067): CRC, offsets, block and group sync.
# ---------------------------------------------------------------------------

_G = 0b10110111001  # g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1

OFFSETS = {  # EN 50067 Annex A offset words
    "A": 0b0011111100,
    "B": 0b0110011000,
    "C": 0b0101101000,
    "Cp": 0b1101010000,
    "D": 0b0110110100,
}


def _poly_mod(v: int, nbits: int) -> int:
    """Remainder of the nbits-bit word v modulo g(x) over GF(2)."""
    for i in range(nbits - 1, 9, -1):
        if v >> i & 1:
            v ^= _G << (i - 10)
    return v


def crc10(m16: int) -> int:
    """10-bit checkword of a 16-bit message: m(x)·x^10 mod g."""
    return _poly_mod((m16 & 0xFFFF) << 10, 26)


def encode_block(m16: int, offset: str) -> int:
    """26-bit block: message ++ (checkword ⊕ offset word)."""
    return ((m16 & 0xFFFF) << 10) | (crc10(m16) ^ OFFSETS[offset])


def syndrome(v26: int) -> int:
    """A valid block's syndrome is its offset word: the codeword part is
    ≡ 0 mod g, and the 10-bit offset is its own remainder."""
    return _poly_mod(v26 & ((1 << 26) - 1), 26)


def make_group_0a(pi: int, seg: int, two_chars: str, pty: int = 0) -> list[int]:
    """Group 0A (basic tuning, PS name): 4 blocks of 26 bits."""
    b2 = ((pty & 0x1F) << 5) | (seg & 0x3)
    b3 = 0xE0E0  # AF: "no AF exists" filler codes
    b4 = (ord(two_chars[0]) << 8) | ord(two_chars[1])
    return [encode_block(pi, "A"), encode_block(b2, "B"),
            encode_block(b3, "C"), encode_block(b4, "D")]


def make_group_2a(pi: int, seg: int, four_chars: str, pty: int = 0) -> list[int]:
    """Group 2A (RadioText): 4 chars per group, 16 segments."""
    b2 = (0x2 << 12) | ((pty & 0x1F) << 5) | (seg & 0xF)
    b3 = (ord(four_chars[0]) << 8) | ord(four_chars[1])
    b4 = (ord(four_chars[2]) << 8) | ord(four_chars[3])
    return [encode_block(pi, "A"), encode_block(b2, "B"),
            encode_block(b3, "C"), encode_block(b4, "D")]


def bits_from_groups(groups: list[list[int]]) -> np.ndarray:
    """Serialize groups in over-the-air order (MSB first per block),
    differentially encoded (t[n] = m[n] ⊕ t[n−1]): the transmit side of
    ``RDSBitSlicer``'s decode."""
    msg = []
    for g in groups:
        for blk in g:
            msg.extend((blk >> i) & 1 for i in range(25, -1, -1))
    out = np.zeros(len(msg), dtype=np.uint8)
    t = 0
    for i, m in enumerate(msg):
        t ^= m
        out[i] = t
    return out


def decode_groups(bits: np.ndarray) -> dict:
    """Sliding block sync and group assembly over a decoded bitstream.
    Returns {"pi", "ps", "rt", "groups"}; robust to an unknown bit offset."""
    bits = np.asarray(bits).astype(np.uint8).reshape(-1)
    n = len(bits)
    vals = np.zeros(max(n - 25, 0), dtype=np.int64)  # 26-bit windows as integers
    acc = 0
    for i in range(min(26, n)):
        acc = (acc << 1) | int(bits[i])
    if n >= 26:
        vals[0] = acc
        mask = (1 << 26) - 1
        for i in range(26, n):
            acc = ((acc << 1) | int(bits[i])) & mask
            vals[i - 25] = acc
    synd = np.array([syndrome(int(v)) for v in vals], dtype=np.int64)

    offA, offB, offC, offCp, offD = (OFFSETS[k] for k in ("A", "B", "C", "Cp", "D"))
    ps = [None] * 8
    rt = [None] * 64
    pi_votes: dict[int, int] = {}
    ngroups = 0
    i = 0
    while i + 78 < len(synd):  # blocks at i, i+26, i+52, i+78
        if (synd[i] == offA and synd[i + 26] == offB
                and synd[i + 52] in (offC, offCp) and synd[i + 78] == offD):
            b1, b2 = int(vals[i]) >> 10, int(vals[i + 26]) >> 10
            b3, b4 = int(vals[i + 52]) >> 10, int(vals[i + 78]) >> 10
            pi_votes[b1] = pi_votes.get(b1, 0) + 1
            gtype, version = b2 >> 12, (b2 >> 11) & 1
            if gtype == 0 and version == 0:
                seg = b2 & 0x3
                ps[2 * seg] = chr((b4 >> 8) & 0x7F)
                ps[2 * seg + 1] = chr(b4 & 0x7F)
            elif gtype == 2 and version == 0:
                seg = b2 & 0xF
                for j, ch in enumerate((b3 >> 8, b3 & 0xFF, b4 >> 8, b4 & 0xFF)):
                    rt[4 * seg + j] = chr(ch & 0x7F)
            ngroups += 1
            i += 104
        else:
            i += 1
    return {
        "pi": max(pi_votes, key=pi_votes.get) if pi_votes else None,
        "ps": "".join(c or " " for c in ps).rstrip() if any(ps) else "",
        "rt": "".join(c or " " for c in rt).rstrip() if any(rt) else "",
        "groups": ngroups,
    }
