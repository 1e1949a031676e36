"""GMSK demodulator block — counterpart of ``csdr_tpu/blocks/gmsk.py``.

FM discriminator → GMSK receive matched filter (``ops/fir``) → strided
symbol sampling at the matched filter's peak → sign slicer, with no
per-symbol loop.  Works along the last axis, so inside ``PerChannel`` a
(nch, n) panel runs every channel at once.  The bits are uint8 (the JAX
block emits uint32 of the same values).  Time-sharded, both carried tails
come from the left neighbour and the symbol stride stays aligned because
every local segment is a multiple of k, so the bits equal serial's.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block
from ..ops.demod import freqdem_stream
from ..ops.fir import fir_stream
from ..utils import firdes

__all__ = ["GMSKDemod", "gmsk_demodulator", "gmsk_mod"]


class GMSKDemod(Block):
    """k samples in, one bit out.  State: (previous input sample (1,)
    complex64, matched-filter history (K − 1,) float32)."""

    def __init__(self, m: int, k: int, bw: float = 0.3):
        self.m, self.k, self.bw = m, k, bw
        self.taps = firdes.gmsk_rx(k, m, bw)
        self.rate = Fraction(1, k)
        self.granule = k
        self.name = f"gmsk_demod(m={m},k={k})"
        # symbols are block-aligned: the transmit pulse's delay (m·k) and the
        # matched filter's (m·k) add to 0 mod k
        self.offset = (2 * m * k) % k

    def init(self, device: torch.device):
        return (torch.ones((1,), dtype=torch.complex64, device=device),
                torch.zeros((len(self.taps) - 1,), dtype=torch.float32, device=device))

    def apply(self, state, x):
        last, hist = state
        kf = 0.25 / self.k  # ±π/(2k) per sample of deviation → ±1 levels
        last, d = freqdem_stream(last, x, kf)
        hist, y = fir_stream(self.taps, hist, d)
        sym = y[..., self.offset::self.k]
        return (last, hist), (sym > 0).to(torch.uint8)

    def shard_apply(self, state, x, ctx):
        """The demod's previous sample and the matched filter's history
        from the left neighbour (``ctx.fir``), each carried from the last
        time rank."""
        last, hist = state
        prev = ctx.left_halo(x, last, 1)
        _, d = freqdem_stream(prev, x, 0.25 / self.k)
        new_last = ctx.from_last_time(x[..., -1:].contiguous())
        new_hist, y = ctx.fir(self.taps, hist, d)
        sym = y[..., self.offset::self.k]
        return (new_last, new_hist), (sym > 0).to(torch.uint8)

    def shard_validate(self, nloc, ctx):
        if nloc % self.granule:
            raise ValueError(f"{self.name}: local segment {nloc} not a multiple of k={self.k}")
        if nloc < len(self.taps) - 1:
            raise ValueError(f"{self.name}: local segment {nloc} shorter than the "
                             f"matched-filter halo {len(self.taps) - 1}")
        return nloc // self.k


def gmsk_demodulator(m: int, k: int, bw: float = 0.3) -> Block:
    return GMSKDemod(m, k, bw)


def gmsk_mod(bits: np.ndarray, k: int, m: int, bw: float = 0.3) -> np.ndarray:
    """GMSK modulator (Gaussian-filtered MSK, h = 0.5), the test
    transmitter: bits → complex64 baseband at k samples per bit."""
    a = np.asarray(bits, dtype=np.float64) * 2.0 - 1.0
    g = firdes.gmsk_tx(k, m, bw)  # sums to 1 over one symbol
    up = np.zeros(len(a) * k)
    up[::k] = a
    inst = np.convolve(up, g)[: len(a) * k]
    phase = np.pi / 2.0 * np.cumsum(inst)
    return np.exp(1j * phase).astype(np.complex64)
