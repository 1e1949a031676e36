"""DSP blocks of the channelized FM slice — counterparts of the blocks of
the same names in ``csdr_tpu/blocks/__init__.py``.

Reference export          → here
------------------------------------------------------------------
fmDemodulator kf          → fm_demodulator(kf)
dcBlocker                 → dc_blocker()
firpfbchChannelizer n     → firpfbch_channelizer(nch)
automaticGainControl t    → automatic_gain_control(t)
(cu8 capture input)       → u8_to_iq()
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, TailStateBlock
from ..ops import agc as agc_ops
from ..ops import demod as demod_ops
from ..ops import iir as iir_ops
from ..ops import nco as nco_ops
from ..ops import pfb as pfb_ops

__all__ = ["u8_to_iq", "fm_demodulator", "dc_blocker", "firpfbch_channelizer",
           "automatic_gain_control", "U8ToIQ", "FMDemod", "DCBlocker", "PFBChannelizer",
           "AGC"]


class U8ToIQ(Block):
    """rtl_sdr cu8 capture → complex64, on the device, so the host→device
    copy carries 2 bytes per sample instead of 8.  The port's cu8 stream is
    (n, 2) uint8 rows, one row per IQ sample, so this block is 1:1 in
    samples (the JAX package's ``u8_to_iq`` takes the flat (2n,) bytes)."""

    name = "u8_to_iq"

    def apply(self, state, x):
        f = (x.to(torch.float32) - 127.5) * np.float32(1.0 / 127.5)
        return state, torch.complex(f[:, 0], f[:, 1])


def u8_to_iq() -> Block:
    return U8ToIQ()


class FMDemod(TailStateBlock):
    """FM demodulator (reference fmDemodulator).  State = previous input
    sample."""

    tail_len = 1

    def __init__(self, kf: float):
        self.kf = float(kf)
        self.name = f"fm_demod({kf})"

    def init(self, device: torch.device):
        # previous sample of unit magnitude and zero phase, not zero
        return torch.ones((1,), dtype=torch.complex64, device=device)

    def apply(self, state, x):
        return demod_ops.freqdem_stream(state, x, self.kf)


def fm_demodulator(kf: float) -> Block:
    return FMDemod(kf)


class DCBlocker(Block):
    """IQ DC notch (reference dcBlocker, α = 0.0005)."""

    def __init__(self, alpha: float = 0.0005, complex_input: bool = True):
        self.alpha = alpha
        self.complex_input = complex_input
        self.name = "dc_blocker"

    def init(self, device: torch.device):
        return iir_ops.dc_blocker_init(device, self.complex_input)

    def apply(self, state, x):
        return iir_ops.dc_blocker_stream(state, x, self.alpha)


def dc_blocker(alpha: float = 0.0005, complex_input: bool = True) -> Block:
    return DCBlocker(alpha, complex_input)


class PFBChannelizer(Block):
    """Polyphase filterbank channelizer with the reference's NCO pre-shift:
    (n,) complex → (nch, n/nch); channel k centred at 2π(k − (nch−1)/2)/nch."""

    def __init__(self, nch: int, m: int = 7, as_db: float = 80.0):
        self.nch, self.m, self.as_db = nch, m, as_db
        self.rate = Fraction(1, nch)
        self.granule = nch
        self.name = f"pfb_channelizer({nch})"

    def init(self, device: torch.device):
        return (torch.zeros((), dtype=torch.float32, device=device),
                pfb_ops.pfb_analyze_init(self.nch, device, self.m))

    def apply(self, state, x):
        phase, pfb_state = state
        phase, shifted = nco_ops.mix_stream(phase, x, pfb_ops.pfb_offset(self.nch), up=False)
        pfb_state, y = pfb_ops.pfb_analyze_stream(pfb_state, shifted, self.nch, self.m,
                                                  self.as_db)
        return (phase, pfb_state), y


def firpfbch_channelizer(nch: int, **kw) -> Block:
    return PFBChannelizer(nch, **kw)


class AGC(Block):
    """AGC with squelch (reference automaticGainControl: bandwidth 0.1,
    signal level 1e-3).  State (ln_gain, prev_above); inside ``PerChannel``
    both gain a leading channel axis."""

    def __init__(self, squelch_threshold_db: float | None, bandwidth: float = 0.1,
                 signal_level: float = 1e-3):
        self.squelch_threshold_db = squelch_threshold_db
        self.bandwidth = bandwidth
        self.signal_level = signal_level
        self.name = f"agc({squelch_threshold_db})"

    def init(self, device: torch.device):
        return agc_ops.agc_init(device, self.signal_level)

    def apply(self, state, x):
        return agc_ops.agc_stream(state, x, self.bandwidth, self.squelch_threshold_db)


def automatic_gain_control(threshold_db: float) -> Block:
    return AGC(threshold_db)
