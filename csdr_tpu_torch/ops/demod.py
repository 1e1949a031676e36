"""Demodulators: FM, y[n] = arg(x[n]·conj(x[n−1])) / (2π·kf), and the AM
envelope.

Counterpart of ``csdr_tpu/ops/demod.py`` (``freqdem_stream``, ``amdem``).
Works along the last axis, so a (nch, n) channel panel with (nch, 1)
carried samples demodulates every channel at once (``core/block.PerChannel``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["freqdem_stream", "amdem"]

_TWO_PI = 2.0 * np.pi


def freqdem_stream(last: torch.Tensor, x: torch.Tensor, kf: float):
    """``last`` is the previous block's final sample, shaped (..., 1).
    Returns (new_last, y) with y float32 and the shape of ``x``."""
    prev = torch.cat([last, x[..., :-1]], dim=-1)
    d = x * prev.conj()
    y = torch.angle(d) * np.float32(1.0 / (_TWO_PI * kf))
    return x[..., -1:], y.to(torch.float32)


def amdem(x: torch.Tensor, mod_index: float = 0.8, suppressed: bool = False) -> torch.Tensor:
    """AM envelope demodulation (reference ampmodem, mod index 0.8, DSB).
    Carrier present: s = (1 + index·m)/(1 + index) ⇒ m = (|s|·(1 + index) − 1)/index;
    suppressed carrier: m = |s|/index.  float32 out."""
    env = x.abs()
    if suppressed:
        return (env / np.float32(mod_index)).to(torch.float32)
    return ((env * np.float32(1.0 + mod_index) - 1.0) / np.float32(mod_index)).to(torch.float32)
