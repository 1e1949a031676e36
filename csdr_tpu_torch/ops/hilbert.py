"""Real ↔ complex conversion through a half-band Hilbert structure.

Counterpart of ``csdr_tpu/ops/hilbert.py`` (reference liquid ``firhilbf``,
semi-length 5, 60 dB): ``real_to_complex`` turns a real stream into IQ at
half the rate (2:1 decimation), ``complex_to_real`` is the inverse (1:2
interpolation).

The complex band-pass taps hc[k] = 2·h_hb[k]·e^{+jπk/2} select the
positive-frequency half [0, fs/2]; decimating by 2 maps it onto a full-band
complex stream centred at π.  The real input meets complex taps in the
polyphase path, where each real sub-stream times a complex tap promotes to
complex64 (``ops/fir._scalar`` keeps the tap complex).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.firdes import halfband_kaiser
from .fir import fir_decim_stream, fir_interp_stream

__all__ = ["hilbert_taps", "real_to_complex_init", "real_to_complex_stream",
           "complex_to_real_init", "complex_to_real_stream"]


@functools.lru_cache(maxsize=None)
def hilbert_taps(semilen: int = 5, as_db: float = 60.0) -> np.ndarray:
    h = halfband_kaiser(semilen, as_db) * 2.0  # unity half-band passband
    k = np.arange(len(h))
    hc = 2.0 * h * np.exp(1j * np.pi * k / 2.0)
    return hc.astype(np.complex64)


def real_to_complex_init(device: torch.device, semilen: int = 5) -> torch.Tensor:
    K = len(hilbert_taps(semilen))
    return torch.zeros((K - 1,), dtype=torch.float32, device=device)


def real_to_complex_stream(state: torch.Tensor, x: torch.Tensor, semilen: int = 5,
                           as_db: float = 60.0):
    """Real (..., n), n even → complex (..., n/2), spectrum centred at π."""
    hc = hilbert_taps(semilen, as_db)
    return fir_decim_stream(hc, 2, state, x, strategy="poly")


def complex_to_real_init(device: torch.device, semilen: int = 5) -> torch.Tensor:
    K = len(hilbert_taps(semilen))
    Lsub = -(-K // 2)
    return torch.zeros((Lsub - 1,), dtype=torch.complex64, device=device)


def complex_to_real_stream(state: torch.Tensor, x: torch.Tensor, semilen: int = 5,
                           as_db: float = 60.0):
    """Complex (..., n) → real (..., 2n): interpolate by 2 against the same
    positive-frequency band-pass (the analytic image at +π/2) and take twice
    the real part."""
    hc = hilbert_taps(semilen, as_db)
    state, y = fir_interp_stream(hc, 2, state, x)
    return state, (2.0 * y.real).to(torch.float32).contiguous()
