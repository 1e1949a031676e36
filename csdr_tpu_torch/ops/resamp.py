"""Rational polyphase resampling (the last stage of the multi-stage
resampler).

Counterpart of ``csdr_tpu/ops/resamp.py``: the requested rate is realized
exactly as a rational P/Q (continued fractions, denominator ≤ 1024), so a
block of k·Q inputs yields exactly k·P outputs.  Works along the last axis
with any leading batch axes.  The stage is a polyphase interpolator

    y[m] = Σ_l h_{phase[m]}[l] · x[base[m] − l],
    base[m] = ⌊m·Q/P⌋,  phase[m] = (m·Q) mod P,

both periodic in m with period P, so each (s, l) term is one strided slice
(stride Q); for awkward rationals (P·L > 2048) a gather form selects each
output's window and tap row instead.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from ..utils.firdes import kaiser_beta, kaiser_filter_len

__all__ = ["rational_approx", "rational_taps", "rational_resample_init",
           "rational_resample_stream"]

_GATHER_ABOVE = 2048  # P·L above which the gather form replaces the slices


def rational_approx(rate: float, max_den: int = 1024) -> Fraction:
    f = Fraction(rate).limit_denominator(max_den)
    if f <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    return f


@functools.lru_cache(maxsize=None)
def rational_taps(P: int, Q: int, as_db: float = 60.0) -> np.ndarray:
    """(P, L) float32 polyphase tap matrix for up-P/down-Q resampling:
    a Kaiser low-pass at the upsampled rate, cutoff 0.5·min(1/P, 1/Q),
    transition 20 % of the cutoff, gain P."""
    cutoff = 0.5 / max(P, Q)
    n = kaiser_filter_len(0.2 * cutoff, as_db)
    L = -(-n // P)  # taps per phase
    n = L * P
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * t)
    h *= np.kaiser(n, kaiser_beta(as_db))
    h *= P / h.sum()
    return h.reshape(L, P).T.astype(np.float32).copy()  # h_p[l] = h[l·P + p]


def rational_resample_init(P: int, Q: int, device: torch.device, as_db: float = 60.0,
                           dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """The L − 1 past inputs, zeros."""
    L = rational_taps(P, Q, as_db).shape[1]
    return torch.zeros((L - 1,), dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def _gather_tables_on(P: int, Q: int, as_db: float, n: int, device: torch.device):
    """(window indices (nout, L), tap rows (nout, L) float32) for the gather
    form, once per block length and device."""
    taps = rational_taps(P, Q, as_db)
    L = taps.shape[1]
    mo = np.arange((n // Q) * P, dtype=np.int64)
    base = (mo * Q) // P
    phase = (mo * Q) % P
    idx = base[:, None] + ((L - 1) - np.arange(L))[None, :]
    return (torch.from_numpy(idx).to(device), torch.from_numpy(taps[phase]).to(device))


def rational_resample_stream(state: torch.Tensor, x: torch.Tensor, P: int, Q: int,
                             as_db: float = 60.0):
    """Resample one block: the last axis a multiple of Q → n·P/Q outputs.
    Returns (new_state, y)."""
    taps = rational_taps(P, Q, as_db)  # (P, L)
    L = taps.shape[1]
    n = x.shape[-1]
    if n % Q:
        raise ValueError(f"block of {n} samples is not a multiple of Q = {Q}")
    nout = (n // Q) * P
    R = nout // P  # outputs per phase lane
    xfull = torch.cat([state, x], dim=-1)  # x[j] at index j + L − 1
    new_state = xfull[..., n:].clone() if L > 1 else state

    if P * L > _GATHER_ABOVE:
        idx, rows = _gather_tables_on(P, Q, float(as_db), n, x.device)
        win = xfull[..., idx]                                 # (..., nout, L)
        return new_state, (win * rows).sum(dim=-1)

    m = np.arange(P)
    base = (m * Q) // P
    phase = (m * Q) % P
    lanes = []
    for s in range(P):
        hp = taps[phase[s]]
        acc = None
        for l in range(L):
            if hp[l] == 0.0:
                continue
            start = base[s] - l + (L - 1)
            term = xfull[..., start: start + (R - 1) * Q + 1: Q] * float(hp[l])
            acc = term if acc is None else acc + term
        if acc is None:
            acc = torch.zeros((*x.shape[:-1], R), dtype=xfull.dtype, device=x.device)
        lanes.append(acc)
    return new_state, torch.stack(lanes, dim=-1).reshape(*x.shape[:-1], nout)
