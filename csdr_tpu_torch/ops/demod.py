"""Demodulators: FM, y[n] = arg(x[n]·conj(x[n−1])) / (2π·kf), the AM
envelope, and M-FSK by tone correlation.

Counterpart of ``csdr_tpu/ops/demod.py`` (``freqdem_stream``, ``amdem``,
``fsk_tone_matrix``, ``fskdem_block``).
Works along the last axis, so a (nch, n) channel panel with (nch, 1)
carried samples demodulates every channel at once (``core/block.PerChannel``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["freqdem_stream", "amdem", "fsk_tone_matrix", "fskdem_block"]

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


@functools.lru_cache(maxsize=None)
def fsk_tone_matrix(m_bits: int, k: int, bandwidth: float) -> np.ndarray:
    """(k, M) conjugate tone matrix for M = 2^m_bits FSK correlation demod:
    tone i at normalized frequency bandwidth·(2i − (M−1))/(M−1), spanning
    [−bw, +bw]."""
    M = 1 << m_bits
    i = np.arange(M, dtype=np.float64)
    f = bandwidth * (2.0 * i - (M - 1)) / (M - 1)
    t = np.arange(k, dtype=np.float64)
    E = np.exp(-1j * _TWO_PI * f[None, :] * t[:, None])
    return E.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _tone_matrix_on(m_bits: int, k: int, bandwidth: float, device: torch.device):
    return torch.as_tensor(fsk_tone_matrix(m_bits, k, bandwidth), device=device)


def fskdem_block(x: torch.Tensor, m_bits: int, k: int, bandwidth: float) -> torch.Tensor:
    """Demodulate n//k M-FSK symbols along the last axis: the (…, nsym, k)
    @ (k, M) complex correlation, then the argmax of its power (the first of
    tied maxima, as ``jnp.argmax``).  uint32 symbols, as in the JAX
    package."""
    nsym = x.shape[-1] // k
    xs = x[..., : nsym * k].reshape(*x.shape[:-1], nsym, k)
    corr = xs @ _tone_matrix_on(m_bits, int(k), float(bandwidth), x.device)
    return torch.argmax(corr.abs() ** 2, dim=-1).to(torch.uint32)
