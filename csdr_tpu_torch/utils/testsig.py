"""Test signals (modulators) and a quality metric, in numpy.

Counterpart of ``csdr_tpu/utils/testsig.py``: a known message is
modulated here (float64), run through a receiver and held to an SNR with
``snr_db``.  The same functions and arithmetic, so a seed gives the JAX
package's arrays element for element.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "tone",
    "fm_mod",
    "am_mod",
    "fsk_mod",
    "snr_db",
    "awgn",
]

_TWO_PI = 2.0 * np.pi


def tone(n: int, freq: float, fs: float = 1.0, amp: float = 1.0, phase: float = 0.0,
         complex_out: bool = True) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    ph = _TWO_PI * (freq / fs) * t + phase
    if complex_out:
        return (amp * np.exp(1j * ph)).astype(np.complex64)
    return (amp * np.cos(ph)).astype(np.float32)


def fm_mod(message: np.ndarray, kf: float) -> np.ndarray:
    """FM as liquid-dsp's modulator: phase[n] = phase[n-1] + 2π·kf·m[n]."""
    phase = _TWO_PI * kf * np.cumsum(np.asarray(message, dtype=np.float64))
    return np.exp(1j * phase).astype(np.complex64)


def am_mod(message: np.ndarray, mod_index: float = 0.8, suppressed: bool = False) -> np.ndarray:
    m = np.asarray(message, dtype=np.float64)
    if suppressed:
        s = mod_index * m
    else:
        s = (1.0 + mod_index * m) / (1.0 + mod_index)
    return s.astype(np.complex64)


def fsk_mod(symbols: np.ndarray, m_bits: int, k: int, bandwidth: float) -> np.ndarray:
    """M-FSK, continuous phase across symbols, with the tone map of
    ``ops/demod.fsk_tone_matrix``."""
    M = 1 << m_bits
    sym = np.asarray(symbols, dtype=np.int64)
    f = bandwidth * (2.0 * sym - (M - 1)) / (M - 1)  # per symbol
    inst_f = np.repeat(f, k)
    phase = _TWO_PI * np.cumsum(inst_f)
    phase = np.concatenate([[0.0], phase[:-1]])
    return np.exp(1j * phase).astype(np.complex64)


def awgn(x: np.ndarray, snr_db_val: float, rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    p_sig = np.mean(np.abs(x) ** 2)
    p_noise = p_sig / (10.0 ** (snr_db_val / 10.0))
    if np.iscomplexobj(x):
        n = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
        n *= np.sqrt(p_noise / 2.0)
    else:
        n = rng.normal(size=x.shape) * np.sqrt(p_noise)
    return (x + n).astype(x.dtype)


def snr_db(ref: np.ndarray, test: np.ndarray, skip: int = 0, align: bool = True,
           scale: bool = True) -> float:
    """SNR of ``test`` against ``ref`` after an optional delay alignment
    (cross-correlation over ±64 samples) and a least-squares scalar fit."""
    ref = np.asarray(ref, dtype=np.float64 if not np.iscomplexobj(ref) else np.complex128)
    test = np.asarray(test, dtype=ref.dtype)
    n = min(len(ref), len(test))
    ref, test = ref[:n], test[:n]
    if skip:
        ref, test = ref[skip:-skip or None], test[skip:-skip or None]
    if align:
        best, best_lag = -np.inf, 0
        for lag in range(-64, 65):
            r = ref[max(0, lag):len(ref) + min(0, lag)]
            t = test[max(0, -lag):len(test) + min(0, -lag)]
            m = min(len(r), len(t))
            if m < 16:
                continue
            c = np.abs(np.vdot(r[:m], t[:m]))
            denom = np.linalg.norm(r[:m]) * np.linalg.norm(t[:m]) + 1e-30
            if c / denom > best:
                best, best_lag = c / denom, lag
        lag = best_lag
        ref = ref[max(0, lag):]
        test = test[max(0, -lag):]
        m = min(len(ref), len(test))
        ref, test = ref[:m], test[:m]
    if scale:
        g = np.vdot(ref, test) / (np.vdot(ref, ref) + 1e-30)
        err = test - g * ref
    else:
        err = test - ref
    p_sig = np.mean(np.abs(ref) ** 2) + 1e-30
    p_err = np.mean(np.abs(err) ** 2) + 1e-30
    return float(10.0 * np.log10(p_sig / p_err))
