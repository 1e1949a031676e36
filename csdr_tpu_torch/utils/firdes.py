"""FIR filter design (numpy, float64).

Copied from ``csdr_tpu/utils/firdes.py`` (the JAX package imports jax at
package level, so the port cannot import its numpy code).  Every design of
the JAX module is here (the channelizer prototype, the Kaiser low-pass and
length estimate, the decimator, half-band and Hilbert designs, the GMSK
transmit and receive pulses, the root-raised-cosine and root-Nyquist
pulses, the fractional delay);
``tests/test_torch_design.py`` and ``tests/test_torch_fir.py`` hold them
equal to the JAX package's arrays.

All cutoff frequencies ``fc`` are normalized to the sample rate (liquid's
convention): fc = 0.25 means a quarter of fs.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["kaiser_beta", "kaiser_filter_len", "kaiser_lowpass", "firdecim_kaiser",
           "pfb_kaiser_prototype", "halfband_kaiser", "group_delay", "rrc",
           "nyquist_kaiser", "gmsk_tx", "erf_vec", "gmsk_rx", "hilbert_halfband",
           "root_nyquist_kaiser", "fractional_delay", "cached_kaiser_lowpass"]


def kaiser_beta(as_db: float) -> float:
    """Kaiser window shape parameter for a stop-band attenuation in dB
    (Oppenheim & Schafer's empirical formula)."""
    as_db = abs(as_db)
    if as_db > 50.0:
        return 0.1102 * (as_db - 8.7)
    if as_db > 21.0:
        return 0.5842 * (as_db - 21.0) ** 0.4 + 0.07886 * (as_db - 21.0)
    return 0.0


def kaiser_filter_len(df: float, as_db: float) -> int:
    """Kaiser's length estimate N ≈ (As − 7.95) / (14.26·Δf) for a transition
    bandwidth ``df`` (normalized to fs) and a stop-band attenuation in dB."""
    if df <= 0:
        raise ValueError("transition bandwidth must be positive")
    n = int(np.ceil((abs(as_db) - 7.95) / (14.26 * df)))
    return max(n, 3)


def kaiser_lowpass(n: int, fc: float, as_db: float = 60.0, mu: float = 0.0) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass of length ``n`` with ~unity passband
    gain, h = 2·fc·sinc(2·fc·t)·w; ``mu`` is a fractional sample delay."""
    if not 0.0 < fc <= 0.5:
        raise ValueError(f"fc must be in (0, 0.5], got {fc}")
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0 + mu
    h = 2.0 * fc * np.sinc(2.0 * fc * t)
    w = np.kaiser(n, kaiser_beta(as_db))
    return h * w


def firdecim_kaiser(m: int, semilen: int, as_db: float = 60.0) -> np.ndarray:
    """Decimate-by-``m`` anti-alias FIR (reference
    ``firdecim_rrrf_create_kaiser(m, 10, 60)``): length 2·m·semilen + 1,
    cutoff 0.5/m, unity passband gain."""
    n = 2 * m * semilen + 1
    h = kaiser_lowpass(n, 0.5 / m, as_db)
    return h / h.sum()


def pfb_kaiser_prototype(nch: int, taps_per_branch_semilen: int, as_db: float = 80.0) -> np.ndarray:
    """Polyphase filterbank prototype (reference
    ``firpfbch_crcf_create_kaiser(0, nch, m, 80)``): cutoff 0.5/nch, length
    2·nch·m (the trailing sample of the odd design dropped so every branch
    has 2·m taps), scaled to sum nch."""
    m = taps_per_branch_semilen
    n = 2 * nch * m + 1
    h = kaiser_lowpass(n, 0.5 / nch, as_db)
    h = h[:-1]
    return h * (nch / h.sum())


def halfband_kaiser(semilen: int, as_db: float = 60.0) -> np.ndarray:
    """Half-band low-pass (fc = 0.25) of length 4·semilen + 1, Kaiser window;
    every second tap but the centre is exactly zero."""
    n = 4 * semilen + 1
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = 0.5 * np.sinc(0.5 * t)
    h *= np.kaiser(n, kaiser_beta(as_db))
    center = (n - 1) // 2
    idx = np.arange(n)
    h[(idx != center) & ((idx - center) % 2 == 0)] = 0.0
    return h / h.sum() * 0.5


def hilbert_halfband(semilen: int = 5, as_db: float = 60.0) -> np.ndarray:
    """The half-band low-pass under the real ↔ complex converter (reference
    ``firhilbf_create 5 60.0``), scaled to unity gain at DC;
    ``ops/hilbert.py`` builds the quadrature structure from it."""
    return halfband_kaiser(semilen, as_db) * 2.0


def group_delay(h: np.ndarray, f: float = 0.0) -> float:
    """Group delay of the FIR ``h`` at normalized frequency ``f``
    (cycles/sample); the stereo and RDS decoders compensate the pilot
    filter's delay with it."""
    n = len(h)
    k = np.arange(n, dtype=np.float64)
    e = np.exp(-1j * 2.0 * np.pi * f * k)
    H = np.sum(h * e)
    dH = np.sum(-1j * k * h * e)
    if abs(H) < 1e-12:
        return (n - 1) / 2.0
    return float(np.real(1j * dH / H))


def rrc(k: int, m: int, beta: float) -> np.ndarray:
    """Root-raised-cosine matched filter: k samples/symbol, semi-length m
    symbols, roll-off beta (clamped to [1e-3, 1]).  Length 2·k·m + 1, scaled
    by 1/√k."""
    if beta <= 0 or beta > 1:
        beta = max(min(beta, 1.0), 1e-3)
    n = 2 * k * m + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / k
    h = np.empty(n, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif abs(abs(4.0 * beta * ti) - 1.0) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
        else:
            num = np.sin(np.pi * ti * (1.0 - beta)) + 4.0 * beta * ti * np.cos(
                np.pi * ti * (1.0 + beta))
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            h[i] = num / den
    return h / np.sqrt(k)


def nyquist_kaiser(k: int, m: int, beta: float) -> np.ndarray:
    """Kaiser-windowed Nyquist (ISI-free) filter: k samples per symbol,
    semi-length m symbols; ``beta`` relaxes the window's stop-band target."""
    n = 2 * k * m + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / k
    h = np.sinc(t)
    as_db = 60.0 if beta <= 0 else max(40.0, 60.0 * (1.0 - 0.3 * beta))
    w = np.kaiser(n, kaiser_beta(as_db))
    return h * w


def root_nyquist_kaiser(k: int, m: int, beta: float) -> np.ndarray:
    """Approximate root-Nyquist Kaiser filter (reference symsync ftype 7):
    the frequency-domain square root of ``nyquist_kaiser``, so the matched
    cascade h*h is ISI-free to within the window's leakage; normalized to
    unity symbol-rate gain of that cascade."""
    n = 2 * k * m + 1
    g = nyquist_kaiser(k, m, beta)
    nfft = 1 << int(np.ceil(np.log2(16 * n)))
    G = np.fft.fft(np.fft.ifftshift(np.pad(g, ((nfft - n) // 2, nfft - n - (nfft - n) // 2))))
    H = np.sqrt(np.maximum(G.real, 0.0))
    h_full = np.fft.fftshift(np.fft.ifft(H).real)
    c = nfft // 2
    h = h_full[c - (n - 1) // 2: c + (n - 1) // 2 + 1]
    return h / np.sqrt(np.sum(h**2) * k)


def gmsk_tx(k: int, m: int, bt: float = 0.3) -> np.ndarray:
    """GMSK transmit pulse: a Gaussian of bandwidth-time ``bt`` convolved
    with a one-symbol rectangle; k samples per symbol, semi-length m
    symbols, normalized to sum 1."""
    n = 2 * k * m + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / k
    alpha = np.sqrt(2.0 / np.log(2.0)) * np.pi * bt

    def q(x):
        return 0.5 * (1.0 + erf_vec(alpha * x / np.sqrt(2.0)))

    h = q(t + 0.5) - q(t - 0.5)
    return h / h.sum()


def erf_vec(x: np.ndarray) -> np.ndarray:
    """Elementwise error function in float64 (``math.erf``)."""
    from math import erf

    return np.vectorize(erf)(np.asarray(x, dtype=np.float64))


def gmsk_rx(k: int, m: int, bt: float = 0.3) -> np.ndarray:
    """GMSK receive matched filter: the frequency-domain deconvolution of a
    Nyquist target by the transmit pulse, regularized, so that gmsk_tx *
    gmsk_rx is close to Nyquist; unity cascade gain at the symbol
    instant."""
    htx = gmsk_tx(k, m, bt)
    n = len(htx)
    target = nyquist_kaiser(k, m, max(bt, 0.2))
    nfft = 1 << int(np.ceil(np.log2(16 * n)))

    def pad_center(h):
        return np.pad(h, ((nfft - len(h)) // 2, nfft - len(h) - (nfft - len(h)) // 2))

    Ht = np.fft.fft(np.fft.ifftshift(pad_center(htx)))
    Hg = np.fft.fft(np.fft.ifftshift(pad_center(target)))
    eps = 1e-2 * np.max(np.abs(Ht))
    Hr = Hg * np.conj(Ht) / (np.abs(Ht) ** 2 + eps**2)
    hr = np.fft.fftshift(np.fft.ifft(Hr).real)
    c = nfft // 2
    h = hr[c - (n - 1) // 2: c + (n - 1) // 2 + 1]
    return h / np.sum(h * htx)


def fractional_delay(h: np.ndarray, mu: float, extend: bool = False) -> np.ndarray:
    """Delay real FIR taps by ``mu`` ∈ (−1, 1) samples through an exact
    frequency-domain linear phase (taps zero-padded 8× so the shifted tails
    do not wrap).  ``extend=False`` keeps length n and drops the one sample
    of spill; ``extend=True`` returns n + 1 taps holding it (for
    hard-truncated designs such as ``gmsk_rx``), a negative ``mu`` then
    adding one whole sample of delay."""
    if mu == 0.0:
        return h
    if not -1.0 < mu < 1.0:
        raise ValueError(f"fractional delay mu={mu} not in (-1, 1)")
    n = len(h)
    nfft = 1 << int(np.ceil(np.log2(8 * n)))
    H = np.fft.rfft(h, nfft)
    f = np.fft.rfftfreq(nfft)
    y = np.fft.irfft(H * np.exp(-2j * np.pi * f * mu), nfft)
    if not extend:
        return y[:n]
    if mu > 0:
        return y[: n + 1]
    return np.concatenate([y[-1:], y[:n]])


@functools.lru_cache(maxsize=None)
def cached_kaiser_lowpass(n: int, fc: float, as_db: float = 60.0, mu: float = 0.0):
    """``kaiser_lowpass`` memoized on its arguments (callers must not write
    to the shared array)."""
    return kaiser_lowpass(n, fc, as_db, mu)
