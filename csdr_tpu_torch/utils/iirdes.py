"""IIR filter design: the liquid prototype families as second-order
sections, and their decomposition into one-pole partial fractions.

Copied from ``csdr_tpu/utils/iirdes.py`` (numpy and scipy, float64), which
the port may not import.  A real SOS cascade runs as a cascade of stages,
each a 3-tap FIR numerator followed by one or two one-pole recurrences
solved in parallel over the whole block (``ops/linrec.py``);
``tests/test_torch_iir.py`` holds the designs equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["butter_sos", "prototype_sos", "sos_to_onepole", "OnePoleCascade", "IIR_PROTOTYPES"]

# liquid-dsp's prototype families (LIQUID_IIRDES_{BUTTER,CHEBY1,CHEBY2,ELLIP,BESSEL})
IIR_PROTOTYPES = ("butter", "cheby1", "cheby2", "ellip", "bessel")


def butter_sos(order: int, fc: float) -> np.ndarray:
    """Butterworth low-pass of order ``order``, cutoff ``fc`` normalized to
    the sample rate (liquid's convention, fc in (0, 0.5)); scipy SOS array
    (n_sections, 6)."""
    if not 0.0 < fc < 0.5:
        raise ValueError(f"fc must be in (0, 0.5), got {fc}")
    import scipy.signal as sig  # here, not at import: it takes seconds to load

    return sig.butter(order, 2.0 * fc, btype="low", output="sos")


def prototype_sos(ftype: str, order: int, fc: float, f0: float = 0.0,
                  ap: float = 1.0, as_db: float = 40.0) -> np.ndarray:
    """An IIR prototype as SOS, liquid's ``iirfilt_*_create_prototype``
    surface.  ``fc``: cutoff (low-pass) or half-bandwidth (band-pass),
    normalized to the sample rate; ``f0``: 0 for a low-pass, else the centre
    of a band-pass over [f0 − fc, f0 + fc]; ``ap``: pass-band ripple in dB
    (cheby1, ellip); ``as_db``: stop-band attenuation in dB (cheby2,
    ellip)."""
    if ftype not in IIR_PROTOTYPES:
        raise ValueError(f"unknown IIR prototype {ftype!r}; expected one of {IIR_PROTOTYPES}")
    if not 0.0 < fc < 0.5:
        raise ValueError(f"fc must be in (0, 0.5), got {fc}")
    if f0:
        lo, hi = 2.0 * (f0 - fc), 2.0 * (f0 + fc)
        if not 0.0 < lo < hi < 1.0:
            raise ValueError(f"bandpass edges out of range: f0={f0}, fc={fc}")
        wn, btype = (lo, hi), "bandpass"
    else:
        wn, btype = 2.0 * fc, "low"
    import scipy.signal as sig

    if ftype == "butter":
        return sig.butter(order, wn, btype=btype, output="sos")
    if ftype == "cheby1":
        return sig.cheby1(order, ap, wn, btype=btype, output="sos")
    if ftype == "cheby2":
        return sig.cheby2(order, as_db, wn, btype=btype, output="sos")
    if ftype == "ellip":
        return sig.ellip(order, ap, as_db, wn, btype=btype, output="sos")
    return sig.bessel(order, wn, btype=btype, output="sos", norm="mag")


@dataclasses.dataclass(frozen=True)
class OnePoleCascade:
    """A filter as a cascade of stages; stage s is y = fir[s] * x (3 taps)
    followed by partial-fraction one-pole terms u_i[n] = p_i·u_i[n−1] + v[n].

    poles:    (n_stages, 2) complex — the stage's pole pair (p, q) or (p, 0)
    residues: (n_stages, 2) complex — their partial-fraction coefficients
    fir:      (n_stages, 3) float   — the stage's numerator taps
    real_io:  whether the cascade's input and output are real
    """

    poles: np.ndarray
    residues: np.ndarray
    fir: np.ndarray
    real_io: bool


def sos_to_onepole(sos: np.ndarray, real_io: bool = True) -> OnePoleCascade:
    """Decompose an SOS cascade into FIR numerators and one-pole partial
    fractions.  For a section 1 + a1 z⁻¹ + a2 z⁻² with poles p, q:
    1/A(z) = r_p/(1 − p z⁻¹) + r_q/(1 − q z⁻¹), r_p = p/(p−q), r_q = −q/(p−q);
    a first-order section has the single pole −a1 with residue 1."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    n = sos.shape[0]
    poles = np.zeros((n, 2), dtype=np.complex128)
    residues = np.zeros((n, 2), dtype=np.complex128)
    fir = np.zeros((n, 3), dtype=np.float64)
    for i, (b0, b1, b2, a0, a1, a2) in enumerate(sos):
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
        fir[i] = (b0, b1, b2)
        if abs(a2) < 1e-300 and abs(a1) < 1e-300:
            poles[i] = (0.0, 0.0)
            residues[i] = (1.0, 0.0)
        elif abs(a2) < 1e-300:
            poles[i] = (-a1, 0.0)
            residues[i] = (1.0, 0.0)
        else:
            disc = np.sqrt(complex(a1 * a1 - 4.0 * a2))
            p = (-a1 + disc) / 2.0
            q = (-a1 - disc) / 2.0
            if abs(p - q) < 1e-12:
                # a repeated pole: nudge it so the partial fractions exist
                p *= 1.0 + 1e-7
            poles[i] = (p, q)
            residues[i] = (p / (p - q), -q / (p - q))
    return OnePoleCascade(poles=poles, residues=residues, fir=fir, real_io=real_io)
