"""Roofline bounds of the port's kernels: the least time an H100 could take
for a kernel's work, the larger of its bytes over the HBM bandwidth and
its operations over the FP32 peak.

Frozen copies of ``chip_smoke.py`` ``bound``, ``fft_flops``,
``flagship_bound``, ``pfb_bound``, ``pll_bound`` and ``sync_scan_bound``
(the peaks from NVIDIA's H100 SXM data sheet, at its 700 W limit), so that
a later change to the program's scripts cannot move the yardstick.  Each
byte is counted once: every input read once, every output written once.
"""

from __future__ import annotations

import numpy as np

HBM_BPS, FP32_FLOPS = 3.35e12, 67e12   # H100 SXM data sheet


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over HBM, operations over
    the FP32 peak, whichever is larger."""
    t_b, t_o = nbytes / HBM_BPS, flops / FP32_FLOPS
    return dict(bound_ms=max(t_b, t_o) * 1e3, bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def fft_flops(N: int) -> float:
    """Operations of one N-point complex FFT, 5·N·log2 N."""
    return 5.0 * N * np.log2(N)


def flagship_bound(n: int, nch: int, cu8: bool, L: int = 14) -> dict:
    """K1/K2 per step: 2 B (cu8) or 8 B in per sample, 4 B of audio out per
    frame-channel; per sample the branch FIR (L+1 complex-by-real MACs, 4
    FLOP each), an nch-point FFT (5·log2 nch), the DC blocker (8), the NCO
    rotation (6), the u8 map (4, cu8 only) and the demod's conjugate
    product and atan2 (26)."""
    per = 4 * (L + 1) + 5 * np.log2(nch) + 8 + 6 + (4 if cu8 else 0) + 26
    return bound((2 if cu8 else 8) * n + 4 * n, per * n)


def pfb_bound(n: int, nch: int, demod: bool, L: int = 14) -> dict:
    """K3 (demod) / K4 per step: panels (F + L, nch) complex in, audio or
    complex channels out; FIR, FFT and (K3) the demod per sample."""
    F = n // nch
    per = 4 * (L + 1) + 5 * np.log2(nch) + (26 if demod else 0)
    return bound(8 * (F + L) * nch + (4 if demod else 8) * n, per * n)


def pll_bound(rows: int, n: int) -> dict:
    """K7: p read once (8 B), sub38 written once (8 B) per sample; per
    sample the complex product (6 FLOP), the loop update (5), and one each
    for the two sincosf, the atan2f and the mod."""
    return bound(16 * rows * n + 16 * rows, 15 * rows * n)


def sync_scan_bound(rows: int, L: int, nout: int, W: int, npfb: int, cplx: bool) -> dict:
    """K8: each row of xfull read once, each output written once, the bank
    once; per output W multiply-adds (2 FLOP, 4 complex) and ~12 for the
    position and the loop."""
    dt = 8 if cplx else 4
    return bound(rows * (dt * L + dt * nout) + 4 * npfb * W,
                 rows * nout * (W * (4 if cplx else 2) + 12))
