"""Plain DSP operations of the benchmark's references, in PyTorch.

Nothing here imports the port (``csdr_tpu_torch``), the JAX package or
JAX.  Every function works in the precision it is given: the references
run in float64 (complex128); the control of each cell runs the same code
in float32 with its DFT on TF32 operands (``tf32``), the step below the
float32 that the configurations state.

The filter designs are frozen copies of ``csdr_tpu_torch/utils/firdes.py``
(``kaiser_beta``, ``kaiser_lowpass``, ``pfb_kaiser_prototype``) and of
``csdr_tpu_torch/models/symsync.py`` (``_interp_bank``), kept in float64:
the reference designs its own taps and never reads the program's.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


# ---- designs (frozen copies, float64) ---------------------------------------------

def kaiser_beta(as_db: float) -> float:
    """Kaiser window shape for a stop-band attenuation in dB (copied from
    ``csdr_tpu_torch/utils/firdes.py`` ``kaiser_beta``)."""
    as_db = abs(as_db)
    if as_db > 50.0:
        return 0.1102 * (as_db - 8.7)
    if as_db > 21.0:
        return 0.5842 * (as_db - 21.0) ** 0.4 + 0.07886 * (as_db - 21.0)
    return 0.0


def kaiser_lowpass(n: int, fc: float, as_db: float) -> np.ndarray:
    """Kaiser-windowed sinc (copied from ``firdes.kaiser_lowpass``, mu = 0)."""
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    return 2.0 * fc * np.sinc(2.0 * fc * t) * np.kaiser(n, kaiser_beta(as_db))


def pfb_taps(nch: int, m: int, as_db: float) -> np.ndarray:
    """(2m, nch) polyphase taps, branch p holding h[l·nch + p], Σh = 1: the
    prototype of ``firdes.pfb_kaiser_prototype`` (cutoff 0.5/nch, length
    2·nch·m + 1, its last sample dropped) as ``ops/pfb.pfb_taps`` splits
    it, in float64."""
    h = kaiser_lowpass(2 * nch * m + 1, 0.5 / nch, as_db)[:-1]
    h = h / h.sum()
    return h.reshape(2 * m, nch)


def sync_bank(k: int, m: int, npfb: int) -> np.ndarray:
    """(npfb, 2mk + 1) Kaiser matched-filter bank, row p = g(l − mk + p/npfb)
    (copied from ``models/symsync._interp_bank``, ftype "kaiser"), float64."""
    W = 2 * m * k + 1
    t = (np.arange(W * npfb, dtype=np.float64) - (W * npfb - 1) / 2.0) / npfb
    g = np.sinc(t / k) * np.kaiser(W * npfb, kaiser_beta(60.0))
    center = (W * npfb - 1) // 2
    bank = np.zeros((npfb, W))
    for p in range(npfb):
        bank[p] = g[np.clip(center + (np.arange(W) - m * k) * npfb + p, 0, W * npfb - 1)]
    return bank


# ---- precision -----------------------------------------------------------------------

def real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32's 10 mantissa bits, as
    a tensor core takes its operands."""
    if x.is_complex():
        return torch.complex(tf32_round(x.real.contiguous()), tf32_round(x.imag.contiguous()))
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# ---- operations ----------------------------------------------------------------------

def cu8_to_complex(u8: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
    """(n, 2) rtl_sdr bytes → complex, (v − 127.5)/127.5."""
    f = (u8.to(real_dtype(cdtype)) - 127.5) / 127.5
    return torch.complex(f[:, 0].contiguous(), f[:, 1].contiguous()).to(cdtype)


def linrec(f: torch.Tensor, r: float, chunk: int = 256) -> torch.Tensor:
    """y[n] = r·y[n−1] + f[n] from y[−1] = 0 along the last axis: within
    chunks of ``chunk`` samples as r^i·cumsum(f·r^−j) (r^−chunk stays near
    1), the carries between chunks sequentially on the host."""
    n = f.shape[-1]
    pad = -n % chunk
    fp = torch.nn.functional.pad(f, (0, pad)) if pad else f
    nc = fp.shape[-1] // chunk
    rd = real_dtype(f.dtype)
    i = torch.arange(chunk, dtype=torch.float64, device=f.device)
    up = torch.pow(torch.tensor(r, dtype=torch.float64), -i).to(rd).to(f.device)
    down = torch.pow(torch.tensor(r, dtype=torch.float64), i).to(rd).to(f.device)
    loc = torch.cumsum(fp.reshape(*f.shape[:-1], nc, chunk) * up, dim=-1) * down
    ends = loc[..., -1].to(torch.complex128).cpu().numpy()
    # carry into chunk c: Y[c] = ρ·Y[c−1] + ends[c−1], ρ = r^chunk
    from scipy.signal import lfilter

    rho = float(r) ** chunk
    Y = lfilter([1.0], [1.0, -rho], ends, axis=-1)
    carry = np.concatenate([np.zeros(Y.shape[:-1] + (1,)), Y[..., :-1]], axis=-1)
    carry = torch.from_numpy(carry).to(f.device).to(f.dtype)
    rpow = torch.pow(torch.tensor(r, dtype=torch.float64), i + 1).to(rd).to(f.device)
    y = loc + carry[..., None] * rpow
    return y.reshape(*f.shape[:-1], nc * chunk)[..., :n]


def dc_block(x: torch.Tensor, alpha: float = 0.0005) -> torch.Tensor:
    """The DC notch y[n] = r·y[n−1] + (1 + r)/2·(x[n] − x[n−1]), r = 1 − α,
    from zero state (x[−1] = y[−1] = 0)."""
    r = 1.0 - alpha
    prev = torch.cat([torch.zeros_like(x[:1]), x[:-1]])
    return linrec((1.0 + r) / 2.0 * (x - prev), r)


def pfb_shift(x: torch.Tensor, nch: int) -> torch.Tensor:
    """The channelizer's NCO pre-shift, x·e^{+jπ(nch−1)k/nch}, from phase 0
    at x[0]; its phase is exact: (nch − 1)·k mod 2nch."""
    k = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    ph = ((nch - 1) * k % (2 * nch)).to(real_dtype(x.dtype)) * (np.pi / nch)
    return x * torch.polar(torch.ones_like(ph), ph)


def channelize(x: torch.Tensor, nch: int, m: int, as_db: float, cols=None,
               tf32: bool = False) -> torch.Tensor:
    """Polyphase analysis from zero history: v[i, p] = x[i·nch − p], the
    2m-tap FIR of each branch along the frames, then the DFT across the
    branches, W[p, k] = e^{+j2πkp/nch}.  Returns (channels, F), the
    channels ``cols`` (default all), channel k centred at
    2π(k − (nch − 1)/2)/nch after ``pfb_shift``."""
    cd = x.dtype
    taps = torch.from_numpy(pfb_taps(nch, m, as_db)).to(x.device).to(real_dtype(cd))
    L = taps.shape[0]
    F = x.shape[-1] // nch
    xfull = torch.cat([torch.zeros(nch - 1, dtype=cd, device=x.device), x])
    v = xfull[:F * nch].reshape(F, nch).flip(1)
    vfull = torch.cat([torch.zeros(L - 1, nch, dtype=cd, device=x.device), v])
    u = None
    for l in range(L):
        term = vfull[L - 1 - l:L - 1 - l + F] * taps[l]
        u = term if u is None else u + term
    p = np.arange(nch)
    cols = p if cols is None else np.asarray(cols)
    W = torch.from_numpy(np.exp(2j * np.pi * np.outer(p, cols) / nch)).to(x.device).to(cd)
    if tf32:
        u, W = tf32_round(u), tf32_round(W)
    return (u @ W).T


def fm_demod(d: torch.Tensor, kf: float, first_prev: complex) -> torch.Tensor:
    """arg(d[n]·conj(d[n−1]))/(2π·kf) along the last axis, d[−1] =
    ``first_prev``."""
    prev = torch.cat([torch.full_like(d[..., :1], first_prev), d[..., :-1]], dim=-1)
    return torch.angle(d * prev.conj()) / (TWO_PI * kf)
