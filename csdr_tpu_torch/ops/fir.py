"""Streaming FIR convolution engines.

Counterpart of ``csdr_tpu/ops/fir.py``.  The causal filter

    y[n] = Σ_k h[k] · x[n − k]

runs on whole blocks with the last K − 1 inputs carried as state (the
filter's hist), along the last axis with any leading batch axes: inside
``core/block.PerChannel`` a channelized flow hands the FIR an
(nch, n + K − 1) tensor.  Strategies of ``conv_valid`` (the JAX names, which
``FIRFilter(strategy=…)`` exposes):

  * ``"slices"``:     K shifted multiply-adds, for short filters;
  * ``"fft"``:        batched overlap-save with ``torch.fft``, segments of
                      max(16384, 2^⌈log2 4K⌉);
  * ``"pallas_mxu"``: K5, the long real-tap kernel (``ops/cuda/fir_valid.py``);
  * ``"pallas_fft"``: K6, the overlap-save kernel at S = 16384
                      (``ops/cuda/fft_fir.py``);
  * ``"pallas_fft_interpret"``: K6's plain version on any device, the same
                      function the JAX name computes in interpret mode;
  * ``"auto"``:       slices up to 64 non-zero taps; above 256, real taps on
                      a CUDA tensor take K5; everything else fft.

Decimating and interpolating variants evaluate the polyphase components, so
no multiply is spent on a discarded output.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda.fft_fir import fft_fir_valid, fft_fir_valid_ref, fft_response_on
from .cuda.fir_valid import fir_valid

__all__ = ["conv_valid", "fir_stream", "fir_decim_stream", "fir_interp_stream"]

_FFT_MIN_TAPS = 64


def _scalar(t):
    """A tap as a Python number, rounded to float32/complex64 first (the JAX
    package multiplies by the tap in float32)."""
    return complex(np.complex64(t)) if np.iscomplexobj(t) else float(np.float32(t))


def _zeros(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((*x.shape[:-1], n), dtype=x.dtype, device=x.device)


def _conv_valid_slices(xfull: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """y[..., i] = Σ_k taps[k]·xfull[..., i + K − 1 − k], i < n."""
    K = len(taps)
    n = xfull.shape[-1] - K + 1
    acc = None
    for k in range(K):
        if taps[k] == 0.0:  # half-band filters: skip exact-zero taps
            continue
        term = xfull[..., K - 1 - k: K - 1 - k + n] * _scalar(taps[k])
        acc = term if acc is None else acc + term
    return acc if acc is not None else _zeros(xfull, n)


def _conv_valid_fft(xfull: torch.Tensor, taps: np.ndarray, seg: int = 16384) -> torch.Tensor:
    """Batched overlap-save: segments of length S with K − 1 overlap."""
    K = len(taps)
    n = xfull.shape[-1] - K + 1
    S = max(seg, 1 << int(np.ceil(np.log2(4 * K))))
    hop = S - (K - 1)
    nseg = -(-n // hop)
    pad = (nseg - 1) * hop + S - xfull.shape[-1]
    if pad > 0:
        xfull = torch.cat([xfull, _zeros(xfull, pad)], dim=-1)
    segs = xfull.unfold(-1, S, hop)                                   # (..., nseg, S)
    complex_in = xfull.is_complex() or np.iscomplexobj(taps)
    H = fft_response_on(taps.tobytes(), taps.dtype.str, S, not complex_in, xfull.device)
    if complex_in:
        Y = torch.fft.ifft(torch.fft.fft(segs.to(torch.complex64), dim=-1) * H, dim=-1)
    else:
        Y = torch.fft.irfft(torch.fft.rfft(segs, dim=-1) * H, n=S, dim=-1)
    y = Y[..., K - 1:].reshape(*xfull.shape[:-1], nseg * hop)[..., :n]
    return y.contiguous()


def _auto_strategy(taps: np.ndarray, x: torch.Tensor) -> str:
    """Short filters run as slices; long REAL filters on the card run on K5;
    everything else overlap-saves through ``torch.fft``.  The data's device
    takes the place of the JAX package's ``jax.default_backend() == "tpu"``."""
    nz = int(np.count_nonzero(taps))
    if nz <= _FFT_MIN_TAPS:
        return "slices"
    if nz > 256 and not np.iscomplexobj(taps) and x.device.type == "cuda":
        return "pallas_mxu"
    return "fft"


def conv_valid(xfull: torch.Tensor, taps, strategy: str = "auto") -> torch.Tensor:
    """Causal valid convolution along the last axis: length n + K − 1 → n."""
    taps = np.asarray(taps)
    if strategy == "auto":
        strategy = _auto_strategy(taps, xfull)
    if strategy == "slices":
        return _conv_valid_slices(xfull, taps)
    if strategy == "fft":
        return _conv_valid_fft(xfull, taps)
    if strategy == "pallas_mxu":
        if np.iscomplexobj(taps):
            raise ValueError("pallas_mxu strategy supports real taps only")
        return fir_valid(xfull.contiguous(), taps)
    if strategy == "pallas_fft":
        return fft_fir_valid(xfull.contiguous(), taps)
    if strategy == "pallas_fft_interpret":
        return fft_fir_valid_ref(xfull, taps)
    raise ValueError(f"unknown strategy {strategy!r}")


def fir_stream(taps, hist: torch.Tensor, x: torch.Tensor, strategy: str = "auto"):
    """Same-rate streaming FIR.  ``hist`` holds the K − 1 past inputs
    (..., K − 1); returns (new_hist, y) with y the length of x."""
    taps = np.asarray(taps)
    K = len(taps)
    if K == 1:
        return hist, x * _scalar(taps[0])
    xfull = torch.cat([hist, x], dim=-1)
    y = conv_valid(xfull, taps, strategy)
    return xfull[..., -(K - 1):].clone(), y


def fir_decim_stream(taps, M: int, hist: torch.Tensor, x: torch.Tensor,
                     strategy: str = "auto"):
    """Decimating FIR: y[m] = Σ_k h[k]·x[m·M − k] (stream-indexed).

    The last axis of x must be a multiple of M; y has length n/M.  Polyphase
    ("poly"): phase p of h sees the input sub-stream of stride M; "fft"
    overlap-saves and keeps every M-th output; "auto" picks poly up to 256
    non-zero taps."""
    taps = np.asarray(taps)
    K = len(taps)
    n = x.shape[-1]
    if n % M:
        raise ValueError(f"block of {n} samples is not a multiple of the decimation {M}")
    nout = n // M
    xfull = torch.cat([hist, x], dim=-1)  # n + K − 1
    if strategy == "auto":
        strategy = "poly" if np.count_nonzero(taps) <= 4 * _FFT_MIN_TAPS else "fft"
    if strategy == "fft":
        y = _conv_valid_fft(xfull, taps)[..., ::M]
    else:
        # y[m] = Σ_p Σ_l h[p + lM] · xfull[(K−1) + mM − p − lM]
        c = K - 1
        acc = None
        for p in range(M):
            hp = taps[p::M]
            if not np.count_nonzero(hp):
                continue
            d, r = divmod(c - p, M)
            v = xfull[..., r::M]  # v[i] = xfull[i·M + r]
            for l, t in enumerate(hp):
                if t == 0.0:
                    continue
                term = v[..., d - l: d - l + nout] * _scalar(t)
                acc = term if acc is None else acc + term
        y = acc if acc is not None else _zeros(xfull, nout)
    return (xfull[..., -(K - 1):].clone() if K > 1 else hist), y


def fir_interp_stream(taps, P: int, hist: torch.Tensor, x: torch.Tensor):
    """Interpolating FIR (zero-stuff by P, then filter):
    y[mP + p] = Σ_l h[p + lP]·x[m − l].  ``hist`` holds ⌈K/P⌉ − 1 past
    inputs; y has length P·n."""
    taps = np.asarray(taps)
    K = len(taps)
    Lsub = -(-K // P)  # taps per phase (max)
    n = x.shape[-1]
    xfull = torch.cat([hist, x], dim=-1) if Lsub > 1 else x
    phases = []
    for p in range(P):
        acc = None
        for l, t in enumerate(taps[p::P]):
            if t == 0.0:
                continue
            term = xfull[..., Lsub - 1 - l: Lsub - 1 - l + n] * _scalar(t)
            acc = term if acc is None else acc + term
        phases.append(acc if acc is not None else _zeros(xfull, n))
    y = torch.stack(phases, dim=-1).reshape(*x.shape[:-1], n * P)
    new_hist = xfull[..., -(Lsub - 1):].clone() if Lsub > 1 else hist
    return new_hist, y
