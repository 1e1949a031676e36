"""Overlap-save FFT FIR at S = 16384 (K6) and its plain PyTorch version.

Counterpart of ``csdr_tpu/ops/pallas/fftfir.py:fft_fir_valid``, the
``"pallas_fft"`` strategy of ``ops/fir.conv_valid``: a causal valid
convolution of rows xfull (..., n + K − 1) with real or complex taps
(K < 16384), any leading batch axes.  Segments of S = 16384 samples start
every hop = S − (K − 1) samples and each yields its last hop samples, as in
the JAX kernel; real input with real taps gives float32, anything else
complex64.

On a CUDA tensor ``fft_fir_valid`` launches the hand-written kernel of
``csrc/fft_fir.cu`` or raises; only a tensor on the CPU takes the plain
version ``fft_fir_valid_ref`` (the same overlap-save with ``torch.fft``).
``launches`` counts the calls that launched the kernel.  The kernel's H
(the taps' S-point DFT / S, in the order its 16 × 16 × 16 × 4 register
passes leave the spectrum, ``transform_order``) is made in float64 on the
host and cached per device; real input with real taps runs two segments
per transform, one in each of the real and imaginary parts.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .fir_valid import launch_rows, valid_len

__all__ = ["fft_fir_valid", "fft_fir_valid_ref", "segments", "launches", "S"]

S = 16384              # csrc/fft_fir.cu kS = 4^7

launches = 0


def segments(n: int, K: int) -> tuple[int, int]:
    """(hop, nseg) of the overlap-save over n outputs with K taps."""
    hop = S - (K - 1)
    return hop, -(-n // hop)


def _check_taps(taps: np.ndarray) -> int:
    """Validate the taps as the JAX function does; returns K."""
    K = len(taps)
    if taps.ndim != 1 or K < 1:
        raise ValueError(f"fft_fir_valid: taps must be (K,), got {taps.shape}")
    if K >= S:
        raise ValueError(f"taps ({K}) must be shorter than the {S} segment")
    return K


@functools.lru_cache(maxsize=64)
def fft_response_on(key: bytes, dtype: str, S: int, real: bool, device: torch.device):
    """The taps' S-point DFT (rfft for real data and taps), complex64, once
    per taps and device.  The plain K6 and ``ops/fir``'s "fft" strategy read
    it; the kernel's table is derived from it."""
    h = np.frombuffer(key, dtype)
    H = np.fft.rfft(h.astype(np.float64), S) if real else np.fft.fft(h.astype(np.complex128), S)
    return torch.from_numpy(H.astype(np.complex64)).to(device)


def fft_fir_valid_ref(xfull: torch.Tensor, taps) -> torch.Tensor:
    """Plain K6: the same segments, ``torch.fft.fft`` → × H → ``ifft``."""
    taps = np.asarray(taps)
    K = _check_taps(taps)
    n = valid_len("fft_fir_valid", xfull, K)
    hop, nseg = segments(n, K)
    total = (nseg - 1) * hop + S
    xc = xfull.to(torch.complex64)
    pad = total - xfull.shape[-1]
    if pad > 0:
        xc = torch.nn.functional.pad(torch.view_as_real(xc), (0, 0, 0, pad))
        xc = torch.view_as_complex(xc)
    segs = xc.unfold(-1, S, hop)                                     # (..., nseg, S)
    H = fft_response_on(taps.tobytes(), taps.dtype.str, S, False, xfull.device)
    Y = torch.fft.ifft(torch.fft.fft(segs, dim=-1) * H, dim=-1)
    y = Y[..., K - 1:].reshape(*xfull.shape[:-1], nseg * hop)[..., :n]
    if xfull.is_complex() or np.iscomplexobj(taps):
        return y.contiguous()
    return y.real.contiguous()


def transform_order() -> np.ndarray:
    """The order in which the kernel's forward transform leaves the
    spectrum, as the kernel reads H: entry j·1024 + u (point j of butterfly
    u, position p = 16u + j) is bin k1 + 16·k2 + 256·k3 + 4096·k4 for
    p = k1·1024 + k2·64 + k3·4 + k4 (passes 16 × 16 × 16 × 4)."""
    p = (16 * np.arange(S // 16)[None, :] + np.arange(16)[:, None]).reshape(-1)
    return (p >> 10) + 16 * ((p >> 6) & 15) + 256 * ((p >> 2) & 15) + 4096 * (p & 3)


@functools.lru_cache(maxsize=64)
def _kernel_spectrum_on(key: bytes, dtype: str, device: torch.device) -> torch.Tensor:
    """The kernel's H: the taps' S-point DFT / S in ``transform_order``,
    complex64 (both steps exact on the float32 DFT), made once per taps and
    device (a blocking copy synchronises the stream)."""
    H = fft_response_on(key, dtype, S, False, device)
    return (H[torch.from_numpy(transform_order()).to(device)] / S).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import load_library

    fn = load_library().csdr_fft_fir
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, I, P, P, LL, LL, I, I, I, I, P, P]
    fn.restype = ctypes.c_int
    return fn


def fft_fir_valid(xfull: torch.Tensor, taps) -> torch.Tensor:
    """K6: xfull (..., n + K − 1) float32 or complex64, taps (K,) real or
    complex, K < 16384 → (..., n), complex64 unless both are real."""
    global launches
    taps = np.asarray(taps)
    K = _check_taps(taps)
    n = valid_len("fft_fir_valid", xfull, K)
    if xfull.device.type == "cpu":
        return fft_fir_valid_ref(xfull, taps)
    rows = launch_rows("fft_fir_valid", xfull)
    complex_out = xfull.is_complex() or np.iscomplexobj(taps)
    out = torch.empty((*xfull.shape[:-1], n),
                      dtype=torch.complex64 if complex_out else torch.float32,
                      device=xfull.device)
    if rows == 0:
        return out
    hop, nseg = segments(n, K)
    H = _kernel_spectrum_on(taps.tobytes(), taps.dtype.str, xfull.device)
    with torch.cuda.device(xfull.device):
        stream = torch.cuda.current_stream(xfull.device).cuda_stream
        err = _kernel_fn()(int(xfull.is_complex()), int(complex_out), xfull.data_ptr(),
                           H.data_ptr(), n, xfull.shape[-1], K, hop, nseg, rows,
                           out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fft_fir_valid kernel launch failed: CUDA error {err}")
    launches += 1
    return out
