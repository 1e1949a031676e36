"""The per-sample pilot PLL (K7) and its plain PyTorch version.

No Pallas counterpart: it replaces the ``lax.scan`` of
``csdr_tpu/models/stereo.py:fms_pll_scan``, the stereo decoder's
``pll_mode="scan"``.  For each row of an analytic pilot p (…, n), in
float32, K7 uses angle(p·e^{−jθ}) = wrap(arg p − θ):

    φ[n] = atan2(Im p[n], Re p[n])                       (every n at once)
    d = φ[n] − θ;  e = d + 2π if d ≤ −π else d;  freq += β·e;  θ_out[n] = θ;
    x = ((θ + ω) + freq) + α·e;  θ ← x + 2π if x < 0, x − 2π if x ≥ 2π, else x

and the regenerated subcarrier sub38[n] = e^{2jθ_out[n]} (every n at once).
On the loop's range the cheap wraps are exact: d + 2π for d in (−3π, −π]
and x − 2π for x in [2π, 4π) (Sterbenz), and x + 2π for x in (−2π, 0) is
the one rounding of the floored mod.  Two rare branches keep the JAX
semantics elsewhere: where d is not in (−3π, π] (p = 0, whose φ is taken
as NaN, or a carried θ outside [0, 2π)) e is the angle of the rotated
product, atan2(Im, Re) of p·(cos θ − j sin θ), as JAX computes it; where x
is not in (−2π, 4π) θ is mod(x, 2π) (floored, as ``jnp.mod``).  The carry
(θ, freq) has the rows' shape (…).

What bounds the kernel is the loop's dependent chain per sample, θ → d → e
→ freq → θ, about ten cheap instructions: the atan2 and the sincos run in
parallel passes beside the loop (``csrc/pll_scan.cu``).  On a CUDA tensor
``pll_scan`` launches that kernel or raises; only a tensor on the CPU takes
the plain version ``pll_scan_ref``, a Python loop over samples in the
kernel's order.  ``launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["pll_scan", "pll_scan_ref", "launches"]

_PI = np.float32(np.pi)
_TWO_PI = np.float32(2.0 * np.pi)     # 2·_PI exactly
_THREE_PI = np.float32(3.0 * np.pi)
_FOUR_PI = np.float32(4.0 * np.pi)    # 4·_PI exactly

launches = 0


def _check(p: torch.Tensor, theta: torch.Tensor, freq: torch.Tensor):
    if p.dtype != torch.complex64 or p.ndim < 1:
        raise ValueError(f"pll_scan: p must be complex64 rows (…, n), got {p.dtype} "
                         f"{tuple(p.shape)}")
    for name, c in (("theta", theta), ("freq", freq)):
        if c.dtype != torch.float32 or tuple(c.shape) != tuple(p.shape[:-1]):
            raise ValueError(f"pll_scan: {name} must be float32 of shape "
                             f"{tuple(p.shape[:-1])}, got {c.dtype} {tuple(c.shape)}")


def pll_scan_ref(p: torch.Tensor, carry, omega: float, alpha: float, beta: float):
    """Plain K7: ((θ, freq), sub38) by a Python loop over the samples, every
    row at once, in the kernel's float32 order: the φ pass, the loop with
    its cheap wraps and rare branches, the e^{2jθ} pass."""
    theta, freq = carry
    _check(p, theta, freq)
    omega, alpha, beta = (np.float32(v) for v in (omega, alpha, beta))
    pr, pi = p.real, p.imag
    phi = torch.where((pr == 0) & (pi == 0), torch.nan, torch.atan2(pi, pr))
    thetas = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    for i in range(p.shape[-1]):
        d = phi[..., i] - theta
        e = torch.where(d <= -_PI, d + _TWO_PI, d)
        cheap = (d > -_THREE_PI) & (d <= _PI)
        if not bool(cheap.all()):
            # the angle of the rotated product p·(cos θ − j sin θ)
            c, s = torch.cos(theta), torch.sin(theta)
            a, b = pr[..., i], pi[..., i]
            e = torch.where(cheap, e, torch.atan2(b * c - a * s, a * c + b * s))
        thetas[..., i] = theta
        freq = freq + beta * e
        x = ((theta + omega) + freq) + alpha * e
        theta = torch.where(x < 0, x + _TWO_PI, torch.where(x >= _TWO_PI, x - _TWO_PI, x))
        near = (x > -_TWO_PI) & (x < _FOUR_PI)
        if not bool(near.all()):
            theta = torch.where(near, theta, torch.remainder(x, _TWO_PI))
    two = 2 * thetas
    return (theta, freq), torch.complex(torch.cos(two), torch.sin(two))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import load_library

    fn = load_library().csdr_pll_scan
    P, F = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [P, ctypes.c_longlong, ctypes.c_int, P, P, F, F, F, P, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def pll_scan(p: torch.Tensor, carry, omega: float, alpha: float, beta: float):
    """K7: p (…, n) complex64, carry (θ (…), freq (…)) float32 →
    ((θ, freq), sub38 (…, n) complex64)."""
    global launches
    theta, freq = carry
    _check(p, theta, freq)
    if p.device.type == "cpu":
        return pll_scan_ref(p, carry, omega, alpha, beta)
    if p.device.type != "cuda":
        raise ValueError(f"pll_scan runs on cuda or cpu tensors, got {p.device}")
    n = p.shape[-1]
    rows = int(np.prod(p.shape[:-1], dtype=np.int64))
    if rows > 2 ** 31 - 1:
        raise ValueError(f"pll_scan: {rows} rows is more than the grid takes")
    p = p.contiguous()
    theta, freq = theta.contiguous(), freq.contiguous()
    sub = torch.empty_like(p)
    theta_out, freq_out = torch.empty_like(theta), torch.empty_like(freq)
    if rows == 0 or n == 0:
        return (theta.clone(), freq.clone()), sub
    fn = _kernel_fn()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), n, rows, theta.data_ptr(), freq.data_ptr(), float(np.float32(omega)),
                 float(np.float32(alpha)), float(np.float32(beta)), sub.data_ptr(),
                 theta_out.data_ptr(), freq_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pll_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return (theta_out, freq_out), sub
