"""Parallel first-order linear recurrences, y[n] = a·y[n−1] + b[n].

Counterpart of ``csdr_tpu/ops/linrec.py``, with the same blocked algorithm,
run along the last axis so that a (nch, n) channel panel solves one
recurrence per row (the JAX package vmaps the 1-D solve instead):

  1. reshape the forcing sequence into (B, L) blocks,
  2. solve each block with zero carry as one matmul, w = b @ Tᵀ with the
     static lower-triangular decay matrix T[i, j] = a^(i−j),
  3. propagate the block carries g[k] = a^L·g[k−1] + w[k, L−1] with a
     log-depth scan over the B blocks,
  4. add the carried term y[k, i] = w[k, i] + a^(i+1)·g[k−1].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["linrec", "linrec_ref"]

_DEF_L = 128


@functools.lru_cache(maxsize=None)
def _decay_matrices(a: complex | float, L: int):
    """Static (L, L) lower-triangular decay matrix and the a^(i+1) vector."""
    i = np.arange(L)
    expo = np.maximum(i[:, None] - i[None, :], 0)
    T = np.where(i[:, None] >= i[None, :], np.power(a, expo), 0.0)
    apow = np.power(a, i + 1)
    dt = np.complex64 if isinstance(a, complex) else np.float32
    return np.asarray(T, dtype=dt), np.asarray(apow, dtype=dt)


@functools.lru_cache(maxsize=None)
def _carry_powers(a: complex | float, L: int, B: int):
    """aL^d for the doubling steps d = 1, 2, 4, … < B, and aL^(k+1) for
    k < B, with aL = a^L (float64 on the host, then cast)."""
    aL = np.power(a, L)
    dt = np.complex64 if isinstance(a, complex) else np.float32
    steps = []
    d = 1
    while d < B:
        steps.append(np.asarray(np.power(aL, d), dtype=dt).item())
        d *= 2
    seed = np.asarray(np.power(aL, np.arange(1, B + 1)), dtype=dt)
    return tuple(steps), seed


@functools.lru_cache(maxsize=32)
def _constants_on(a: complex | float, L: int, B: int, device: torch.device, dt: torch.dtype):
    """The decay matrix, a^(i+1), the doubling steps and the carry seeds on
    ``device``, made once per (a, L, B, device, dtype): a blocking
    host→device copy synchronises the stream, so none runs per call."""
    T_np, apow_np = _decay_matrices(a, L)
    steps, seed_np = _carry_powers(a, L, B)
    put = lambda v: torch.from_numpy(v).to(device)
    return put(T_np).T, put(apow_np).to(dt), steps, put(seed_np).to(dt)


def linrec(b: torch.Tensor, a: complex | float, y0: torch.Tensor,
           block: int = _DEF_L) -> torch.Tensor:
    """Solve y[n] = a·y[n−1] + b[n] along the last axis, with y[−1] = y0.

    ``a`` is a static python scalar, ``b`` a float32 or complex64 tensor of
    shape (..., n): every row is its own recurrence, and ``y0`` holds one
    carry per row (shape (...), or a scalar for all rows).  Returns y with
    the promoted dtype of (b, a, y0), on ``b``'s device."""
    n = b.shape[-1]
    if isinstance(a, complex) and a.imag == 0.0:
        a = a.real
    a_complex = isinstance(a, complex)
    out_complex = a_complex or b.is_complex() or torch.as_tensor(y0).is_complex()
    dt = torch.complex64 if out_complex else torch.float32
    b = b.to(dt)
    batch = b.shape[:-1]
    y0 = torch.as_tensor(y0, device=b.device).to(dt).expand(batch)[..., None]

    L = min(block, max(8, n))
    B = -(-n // L)
    pad = B * L - n
    if pad:
        b = torch.cat([b, b.new_zeros(batch + (pad,))], dim=-1)
    bb = b.reshape(batch + (B, L))

    a_key = complex(a) if a_complex else float(a)
    Tt, apow, steps, seed = _constants_on(a_key, L, B, b.device, dt)

    # within-block solution with zero carry; a real pole on complex forcing
    # runs as two real matmuls
    if out_complex and not a_complex:
        w = torch.complex(bb.real @ Tt, bb.imag @ Tt)
    else:
        w = bb @ Tt

    # block carries: uniform decay aL, so the inclusive scan is a doubling
    # (Hillis-Steele) sum  v[k] += aL^d · v[k−d]
    v = w[..., -1].clone()
    d = 1
    for p in steps:
        v = torch.cat([v[..., :d], v[..., d:] + p * v[..., :-d]], dim=-1)
        d *= 2
    g = v + seed * y0
    g_prev = torch.cat([y0, g[..., :-1]], dim=-1)

    y = (w + apow * g_prev[..., None]).reshape(batch + (B * L,))
    return y[..., :n] if pad else y


def linrec_ref(b: np.ndarray, a: complex | float, y0: complex | float) -> np.ndarray:
    """Sequential float64/complex128 oracle for tests."""
    cplx = np.iscomplexobj(b) or isinstance(a, complex)
    y = np.empty(len(b), dtype=np.complex128 if cplx else np.float64)
    acc = y0
    for i, bi in enumerate(b):
        acc = a * acc + bi
        y[i] = acc
    return y
