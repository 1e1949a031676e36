"""Polyphase filterbank (PFB) analysis channelizer.

Counterpart of ``csdr_tpu/ops/pfb.py``.  A block of F frames is processed
at once:

  1. polyphase split: v[i, p] = x[i·nch − p]  (one reshape + flip),
  2. per-branch FIR along the frame axis (L = 2m taps),
  3. DFT across branches as an (F, nch) @ (nch, nch) complex matmul.

Channel k (after the NCO pre-shift by ``pfb_offset``) is centred at
2π·(k − (nch−1)/2)/nch: channels run from the bottom of the band to the top.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.firdes import pfb_kaiser_prototype

__all__ = ["pfb_offset", "pfb_taps", "pfb_dft_matrix", "pfb_design", "pfb_analyze_init",
           "pfb_analyze_stream", "branch_dft", "halo_panels"]


def pfb_offset(nch: int) -> float:
    """NCO pre-shift frequency in rad/sample (reference Liquid.chs:817)."""
    return -0.5 * (nch - 1) / nch * 2.0 * np.pi


@functools.lru_cache(maxsize=None)
def pfb_taps(nch: int, m: int = 7, as_db: float = 80.0) -> np.ndarray:
    """(L, nch) polyphase tap matrix, L = 2·m taps per branch; branch p holds
    h[l·nch + p].  Prototype normalized to unity channel gain (Σh = 1)."""
    h = pfb_kaiser_prototype(nch, m, as_db)
    h = h / h.sum()
    L = len(h) // nch
    return h.reshape(L, nch).astype(np.float32)


@functools.lru_cache(maxsize=None)
def pfb_dft_matrix(nch: int) -> np.ndarray:
    """(nch, nch) matrix W[p, k] = e^{+j·2π·k·p/nch} (un-normalized IDFT)."""
    p = np.arange(nch)
    return np.exp(2j * np.pi * np.outer(p, p) / nch).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def pfb_design(nch: int, m: int, as_db: float, device: torch.device):
    """(taps (L, nch) float32, W (nch, nch) complex64) on ``device``, made
    once per device: a blocking host→device copy synchronises the stream."""
    return (torch.from_numpy(pfb_taps(nch, m, as_db)).to(device),
            torch.from_numpy(pfb_dft_matrix(nch)).to(device))


def pfb_analyze_init(nch: int, device: torch.device, m: int = 7):
    """(tail of the previous block, nch−1 samples; branch FIR history, L−1
    frames)."""
    L = 2 * m
    return (torch.zeros((nch - 1,), dtype=torch.complex64, device=device),
            torch.zeros((L - 1, nch), dtype=torch.complex64, device=device))


def pfb_analyze_stream(state, x: torch.Tensor, nch: int, m: int = 7, as_db: float = 80.0):
    """Channelize one block; len(x) must be a multiple of nch.  Returns
    (new_state, y) with y of shape (nch, F), channel-major."""
    hist_x, hist_v = state
    n = x.shape[0]
    F = n // nch
    taps, W = pfb_design(nch, m, float(as_db), x.device)
    L = taps.shape[0]

    xfull = torch.cat([hist_x, x])                        # n + nch − 1
    v = xfull[: F * nch].reshape(F, nch).flip(1)          # v[i, p] = x[i·nch − p]

    vfull = torch.cat([hist_v, v], dim=0)                 # (F + L − 1, nch)
    return (xfull[F * nch:], vfull[F:]), branch_dft(vfull, taps, W)


def branch_dft(vfull: torch.Tensor, taps: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The L-tap FIR of every branch along the frames, then the DFT across
    the branches on ``W``'s columns (all nch, or a rank's column shard):
    vfull (F + L − 1, nch) → (columns, F), channel-major."""
    L = taps.shape[0]
    F = vfull.shape[0] - (L - 1)
    u = None
    for l in range(L):
        term = vfull[L - 1 - l: L - 1 - l + F] * taps[l][None, :]
        u = term if u is None else u + term
    return (u @ W).T


def halo_panels(halo: torch.Tensor, xs: torch.Tensor, nch: int):
    """Frame panels of a time segment behind its left halo.  ``halo``
    holds the k·nch + nch − 1 raw samples before ``xs``: k history frames,
    then the nch − 1 samples that spill into the first frame.  Returns
    (v (F, nch), vfull (k + F, nch)) with v[i, p] = x[i·nch − p]."""
    H = halo.shape[-1] - (nch - 1)
    F = xs.shape[-1] // nch
    xfull = torch.cat([halo[H:], xs])
    v = xfull[:F * nch].reshape(F, nch).flip(1)
    vprev = halo[:H].reshape(H // nch, nch).flip(1)
    return v, torch.cat([vprev, v])
