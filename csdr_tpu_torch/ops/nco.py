"""Numerically-controlled oscillator (frequency shift).

Counterpart of ``csdr_tpu/ops/nco.py``.  ``phase_ramp`` and
``phase_increment`` are the JAX package's float64 numpy design code,
copied: the per-sample phase ω·k mod 2π is made in float64 on the host, so
a 2^23-sample block suffers no float32 phase accumulation; only the scalar
carried phase is run-time state.  ``phase_table`` is each time rank's
phase offset under sharding, made the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["phase_ramp", "phase_increment", "phase_table", "mix_stream"]

_TWO_PI = 2.0 * np.pi


@functools.lru_cache(maxsize=None)
def phase_ramp(omega: float, n: int) -> np.ndarray:
    """Static per-sample phases (ω·k mod 2π), float64-accurate, as float32."""
    k = np.arange(n, dtype=np.float64)
    return np.mod(omega * k, _TWO_PI).astype(np.float32)


@functools.lru_cache(maxsize=None)
def phase_increment(omega: float, n: int) -> float:
    """(n·ω) mod 2π as a float64-accurate python float."""
    return float(np.mod(np.float64(omega) * n, _TWO_PI))


@functools.lru_cache(maxsize=None)
def phase_table(omega: float, nloc: int, dt: int) -> np.ndarray:
    """Per-rank phase offsets of a time-sharded NCO: entry i is
    (ω·nloc·i) mod 2π, float64-accumulated, as float32.  Rank i starts its
    local ramp at the carried phase plus this offset, so sharding the NCO
    needs no collective."""
    i = np.arange(dt, dtype=np.float64)
    return np.mod(np.float64(omega) * nloc * i, _TWO_PI).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _ramp_on(omega: float, n: int, device: torch.device) -> torch.Tensor:
    # one host→device copy per (ω, block length, device), not one per block
    return torch.from_numpy(phase_ramp(omega, n)).to(device)


def mix_stream(phase: torch.Tensor, x: torch.Tensor, omega: float, up: bool):
    """Multiply a block by e^{±j(phase + ω·k)}; returns (new_phase, y).

    ``phase`` is the carried float32 tensor on ``x``'s device: 0-d, or one
    phase per row of a batch (inside ``PerChannel``, (nch,) for (nch, n)
    blocks); ``up`` selects e^{+jθ} (mix up) or e^{−jθ} (mix down)."""
    n = x.shape[-1]
    ramp = _ramp_on(float(omega), int(n), x.device)
    theta = phase[..., None] + ramp
    rot = torch.polar(torch.ones_like(theta), theta if up else -theta)
    y = x * rot
    new_phase = torch.remainder(phase + np.float32(phase_increment(float(omega), int(n))),
                                np.float32(_TWO_PI))
    return new_phase, y
