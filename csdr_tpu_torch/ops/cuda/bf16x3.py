"""The bf16x3 split on the host, in numpy, as the CUDA kernels do it.

``x_hi = bf16(x)``, ``x_lo = bf16(x − x_hi)``, each rounded to nearest
even, so ``a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi`` (csrc/mma_bf16x3.cuh).
The rounding is done by bit operations on float32, the same contract as
``__float2bfloat16_rn`` on the card.  K5's wrapper builds its tap tables
with it; the CPU tests use it to transcribe the kernels' schedules.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bf16_bits", "bf16_value", "split_bf16", "pack_pairs"]


def bf16_bits(a) -> np.ndarray:
    """float32 → the uint16 bits of bf16, rounded to nearest even (finite
    inputs)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_value(bits) -> np.ndarray:
    """The uint16 bits of bf16 → their float32 value."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def split_bf16(a) -> tuple[np.ndarray, np.ndarray]:
    """float32 → (hi, lo) bf16 bits with hi + lo ≈ a."""
    a = np.asarray(a, np.float32)
    hi = bf16_bits(a)
    return hi, bf16_bits(a - bf16_value(hi))


def pack_pairs(low, high) -> np.ndarray:
    """Two arrays of bf16 bits → uint32 words, ``low`` in the low halves
    (the lower-indexed element of an MMA register)."""
    return np.asarray(low, np.uint32) | (np.asarray(high, np.uint32) << 16)
