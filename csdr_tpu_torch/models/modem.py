"""Digital modem support: constellations, hard decisions, soft (LLR)
outputs, and the FEC-coded packet link.

Counterpart of ``csdr_tpu/models/modem.py``.  The constellation tables and
the bit packing are its numpy, copied; the decisions and LLRs are one
(…, n, M) panel of Re(y·c̄) − |c|²/2 on the symbols' device:

  * hard decision: the argmax over the panel (the first of tied maxima, as
    ``jnp.argmax``);
  * soft decision: exact max-log LLRs from the same panel with per-bit
    masked maxima.

Used by ``models/symsync.sym_tracker`` (decision-directed equalizer) and
standalone for offline demodulation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.block import Block

__all__ = ["CONSTELLATIONS", "constellation", "bits_per_symbol", "modulate",
           "hard_decision", "soft_llrs", "symbols_to_bits", "SoftDecision",
           "soft_decision", "coded_packet_modulate", "coded_packet_demodulate"]


def _gray(n: int) -> np.ndarray:
    k = np.arange(n)
    return k ^ (k >> 1)


@functools.lru_cache(maxsize=None)
def constellation(ms: str) -> np.ndarray:
    """Gray-mapped, unit-average-energy constellation, indexed by the
    transmitted bit pattern (MSB first)."""
    if ms == "bpsk":
        return np.array([-1.0 + 0j, 1.0 + 0j], dtype=np.complex128)
    if ms == "qpsk":
        # bits (b1, b0) → (I, Q), gray per axis
        pts = np.array([(-1 - 1j), (-1 + 1j), (1 - 1j), (1 + 1j)], dtype=np.complex128)
        return pts / np.sqrt(2.0)
    if ms == "8psk":
        # index g gray-coded around the circle
        g = _gray(8)
        pts = np.empty(8, dtype=np.complex128)
        for k in range(8):
            pts[g[k]] = np.exp(2j * np.pi * k / 8.0)
        return pts
    if ms in ("qam16", "qam64"):
        side = 4 if ms == "qam16" else 8
        b_ax = side.bit_length() - 1  # bits per axis
        levels = (2 * np.arange(side) - (side - 1)).astype(np.float64)
        # gray-map each axis: axis bits g → level position
        pos = np.empty(side, dtype=np.int64)
        g = _gray(side)
        for k in range(side):
            pos[g[k]] = k
        pts = np.empty(side * side, dtype=np.complex128)
        for bi in range(side):
            for bq in range(side):
                idx = (bi << b_ax) | bq
                pts[idx] = levels[pos[bi]] + 1j * levels[pos[bq]]
        return pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    raise ValueError(f"unknown modulation {ms!r}; have bpsk/qpsk/8psk/qam16/qam64")


CONSTELLATIONS = ("bpsk", "qpsk", "8psk", "qam16", "qam64")


def bits_per_symbol(ms: str) -> int:
    return int(np.log2(len(constellation(ms))))


def modulate(bits: np.ndarray, ms: str) -> np.ndarray:
    """Pack a bit array (MSB first per symbol) into constellation symbols
    (numpy, the transmit side)."""
    bps = bits_per_symbol(ms)
    bits = np.asarray(bits).reshape(-1, bps)
    idx = np.zeros(len(bits), dtype=np.int64)
    for b in range(bps):
        idx = (idx << 1) | bits[:, b]
    return constellation(ms)[idx].astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _tables_on(ms: str, device: torch.device):
    """float32 (Re c, Im c, |c|²/2) of the constellation on ``device``
    (cached there: a pageable upload would wait for the stream)."""
    C = constellation(ms).astype(np.complex64)
    return tuple(torch.as_tensor(np.ascontiguousarray(a).astype(np.float32), device=device)
                 for a in (C.real, C.imag, np.abs(C) ** 2 / 2.0))


@functools.lru_cache(maxsize=32)
def _bit_masks_on(ms: str, device: torch.device):
    """Per bit (MSB first), the (M,) float32 masks 0 / −inf that keep the
    points whose bit is 0, and those whose bit is 1."""
    bps = bits_per_symbol(ms)
    out = []
    for b in range(bps):
        bit = (np.arange(1 << bps) >> (bps - 1 - b)) & 1
        out.append(tuple(torch.as_tensor(np.where(bit == v, 0.0, -np.inf).astype(np.float32),
                                         device=device) for v in (0, 1)))
    return tuple(out)


def _as_symbols(y) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return y
    return torch.as_tensor(np.asarray(y, np.complex64))


def _metric_panel(y: torch.Tensor, ms: str) -> torch.Tensor:
    """(…, n, M) panel of −|y−c|²/const = Re(y·c̄) − |c|²/2 (maximize)."""
    cr, ci, half_e = _tables_on(ms, y.device)
    return y.real[..., None] * cr + y.imag[..., None] * ci - half_e


def hard_decision(y, ms: str):
    """Nearest-point decisions: (indices int32 (…, n), symbols complex64
    (…, n)); the index IS the gray-mapped bit pattern."""
    y = _as_symbols(y)
    idx = torch.argmax(_metric_panel(y, ms), dim=-1)
    cr, ci, _ = _tables_on(ms, y.device)
    return idx.to(torch.int32), torch.complex(cr[idx], ci[idx])


def soft_llrs(y, ms: str, noise_var: float = 0.1) -> torch.Tensor:
    """Max-log LLRs, (…, n, bps) float32, MSB first; positive ⇒ bit 0.

    LLR_b = (min_{c: bit_b=1}|y−c|² − min_{c: bit_b=0}|y−c|²) / N₀."""
    y = _as_symbols(y)
    m = _metric_panel(y, ms)  # maximize ⇔ minimize |y−c|²
    cols = []
    for mask0, mask1 in _bit_masks_on(ms, y.device):
        m0 = (m + mask0).amax(dim=-1)
        m1 = (m + mask1).amax(dim=-1)
        # |y−c|² = |y|² − 2·metric + const; the |y|² and const cancel
        cols.append(2.0 * (m0 - m1) / np.float32(noise_var))
    return torch.stack(cols, dim=-1)


def symbols_to_bits(idx: np.ndarray, ms: str) -> np.ndarray:
    """Decision indices → bit array (n·bps,), MSB first."""
    bps = bits_per_symbol(ms)
    idx = np.asarray(idx, dtype=np.int64)
    out = np.empty((len(idx), bps), dtype=np.int64)
    for b in range(bps):
        out[:, b] = (idx >> (bps - 1 - b)) & 1
    return out.reshape(-1)


class SoftDecision(Block):
    """Stateless block mapping tracked symbols (…, n) → max-log LLRs (…,
    bps, n): time on the last axis, as the port's runtime streams it (the
    JAX block emits ``soft_llrs``' (n, bps))."""

    def __init__(self, ms: str, noise_var: float = 0.1):
        self.ms = ms
        self.noise_var = noise_var
        self.name = f"soft_{ms}"

    def apply(self, state, y):
        return state, soft_llrs(y, self.ms, self.noise_var).movedim(-1, -2)


def soft_decision(ms: str, noise_var: float = 0.1) -> Block:
    return SoftDecision(ms, noise_var)


# ---- the coded packet link: ops/fec.py joined to the modem ----------------

_PREAMBLE_BITS = 64  # 0101... sync/AGC run before the coded payload


def coded_packet_modulate(payload_bits, ms: str = "qpsk", polys=None, K: int = 7):
    """Payload bits → preamble + 16-bit length word + conv-coded symbols
    over any constellation in CONSTELLATIONS (numpy, the transmit side;
    ``coded_packet_demodulate`` inverts it)."""
    from ..ops import fec

    if polys is None:
        polys = fec.CCSDS_POLYS
    payload_bits = np.asarray(payload_bits, np.int64) & 1
    n = len(payload_bits)
    if n > 0xFFFF:
        raise ValueError(f"payload {n} bits exceeds the 16-bit length word (65535)")
    length = [(n >> (15 - i)) & 1 for i in range(16)]
    frame = np.concatenate([length, payload_bits])
    coded = fec.conv_encode(frame, tuple(polys), K)
    pre = np.tile([0, 1], _PREAMBLE_BITS // 2)
    bits = np.concatenate([pre, coded])
    bps = bits_per_symbol(ms)
    if len(bits) % bps:
        bits = np.concatenate([bits, np.zeros(bps - len(bits) % bps, np.int64)])
    return modulate(bits, ms)


def coded_packet_demodulate(symbols, ms: str = "qpsk", noise_var: float = 0.1, polys=None,
                            K: int = 7):
    """Tracked symbols (timing and carrier recovered, e.g. ``sym_tracker``'s
    output; numpy or a tensor on any device) → decoded payload bits (numpy)
    or None.  The soft LLRs are computed on the symbols' device and decoded
    by the Viterbi on the host; the 16-bit length word delimits the
    payload."""
    from ..ops import fec

    if polys is None:
        polys = fec.CCSDS_POLYS
    llr = soft_llrs(symbols, ms, noise_var).reshape(-1)
    G = len(polys)
    body = llr[_PREAMBLE_BITS:]
    body = body[: (body.shape[0] // G) * G]
    dec = fec.viterbi_decode(body, tuple(polys), K).cpu().numpy()
    if len(dec) < 16:
        return None
    n = int("".join(str(int(b)) for b in dec[:16]), 2)
    if 16 + n > len(dec):
        return None
    return dec[16:16 + n]
