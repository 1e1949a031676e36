"""Coded 4-FSK beacon mode: below-noise-floor telemetry decode.

Counterpart of ``csdr_tpu/models/beacon.py``, whose docstring is the mode's
specification:

  * message: 56 bits + CRC-8 (poly 0x07, the accept/reject gate) = 64-bit
    payload, conv-encoded rate-1/2 K=7 (171,133)₈ with tail → 140 symbols,
    one coded bit each;
  * symbol: 4-FSK, tone ∈ {0..3} = 2·coded_bit + sync_bit, tone spacing =
    baud, ``spsym`` samples per symbol at complex baseband;
  * sync: a fixed 140-chip LFSR sequence (x⁷+x⁶+1, seed 0x7F) in the tone
    LSB.

The sync search is a host loop over integer sample offsets × frequency bins
on numpy panels (``tone_energies``), as in the JAX package; the soft LLRs
go to ``ops/fec.viterbi_decode``.  ``tone_energies_device`` is the same
correlation as one complex matmul on a tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fec

__all__ = [
    "MESSAGE_BITS", "PAYLOAD_BITS", "N_SYMBOLS", "sync_chips", "crc8",
    "beacon_modulate", "tone_energies", "tone_energies_device", "beacon_decode",
]

MESSAGE_BITS = 56                    # user bits per transmission
PAYLOAD_BITS = MESSAGE_BITS + 8      # + CRC-8 (the accept/reject gate)
N_SYMBOLS = 2 * (PAYLOAD_BITS + 6)   # rate-1/2 K=7 with tail


def crc8(bits: np.ndarray) -> np.ndarray:
    """CRC-8 (poly 0x07, init 0) over a bit array, MSB-first → 8 bits."""
    reg = 0
    for b in np.asarray(bits, np.int64) & 1:
        reg ^= int(b) << 7
        reg = ((reg << 1) ^ (0x07 if reg & 0x80 else 0)) & 0xFF
    return np.asarray([(reg >> (7 - i)) & 1 for i in range(8)], np.int64)


def sync_chips(n: int = N_SYMBOLS) -> np.ndarray:
    """Fixed LFSR sync sequence (x^7 + x^6 + 1, seed 0x7F), one chip per
    symbol in the tone LSB."""
    reg = 0x7F
    out = np.zeros(n, np.int64)
    for i in range(n):
        out[i] = reg & 1
        fb = ((reg >> 6) ^ (reg >> 5)) & 1
        reg = ((reg << 1) | fb) & 0x7F
    return out


def _tone_matrix(spsym: int) -> np.ndarray:
    """(spsym, 4) conjugate tone basis: tone k at k·baud = k/spsym
    cycles/sample (orthogonal over one symbol)."""
    t = np.arange(spsym)[:, None]
    k = np.arange(4)[None, :]
    return np.exp(-2j * np.pi * (k / spsym) * t).astype(np.complex64)


def beacon_modulate(message: np.ndarray, spsym: int = 64, amplitude: float = 1.0) -> np.ndarray:
    """56 message bits → complex baseband (N_SYMBOLS·spsym,): CRC-8
    appended, conv-encoded, tones at {0..3}·baud, phase-continuous."""
    message = np.asarray(message, np.int64) & 1
    if len(message) != MESSAGE_BITS:
        raise ValueError(f"message must be {MESSAGE_BITS} bits")
    payload = np.concatenate([message, crc8(message)])
    # one coded bit per symbol: adjacent symbols carry the two generators'
    data = fec.conv_encode(payload)[:N_SYMBOLS]
    tones = 2 * data + sync_chips()
    # phase-continuous FM: per-sample frequency = tone/spsym cycles/sample
    freq = np.repeat(tones.astype(np.float64) / spsym, spsym)
    ph = 2.0 * np.pi * np.cumsum(freq)
    return (amplitude * np.exp(1j * ph)).astype(np.complex64)


def tone_energies(x: np.ndarray, spsym: int) -> np.ndarray:
    """Complex baseband (T·spsym,) at a candidate alignment → (T, 4) tone
    energies, numpy (the sync search calls it per candidate on small
    panels)."""
    M = len(x) // spsym
    xs = np.asarray(x[: M * spsym]).reshape(M, spsym)
    return np.abs(xs @ _tone_matrix(spsym))


def tone_energies_device(x: torch.Tensor, spsym: int) -> torch.Tensor:
    """``tone_energies`` as one complex matmul on the tensor's device:
    complex64 (n,) → float32 (n // spsym, 4).  (The JAX function takes
    (n, 2) re/im planes, a boundary its TPU backend needs.)"""
    M = x.shape[-1] // spsym
    xs = x[..., : M * spsym].reshape(*x.shape[:-1], M, spsym)
    C = torch.as_tensor(_tone_matrix(spsym), device=x.device)
    return (xs @ C).abs()


def beacon_decode(x: np.ndarray, spsym: int = 64, search: int | None = None,
                  freq_bins: int = 5):
    """Complex baseband → (payload bits or None, info).

    Sync search: for every integer sample offset in [0, spsym) (stride
    spsym//8 coarse, then ±4 fine) and every frequency offset in
    ±(freq_bins//2) tone spacings, score the known sync chips against the
    tone-LSB energy split; decode the best candidate and verify by
    re-encoding."""
    x = np.asarray(x)
    chips = sync_chips()
    if search is None:
        search = spsym
    coarse = list(range(0, search, max(1, spsym // 8)))

    def score_at(off, fshift):
        seg = x[off:]
        if len(seg) < N_SYMBOLS * spsym:
            return None
        if fshift:
            t = np.arange(len(seg))
            seg = seg * np.exp(-2j * np.pi * fshift * t / spsym)
        e = np.asarray(tone_energies(seg, spsym))[:N_SYMBOLS]
        if e.shape[0] < N_SYMBOLS:
            return None
        # sync metric: energy where the LSB matches the chip minus mismatch
        lsb1 = e[:, 1] + e[:, 3]
        lsb0 = e[:, 0] + e[:, 2]
        m = np.where(chips == 1, lsb1 - lsb0, lsb0 - lsb1).sum()
        return m, e

    cands = [(off, f) for off in coarse
             for f in range(-(freq_bins // 2), freq_bins // 2 + 1)]
    scored = []
    for off, f in cands:
        r = score_at(off, f)
        if r is not None:
            scored.append((r[0], off, f))
    if not scored:
        return None, {"synced": False}
    scored.sort(reverse=True)
    _, off0, f0 = scored[0]
    # fine offset refinement around the winner: ±4 covers the coarse stride
    best_m, best_e, best_off = -np.inf, None, off0
    for off in range(max(0, off0 - 4), off0 + 5):
        r = score_at(off, f0)
        if r is not None and r[0] > best_m:
            best_m, best_e, best_off = r[0], r[1], off
    e = best_e
    # soft LLR per symbol from the sync-known tone pair: bit 0 ⇒ tone
    # chips[i], bit 1 ⇒ tone 2+chips[i]; positive = bit 0
    lo = e[np.arange(N_SYMBOLS), chips]
    hi = e[np.arange(N_SYMBOLS), 2 + chips]
    llr = (lo - hi).astype(np.float64)
    scale = 4.0 / max(np.median(np.abs(llr)), 1e-9)
    dec = fec.viterbi_decode(llr * scale).numpy()
    payload = dec[:PAYLOAD_BITS]
    message = payload[:MESSAGE_BITS]
    # accept gate: the CRC-8 (noise often yields a plausible ML codeword)
    crc_ok = bool(np.array_equal(payload[MESSAGE_BITS:], crc8(message)))
    re = fec.conv_encode(payload).reshape(-1)[:N_SYMBOLS]
    hard = (hi > lo).astype(np.int64)
    agree = float(np.mean(re == hard))
    return (message if crc_ok else None), {
        "synced": True, "offset": int(best_off), "freq_bin": int(f0),
        "sync_score": float(best_m), "agreement": agree, "crc_ok": crc_ok}
