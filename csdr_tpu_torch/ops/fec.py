"""Convolutional FEC: the encoder and a soft-decision Viterbi decoder.

Counterpart of ``csdr_tpu/ops/fec.py``.  The trellis tables and the
encoder are its numpy, copied.  The decoder runs on the host in numpy
whatever the LLRs' device: its add-compare-select is one vector step over
the 2^(K−1) = 64 states per coded symbol (the JAX package's ``lax.scan``),
too little work per step to pay for the card's launches (PERF.md §6), and
the traceback is a serial walk of one state per symbol.

Conventions: polynomials are octal-style integers whose bit i taps register
delay i (bit 0 = the newest input bit).  ``tail=True`` appends K−1 zero
flush bits, so the decoder starts and ends in state 0.  Soft inputs are
LLRs with the ``models/modem.soft_llrs`` convention (positive = bit 0).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["CCSDS_POLYS", "conv_encode", "viterbi_decode", "coded_ber"]

CCSDS_POLYS = (0o171, 0o133)   # K=7 rate-1/2


def _parity(v: np.ndarray) -> np.ndarray:
    p = np.zeros_like(v)
    while np.any(v):
        p ^= v & 1
        v >>= 1
    return p


@functools.lru_cache(maxsize=None)
def _tables(polys: tuple, K: int):
    """Trellis constants: for each next-state ns its two predecessor states
    and, per generator, the output bits of those transitions."""
    S = 1 << (K - 1)
    s = np.arange(S)
    # register for (state s, input b) = (s << 1) | b: the input is the
    # newest (delay 0) bit, the state holds the previous K−1 bits
    out = np.zeros((2, len(polys), S), np.int8)
    for b in (0, 1):
        r = (s << 1 | b)
        for gi, g in enumerate(polys):
            out[b, gi] = _parity((r & g).astype(np.int64))
    # predecessors of ns: s = (ns >> 1) | (h << (K−2)) for h ∈ {0, 1}, with
    # input bit b = ns & 1
    ns = np.arange(S)
    prev = np.stack([(ns >> 1), (ns >> 1) | (1 << (K - 2))])   # (2, S)
    bit_in = ns & 1                                            # (S,)
    # output bits of the two incoming branches, per generator: (2, G, S)
    branch_out = np.stack([out[bit_in, :, prev[h]].T for h in (0, 1)])
    return S, prev, bit_in, branch_out


def conv_encode(bits: np.ndarray, polys: tuple = CCSDS_POLYS, K: int = 7,
                tail: bool = True) -> np.ndarray:
    """Message bits → coded bits, generator-interleaved (g0(t0), g1(t0),
    g0(t1), …).  numpy (the transmit side)."""
    b = np.asarray(bits, np.int64) & 1
    if tail:
        b = np.concatenate([b, np.zeros(K - 1, np.int64)])
    reg = 0
    out = np.zeros((len(b), len(polys)), np.int8)
    for t, bit in enumerate(b):
        reg = ((reg << 1) | int(bit)) & ((1 << K) - 1)
        for gi, g in enumerate(polys):
            out[t, gi] = bin(reg & g).count("1") & 1
    return out.reshape(-1)


def viterbi_decode(llrs, polys: tuple = CCSDS_POLYS, K: int = 7,
                   tail: bool = True) -> torch.Tensor:
    """Soft-decision Viterbi: LLRs (n_sym · n_gen,) generator-interleaved
    (positive = bit 0), a tensor or numpy (then on the CPU) → decoded
    message bits, uint8 (n_sym − (K−1) if ``tail``), on the LLRs' device.

    Each step keeps, for every next-state, the better of its two incoming
    paths; a tie keeps the first predecessor, as ``jnp.argmax`` does in the
    JAX decoder, and the metrics are re-normalized to a maximum of 0 after
    every step, as there, in float32."""
    S, prev, bit_in, branch_out = _tables(tuple(polys), K)
    G = len(polys)
    dev = llrs.device if isinstance(llrs, torch.Tensor) else torch.device("cpu")
    if isinstance(llrs, torch.Tensor):
        llrs = llrs.detach().to("cpu", torch.float32).numpy()
    llr = np.asarray(llrs, np.float32).reshape(-1, G)                  # (T, G)
    T = llr.shape[0]
    if T == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    # with signs ±1 and G = 2 every branch metric is exact in any order
    bm = np.einsum("tg,hgs->ths", llr, (1.0 - 2.0 * branch_out).astype(np.float32))
    metric = np.full(S, -1e9, np.float32)
    metric[0] = 0.0                                # tail ⇒ start in state 0
    dec = np.empty((T, S), np.uint8)
    for t in range(T):
        cand = metric[prev] + bm[t]                                      # (2, S)
        dec[t] = cand[1] > cand[0]
        new = np.maximum(cand[0], cand[1])
        metric = new - new.max()
    state = 0 if tail else int(np.argmax(metric))
    bits = np.empty(T, np.uint8)
    for t in range(T - 1, -1, -1):
        bits[t] = bit_in[state]
        state = int(prev[dec[t, state], state])
    bits = bits[: T - (K - 1)] if tail else bits
    return torch.from_numpy(bits).to(dev)


def coded_ber(n_bits: int, snr_db: float, seed: int = 0, polys: tuple = CCSDS_POLYS,
              K: int = 7):
    """BPSK-over-AWGN loopback at ``snr_db`` (Es/N0 of the CODED symbols):
    returns (coded BER, uncoded BER at the same channel SNR)."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, n_bits)
    coded = conv_encode(msg, polys, K)
    es = 10.0 ** (snr_db / 10.0)
    sigma = np.sqrt(1.0 / (2.0 * es))
    tx = 1.0 - 2.0 * coded.astype(np.float64)
    rx = tx + sigma * rng.normal(size=len(tx))
    llr = (2.0 / sigma ** 2) * rx                 # positive = bit 0
    dec = viterbi_decode(llr, polys, K).numpy()
    ber = float(np.mean(dec != msg))
    ber_uncoded = float(np.mean((rx < 0).astype(np.int8) != coded))
    return ber, ber_uncoded
