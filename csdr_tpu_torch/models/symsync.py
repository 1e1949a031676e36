"""Symbol timing recovery and symbol tracking.

Counterpart of ``csdr_tpu/models/symsync.py``: symSyncR (kaiser matched
filter, 2 samples/symbol out), symSyncC (rnyquist, 32 filters), symTracker
(AGC → timing sync → carrier recovery → equalizer) and fmDemWithSync, the
DeNBFMSync flow's graph.

The synchronizer is block-parallel: the symbol-rate timing tone of the
transition energy |x[n] − x[n−1]|² is summed over a few sub-windows of the
block, a weighted line τ(n) is fitted through their phases (unwrapped
against the carried estimate), and every output is interpolated at once
against a polyphase matched-filter bank.  Every op works along the last
axis with per-row timing, so inside ``PerChannel`` a (nch, n) panel syncs
each channel on its own line fit.  On a card a block runs on a kernel of
its own (``ops/cuda/symsync_block.py``, K9: the tone, then the fit and the
interpolation, two launches); on the CPU its plain version in eager ops
(the same module).  This module holds the design: the matched-filter bank
and the timing rotator both routes use.

Time-sharded (``shard_apply``), each rank sums the timing tone over the
global sub-windows it owns, the window sums are gathered over the time
ranks, every rank fits the same global line and interpolates its own
outputs against its segment between a left and a right halo.

``SymSyncScan`` (``mode="scan"``) is the closed-loop variant: a Gardner
timing detector and PI loop per output tick, the reference's liquid
symsync dynamics, for clock drift that varies within a block.  Its loop
runs on a kernel of its own (``ops/cuda/symsync_scan.py``, K8), one stream
per row, so inside ``PerChannel`` every channel runs its own loop; it does
not shard.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from .. import blocks as B
from ..core.block import Block, chain
from ..ops.cuda import symsync_block as k9
from ..utils import firdes

__all__ = ["SymSync", "SymSyncScan", "sym_sync_r", "sym_sync_c", "sym_tracker",
           "fm_dem_with_sync"]

_TWO_PI = 2.0 * np.pi
MODES = ("block", "scan")


@functools.lru_cache(maxsize=None)
def _interp_bank(k: int, m: int, npfb: int, ftype: str, beta: float) -> np.ndarray:
    """(npfb, 2·m·k+1) fractional-delay matched-filter bank: bank[p, l] =
    g(l − mk + p/npfb) where g is the matched filter at k samp/sym."""
    W = 2 * m * k + 1
    t = (np.arange(W * npfb, dtype=np.float64) - (W * npfb - 1) / 2.0) / npfb
    ts = t / k  # in symbol periods

    if ftype == "kaiser":
        g = np.sinc(ts) * np.kaiser(W * npfb, firdes.kaiser_beta(60.0))
    elif ftype in ("rrc", "rnyquist"):
        # continuous RRC on the oversampled grid ('rnyquist', liquid's
        # approximate root-Kaiser, targets the same family)
        b = max(beta, 1e-3)
        g = _rrc_continuous(ts, b)
        g = g / np.max(np.abs(g))
    else:
        raise ValueError(ftype)

    bank = np.zeros((npfb, W), dtype=np.float32)
    # g sampled at t = l − mk + p/npfb → oversampled index center + (l−mk)·npfb + p
    center = (W * npfb - 1) // 2
    for p in range(npfb):
        idx = center + (np.arange(W) - m * k) * npfb + p
        idx = np.clip(idx, 0, W * npfb - 1)
        bank[p] = g[idx]
    return bank


@functools.lru_cache(maxsize=32)
def _bank_on(k: int, m: int, npfb: int, ftype: str, beta: float,
             device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_interp_bank(k, m, npfb, ftype, beta), device=device)


@functools.lru_cache(maxsize=None)
def _timing_rotator(k: int, n: int) -> np.ndarray:
    return np.exp(-2j * np.pi * np.arange(n) / k).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _rotator_on(k: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_timing_rotator(k, n), device=device)


def _rrc_continuous(ts: np.ndarray, beta: float) -> np.ndarray:
    """Root-raised-cosine impulse response at arbitrary times (in symbols)."""
    out = np.empty_like(ts)
    near0 = np.abs(ts) < 1e-8
    sing = np.abs(np.abs(4.0 * beta * ts) - 1.0) < 1e-8
    safe = ~(near0 | sing)
    tt = ts[safe]
    num = np.sin(np.pi * tt * (1 - beta)) + 4 * beta * tt * np.cos(np.pi * tt * (1 + beta))
    den = np.pi * tt * (1 - (4 * beta * tt) ** 2)
    out[safe] = num / den
    out[near0] = 1.0 - beta + 4.0 * beta / np.pi
    out[sing] = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    return out


class SymSync(Block):
    """Block-parallel symbol synchronizer: k samples/symbol in,
    ``out_per_sym`` samples/symbol out.

    State ``(hist (…, H), tau (…), valid (…) bool)``: the input history, the
    carried timing estimate τ̂ in samples and whether it is set.  The output
    count per block is fixed, so under a clock-rate offset ε |τ| grows by ε
    per sample until it leaves the slack B = 5k; the carry then snaps back
    by whole symbols (one clean slip per k/ε samples, the physical drift)."""

    def __init__(self, k: int, m: int, beta: float, npfb: int, complex_input: bool,
                 ftype: str, out_per_sym: int = 2, name: str = "symsync"):
        if k < 2:
            raise ValueError(f"SymSync needs k >= 2 samples per symbol, got {k}")
        self.k, self.m, self.beta, self.npfb = k, m, beta, npfb
        self.complex_input = complex_input
        self.ftype = ftype
        self.out_per_sym = out_per_sym
        self.rate = Fraction(out_per_sym, k)
        self.granule = k
        # history: the filter span plus a slack of B + k samples each side
        self.B = 5 * k
        self.H = 2 * m * k + 2 * k + 2 * self.B
        self.constants = k9.BlockSync(k, m, out_per_sym, self.B, self.H)
        self.name = f"{name}(k={k})"

    def init(self, device: torch.device):
        dt = torch.complex64 if self.complex_input else torch.float32
        return (torch.zeros((self.H,), dtype=dt, device=device),
                torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.bool, device=device))

    def _bank(self, device: torch.device) -> torch.Tensor:
        return _bank_on(self.k, self.m, self.npfb, self.ftype, self.beta, device)

    def apply(self, state, x):
        """One block: K9 (``ops/cuda/symsync_block``) on a card, its plain
        version on the CPU."""
        rot = _rotator_on(self.k, x.shape[-1], x.device)
        return k9.symsync_block(x, self._bank(x.device), rot, state, self.constants)

    # ---- sharded: the global line fit on every rank ---------------------------
    def shard_apply(self, state, x, ctx):
        """The same global arithmetic as ``apply`` on a block of dt·nloc
        samples: each rank sums the timing tone over the global sub-windows
        it owns (they align with the ranks' segments, ``shard_validate``),
        the window sums are gathered over 'time', every rank fits the same
        line and interpolates its own outputs against [left halo H | x |
        right halo m·k + k + B]; the last rank's right halo repeats its
        final sample, as the serial gather clamps there."""
        rot = _rotator_on(self.k, x.shape[-1], x.device)
        return k9.symsync_block_shard(x, self._bank(x.device), rot, state, self.constants, ctx)

    def shard_validate(self, nloc, ctx):
        k = self.k
        n = nloc * ctx.dt
        if nloc % k:
            raise ValueError(f"{self.name}: local segment {nloc} not a multiple of k={k}")
        nw = k9.windows(n, k)
        if nw % ctx.dt:
            raise ValueError(f"{self.name}: {nw} timing sub-windows cannot align with {ctx.dt} "
                             f"time shards: grow block_size (needs >= {64 * k * ctx.dt} "
                             f"samples) or use dt dividing {nw}")
        wlen = n // nw
        if nloc % wlen:
            raise ValueError(f"{self.name}: sub-window length {wlen} does not divide the "
                             f"local segment {nloc}")
        halo = max(self.H, self.m * k + k + self.B)
        if nloc < halo:
            raise ValueError(f"{self.name}: local segment {nloc} shorter than halo {halo}")
        return (nloc // k) * self.out_per_sym


class SymSyncScan(Block):
    """Closed-loop symbol synchronizer: k samples/symbol in, ``out_per_sym``
    out, a Gardner timing detector and PI loop per output tick (the JAX
    package's ``SymSyncScan``).  Serial per output; the block-parallel
    ``SymSync`` is the default on wide paths.

    State ``(hist (…, H), tau (…), eta (…), prev_c (…), edge (…))``: the
    input history (H = W + 2k), the timing offset τ in samples, the loop
    integrator η, the previous centre sample and the pending edge sample
    (of the input's dtype).  τ is wrapped into [−k/2, k/2) at each block's
    end, so the outputs depend on the block size."""

    def __init__(self, k: int, m: int, beta: float, npfb: int, complex_input: bool,
                 ftype: str, lf_bw: float = 0.05, out_per_sym: int = 2,
                 name: str = "symsync_scan"):
        self.k, self.m, self.beta, self.npfb = k, m, beta, npfb
        self.complex_input = complex_input
        self.ftype = ftype
        self.out_per_sym = out_per_sym
        self.rate = Fraction(out_per_sym, k)
        self.granule = k
        self.W = 2 * m * k + 1
        self.H = self.W + 2 * k
        # PI gains from the loop bandwidth (reference lf_bw 0.05): the
        # Gardner error is in symbol units and τ in samples, so both gains
        # scale by k/2 (kp so the loop has the bandwidth lf_bw promises, ki
        # linearly: a squared scale drives it into jitter on sharp NRZ)
        self.kp = np.float32(2.0 * lf_bw * (k / 2.0))
        self.ki = np.float32(lf_bw * lf_bw * (k / 2.0))
        self.name = f"{name}(k={k})"

    def init(self, device: torch.device):
        dt = torch.complex64 if self.complex_input else torch.float32
        z = lambda *shape, d=torch.float32: torch.zeros(shape, dtype=d, device=device)  # noqa: E731
        return (z(self.H, d=dt), z(), z(), z(d=dt), z(d=dt))

    def loop(self, n: int):
        """The loop's constants (``ops/cuda/symsync_scan.ScanLoop``) for a
        block of n samples."""
        from ..ops.cuda.symsync_scan import ScanLoop

        k, m = self.k, self.m
        return ScanLoop(mk=m * k, start=self.H - (m * k + k), half=k / self.out_per_sym,
                        kp=float(self.kp), ki=float(self.ki), nout=(n // k) * self.out_per_sym)

    def apply(self, state, x):
        from ..ops.cuda.symsync_scan import symsync_scan

        hist, tau, eta, prev_c, edge = state
        k = self.k
        xfull = torch.cat([hist, x], dim=-1)
        bank = _bank_on(k, self.m, self.npfb, self.ftype, self.beta, x.device)
        (tau, eta, prev_c, edge), y = symsync_scan(xfull, bank, (tau, eta, prev_c, edge),
                                                   self.loop(x.shape[-1]))
        # keep τ bounded: whole-symbol wraps are absorbed by re-centering
        half = np.float32(k / 2.0)
        tau = torch.remainder(tau + half, np.float32(k)) - half
        return (xfull[..., -self.H:].clone(), tau, eta, prev_c, edge), y


def _sync_class(mode: str):
    if mode not in MODES:
        raise ValueError(f"symbol sync mode={mode!r}: use one of {MODES}")
    return SymSyncScan if mode == "scan" else SymSync


def sym_sync_r(k: int, m: int = 4, beta: float = 0.0, npfb: int = 64,
               mode: str = "block") -> Block:
    """Real symbol sync (reference symSyncR k m beta nf, kaiser matched
    filter); mode="scan" selects the closed-loop Gardner/PI ``SymSyncScan``."""
    return _sync_class(mode)(k, max(m, 1), beta, npfb, complex_input=False, ftype="kaiser",
                             name="symsync_r")


def sym_sync_c(m: int, k: int, beta: float = 0.5, npfb: int = 32,
               mode: str = "block") -> Block:
    """Complex symbol sync (reference symSyncC m k: rnyquist β = 0.5, 32
    filters); the argument order (m, k) is the reference's; mode="scan"
    selects ``SymSyncScan``."""
    return _sync_class(mode)(k, max(m, 1), beta, npfb, complex_input=True, ftype="rnyquist",
                             name="symsync_c")


def fm_dem_with_sync(k: int) -> Block:
    """NBFM + timing recovery (reference fmDemWithSync): fm_demodulator(0.02·k)
    then sym_sync_r(k, 4, 0, 64) → 2 samples/symbol float32."""
    return chain(B.fm_demodulator(0.02 * k), sym_sync_r(k, 4, 0.0, 64))


class _PowerNCarrierRecovery(Block):
    """Power-N carrier recovery: N = 2 removes BPSK modulation, 4 QPSK and
    square QAM, 8 8PSK; the 2π/N ambiguity is resolved against the carried
    phase (…)."""

    def __init__(self, npow: int = 2, ms: str = "bpsk"):
        from .modem import constellation

        self.npow = npow
        # the constellation's own power-N moment sets a reference angle
        # (QPSK: Σc⁴ = −1 ⇒ a π/4 bias without it)
        mom = np.mean(constellation(ms) ** npow)
        self.ref_angle = np.float32(np.angle(mom)) if abs(mom) > 1e-9 else np.float32(0.0)
        self.name = f"carrier_pow{npow}"

    def init(self, device: torch.device):
        return torch.zeros((), dtype=torch.float32, device=device)

    def apply(self, state, y):
        npow = self.npow
        yn = y
        for _ in range(int(np.log2(npow))):
            yn = yn * yn
        ph = (torch.angle(yn.sum(dim=-1)) - self.ref_angle) / np.float32(npow)
        amb = np.float32(_TWO_PI / npow)
        d = torch.remainder(ph - state + amb / 2, amb) - amb / 2
        phi = state + d
        return phi, y * torch.polar(torch.ones_like(phi), -phi)[..., None]


class _PowerNormalize(Block):
    """Normalize the symbol stream's power to 1, EMA-carried: the
    decision-directed equalizer needs QAM rings on the unit-energy grid.
    State (p (…), valid (…) bool)."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self.name = "pwr_norm"

    def init(self, device: torch.device):
        return (torch.ones((), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.bool, device=device))

    def apply(self, state, y):
        p_prev, valid = state
        p_blk = (y.abs() ** 2).mean(dim=-1) + np.float32(1e-12)
        p = torch.where(valid, (1 - self.alpha) * p_prev + self.alpha * p_blk, p_blk)
        return (p, torch.ones_like(valid)), y * torch.rsqrt(p)[..., None]


class _BlockLMSEqualizer(Block):
    """Decision-directed block-NLMS equalizer (symtrack's EQ stage).  The
    symbols are taken in sub-blocks of S; each is one normalized-LMS step
    w ← w + μ·conj(Yᴴ(d − Yw̄))/(S·T·E[|Y|²]) on the tensor's device, a
    Python loop with no host sync.  State (w (…, T) complex64, hist (…,
    T−1))."""

    def __init__(self, ntaps: int = 7, mu: float = 0.25, sub: int = 128, ms: str = "bpsk"):
        self.ntaps = ntaps
        self.mu = mu
        self.sub = sub
        self.ms = ms
        self.name = f"lms_eq({ntaps},{ms})"

    def init(self, device: torch.device):
        w = torch.zeros((self.ntaps,), dtype=torch.complex64, device=device)
        w[self.ntaps // 2] = 1.0
        return (w, torch.zeros((self.ntaps - 1,), dtype=torch.complex64, device=device))

    def apply(self, state, y):
        from .modem import hard_decision

        w, hist = state
        T = self.ntaps
        n = y.shape[-1]
        S = next(s for s in range(min(self.sub, n), 0, -1) if n % s == 0)
        yfull = torch.cat([hist, y], dim=-1)
        idx = torch.arange(n, device=y.device)[:, None] + torch.arange(T, device=y.device)
        Y = yfull[..., idx].reshape(*y.shape[:-1], n // S, S, T)
        mu = np.float32(self.mu)
        outs = []
        for i in range(n // S):
            Yb = Y[..., i, :, :]
            out = (Yb @ w.conj()[..., None])[..., 0]
            if self.ms == "bpsk":
                d = torch.sign(out.real).to(torch.complex64)
            else:
                d = hard_decision(out, self.ms)[1]
            e = d - out
            p = (Yb.abs() ** 2).mean(dim=(-2, -1)) + np.float32(1e-9)
            upd = (Yb.conj() * e[..., None]).mean(dim=-2) / (p * T)[..., None]
            w = w + mu * upd.conj()
            outs.append(out)
        return (w, yfull[..., -(T - 1):].clone()), torch.cat(outs, dim=-1)


_CARRIER_POW = {"bpsk": 2, "qpsk": 4, "8psk": 8, "qam16": 4, "qam64": 4}


def sym_tracker(m: int, k: int, beta: float = 0.25, ntaps: int = 7, ms: str = "bpsk") -> Block:
    """Symbol-tracking receiver (reference symTracker m k, symtrack_cccf):
    AGC → timing sync (RRC β = 0.25) → power normalization → carrier
    recovery → LMS equalizer, one complex sample per symbol out; append
    ``models/modem.soft_decision`` for LLRs."""
    if ms not in _CARRIER_POW:
        raise ValueError(f"unknown modulation {ms!r}; have {list(_CARRIER_POW)}")
    sync = SymSync(k, max(m, 1), beta, 32, complex_input=True, ftype="rrc",
                   out_per_sym=1, name="symtrack_sync")
    return chain(
        B.AGC(None, bandwidth=0.01, signal_level=1.0),
        sync,
        _PowerNormalize(),
        _PowerNCarrierRecovery(_CARRIER_POW[ms], ms),
        _BlockLMSEqualizer(ntaps, ms=ms),
    )
