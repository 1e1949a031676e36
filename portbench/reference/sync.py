"""Plain block-parallel symbol synchronizer: one block of the DeNBFMSync
flow's ``symSyncR k 4 0 64`` in the port's block mode.

A frozen, plain transcription of ``csdr_tpu_torch/models/symsync.py``
``SymSync`` (``apply``, ``_fit_line``, ``_positions``, ``_bank_sum``) for
real input and two outputs per symbol, in the precision of its input
(float64 for the reference).  It keeps the sync's rule that bank row p
interpolates at ipos − p/npfb (ROADMAP Queue C).  Where float order picks
between two outputs (a bank phase at a rounding tie, a window position at
an integer), it also returns the output of the other pick, so that a
program in another float order may match either.  It imports nothing of
the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp import TWO_PI, sync_bank


def _bank_sum(xfull, ipos, ph, bank, mk: int):
    L = xfull.shape[-1]
    offs = torch.arange(bank.shape[1], device=xfull.device) - mk
    idx = ipos[..., None] + offs
    # out-of-range reads as the port reads them: a negative index wraps once,
    # the rest clamps to the ends
    idx = torch.where(idx < 0, idx + L, idx).clamp(0, L - 1)
    win = torch.gather(xfull, -1, idx.reshape(xfull.shape[0], -1)).reshape(idx.shape)
    return (win * bank[ph]).sum(dim=-1)


def sync_block(x: torch.Tensor, hist: torch.Tensor, tau_prev: torch.Tensor,
               valid: torch.Tensor, k: int, m: int, npfb: int, width: float) -> dict:
    """One block of rows x (C, n) behind their history (C, H), with the
    carried timing estimate ``tau_prev`` (C,) and its flag ``valid`` (C,).

    Returns {"y": (C, nout) outputs, "other": the other pick's outputs,
    "code": 0 (none), 1 (a phase-rounding tie) or 2 (a window crossing)
    per output, "tau": the carried estimate after the block, "slip_tie":
    rows whose carry lies within ``width`` samples of a whole-symbol slip
    boundary}."""
    dt = x.dtype
    C, n = x.shape
    B = 5 * k
    H = 2 * m * k + 2 * k + 2 * B
    nout = (n // k) * 2
    xfull = torch.cat([hist, x], dim=-1)

    s = (x[:, 1:] - x[:, :-1]) ** 2
    s = torch.cat([s[:, :1], s], dim=-1)
    i = torch.arange(n, device=x.device, dtype=torch.float64)
    rot = torch.polar(torch.ones_like(i), -TWO_PI * i / k).to(
        torch.complex128 if dt == torch.float64 else torch.complex64)
    z = s * rot
    nw = max(1, min(8, n // (64 * k)))
    wlen = n // nw
    Tw = z[:, :nw * wlen].reshape(C, nw, wlen).sum(dim=-1)

    # the weighted timing line, unwrapped against the carried estimate
    half = k / 2.0
    tau_w = -torch.angle(Tw) * (k / TWO_PI)
    t0 = torch.remainder(tau_w[:, 0], k)
    d0 = torch.remainder(t0 - tau_prev + half, k) - half
    t0 = torch.where(valid, tau_prev + d0, t0)
    steps = torch.remainder(tau_w[:, 1:] - tau_w[:, :-1] + half, k) - half
    tau_seq = t0[:, None] + torch.cat([torch.zeros_like(tau_w[:, :1]),
                                       torch.cumsum(steps, dim=-1)], dim=-1)
    centers = ((torch.arange(nw, device=x.device, dtype=torch.float64) + 0.5)
               * (n // nw)).to(dt)
    wgt = Tw.abs() + 1e-12
    wsum = wgt.sum(dim=-1)
    cm = (wgt * centers).sum(dim=-1) / wsum
    tm = (wgt * tau_seq).sum(dim=-1) / wsum
    dc = centers - cm[:, None]
    var = (wgt * dc ** 2).sum(dim=-1) + 1e-6
    slope = ((wgt * dc * (tau_seq - tm[:, None])).sum(dim=-1) / var if nw > 1
             else torch.zeros_like(tm)).clamp(-0.2, 0.2)
    raw = tm + slope * (n - cm)
    over = torch.clamp(raw.abs() - B, min=0.0)
    tau = raw - torch.ceil(over / k) * k * torch.sign(raw)
    u = (raw.abs() - B) / k
    slip_tie = ((u - torch.round(u)).abs() * k < width) & (torch.round(u) >= 0)

    # positions: centres k/2 after the line, outputs every half symbol
    start = H - (m * k + k + B)
    num = torch.arange(nout, device=x.device, dtype=torch.int64) * k
    base_int = start + torch.div(num, 2, rounding_mode="floor")
    base_frac = (num % 2).to(dt) / 2.0
    delta = (tm[:, None] + slope[:, None] * ((base_int.to(dt) - cm[:, None]) + base_frac)
             + half + base_frac)
    dlo = torch.floor(delta)
    ipos = base_int + dlo.to(torch.int64)
    f = (delta - dlo) * npfb
    ph = torch.round(f).to(torch.int64).clamp(0, npfb - 1)

    bank = torch.from_numpy(sync_bank(k, m, npfb)).to(x.device).to(dt)
    y = _bank_sum(xfull, ipos, ph, bank, m * k)

    # the other pick, where float order picks
    lo, hi = f < width, f > npfb - width
    tie = ((f - torch.floor(f) - 0.5).abs() < width) & ~lo & ~hi
    ph_tie = torch.where(ph == torch.floor(f).to(torch.int64), ph + 1, ph - 1)
    ipos_alt = ipos - lo.to(torch.int64) + hi.to(torch.int64)
    ph_alt = torch.where(lo, npfb - 1, torch.where(hi, 0, torch.where(
        tie, ph_tie.clamp(0, npfb - 1), ph)))
    code = torch.where(lo | hi, 2, tie.to(torch.int64))
    other = _bank_sum(xfull, ipos_alt, ph_alt, bank, m * k)
    return dict(y=y, other=other, code=code, tau=tau, slip_tie=slip_tie,
                hist=xfull[:, -H:])


def sync_history(k: int, m: int) -> int:
    """H, the samples of history the sync carries."""
    return 2 * m * k + 2 * k + 10 * k


def either_pick_error(got: np.ndarray, res: dict) -> float:
    """The largest gap of ``got`` (C, nout) from the reference's output or,
    where float order picks, from its other pick, relative to each row's
    largest reference output."""
    want = res["y"].double().cpu().numpy()
    other = res["other"].double().cpu().numpy()
    scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-12
    g = got.astype(np.float64)
    err = np.minimum(np.abs(g - want), np.abs(g - other)) / scale
    return float(err.max())


def tau_error(got: np.ndarray, res: dict, k: int) -> float:
    """The largest gap, in samples, of the program's carried estimate from
    the reference's; a row whose carry sits at a slip boundary may differ
    by one whole symbol."""
    want = res["tau"].double().cpu().numpy()
    d = np.abs(got.astype(np.float64) - want)
    tie = res["slip_tie"].cpu().numpy()
    d = np.where(tie, np.minimum(d, np.abs(d - k)), d)
    return float(d.max())
