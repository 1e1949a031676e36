"""The closed-loop symbol sync's per-output loop (K8) and its plain PyTorch
version.

No Pallas counterpart: it replaces the ``lax.scan`` of
``csdr_tpu/models/symsync.py:SymSyncScan.apply``, the Gardner timing
detector and PI loop of ``sym_sync_r`` / ``sym_sync_c(mode="scan")``.  For
each row of xfull (…, L) (the block behind its history) and each output j,
in float32:

    pos = (start + j·half) + τ;  ipos = floor(pos);  frac = pos − ipos
    ph = clip(round(frac·npfb), 0, npfb − 1)          (half to even)
    y[j] = Σ_t xfull[s + t]·bank[ph, t],  s = clamp(wrap(ipos − mk), 0, L − W)

(the window as ``lax.dynamic_slice`` takes it: a negative start wraps once
by L, then the start is clamped), then on centre ticks (j even)
e = −clip(Re(edge·conj(y − prev)), −1, 1), η += ki·e, τ = (τ + kp·e) + η,
prev = y, and on the others edge = y.  The carry (τ, η, prev, edge) has
the rows' shape (…); τ and η are float32, prev and edge of xfull's dtype
(float32 or complex64), the bank's taps real.

What bounds the kernel (``csrc/symsync_scan.cu``) is the dependent chain
from one τ to the next, not bytes.  It shortens the chain three ways: the
edge output 2i+1 and the centre output 2i+2, which share τ, are computed
in one pass and followed by one loop update (half the serial steps); the
windows are read from a ring of the row in shared memory that cp.async
keeps a chunk ahead (a window outside it is read from device memory in
the same order, so nothing depends on τ staying in range); the bank rows
sit in shared memory padded to whole lanes.  Each window is still summed
as lane l adding taps l, l + 32, … in order, then the xor tree (16, 8, 4,
2, 1), which ``_lane_sum`` reproduces, so kernel and twin agree bit for
bit, τ included.  On a CUDA tensor ``symsync_scan`` launches that kernel or
raises; only a tensor on the CPU takes the plain version
``symsync_scan_ref``, a Python loop over outputs.  ``launches`` counts the
calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ScanLoop", "picks", "symsync_scan", "symsync_scan_ref", "launches"]

_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use
_RING = 4096           # the kernel's window ring, in samples (kRing)
_MAX_TAPS = 1024       # the kernel's longest window (kMaxTaps)
_MAX_ROW = 1 << 30     # rows are indexed with int32

launches = 0


@dataclass(frozen=True)
class ScanLoop:
    """The loop's constants: mk = m·k (the window's centre tap), the first
    output's position ``start`` in xfull, ``half`` = k / out_per_sym input
    samples per output, the PI gains, and the number of outputs."""
    mk: int
    start: int
    half: float
    kp: float
    ki: float
    nout: int


def _check(xfull: torch.Tensor, bank: torch.Tensor, carry, loop: ScanLoop):
    if xfull.dtype not in (torch.float32, torch.complex64) or xfull.ndim < 1:
        raise ValueError(f"symsync_scan: xfull must be float32 or complex64 rows, got "
                         f"{xfull.dtype} {tuple(xfull.shape)}")
    if bank.dtype != torch.float32 or bank.ndim != 2 or bank.shape[1] != 2 * loop.mk + 1:
        raise ValueError(f"symsync_scan: bank must be float32 (npfb, {2 * loop.mk + 1}), got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    if xfull.shape[-1] < bank.shape[1]:
        raise ValueError(f"symsync_scan: rows of {xfull.shape[-1]} samples are shorter than "
                         f"the {bank.shape[1]}-tap window")
    lead = tuple(xfull.shape[:-1])
    for name, c, dt in zip(("tau", "eta", "prev", "edge"), carry,
                           (torch.float32, torch.float32, xfull.dtype, xfull.dtype)):
        if c.dtype != dt or tuple(c.shape) != lead:
            raise ValueError(f"symsync_scan: {name} must be {dt} of shape {lead}, got "
                             f"{c.dtype} {tuple(c.shape)}")


def picks(tau: torch.Tensor, j, loop: ScanLoop, npfb: int):
    """(floor of the position, bank row) of output j (an int, or a float32
    tensor of outputs) at timing τ, in the kernel's float32 order: pos =
    (start + j·half) + τ."""
    jf = j if isinstance(j, torch.Tensor) else np.float32(j)
    pos = (np.float32(loop.start) + jf * np.float32(loop.half)) + tau
    fl = torch.floor(pos)
    ph = torch.round((pos - fl) * np.float32(npfb)).to(torch.int64).clamp(0, npfb - 1)
    return fl.to(torch.int64), ph


def _lane_sum(prod: torch.Tensor) -> torch.Tensor:
    """The kernel's sum of W products (…, W): lane l adds products l, l + 32,
    … in order, then the __shfl_xor_sync tree (16, 8, 4, 2, 1), which leaves
    in every lane the halving sum of lane pairs (l, l + 16), (l, l + 8), …;
    zero products pad W to whole lanes (x + 0 is x)."""
    W = prod.shape[-1]
    chunks = -(-W // 32)
    p = torch.nn.functional.pad(prod, (0, 32 * chunks - W)).reshape(*prod.shape[:-1], chunks, 32)
    acc = p[..., 0, :]
    for c in range(1, chunks):
        acc = acc + p[..., c, :]
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    return acc[..., 0]


def symsync_scan_ref(xfull: torch.Tensor, bank: torch.Tensor, carry, loop: ScanLoop,
                     trace: bool = False):
    """Plain K8: (carry, y (…, nout)) by a Python loop in the kernel's steps,
    every row at once: output 0 (a centre tick) alone, then each edge
    output and the centre after it at one τ, both windows in one gather,
    then one loop update; each window summed in the kernel's order
    (``_lane_sum``), so the twin and the kernel pick alike.  With ``trace`` it
    also returns the τ each output was interpolated at, (…, nout) float32,
    from which ``picks`` gives its window and bank row."""
    _check(xfull, bank, carry, loop)
    tau, eta, prev, edge = carry
    npfb, W = bank.shape
    L = xfull.shape[-1]
    kp, ki = np.float32(loop.kp), np.float32(loop.ki)
    taps = torch.arange(W, device=xfull.device)
    y = torch.empty((*xfull.shape[:-1], loop.nout), dtype=xfull.dtype, device=xfull.device)
    taus = torch.empty(y.shape, dtype=torch.float32, device=xfull.device) if trace else None
    # the kernel's steps: [0], [1, 2], [3, 4], …, and a last edge alone
    steps = [range(0, min(1, loop.nout))] + [range(j, min(j + 2, loop.nout))
                                             for j in range(1, loop.nout, 2)]
    for js in steps:
        if trace:
            taus[..., js.start:js.stop] = tau[..., None]
        jf = torch.arange(js.start, js.stop, dtype=torch.float32, device=xfull.device)
        ipos, ph = picks(tau[..., None], jf, loop, npfb)
        # lax.dynamic_slice's start: a negative one wraps once by L, then
        # the start is clamped into [0, L − W]
        s = ipos - loop.mk
        s = torch.where(s < 0, s + L, s).clamp(0, L - W)
        rows = xfull.unsqueeze(-2).expand(*xfull.shape[:-1], len(js), L)
        outs = _lane_sum(torch.gather(rows, -1, s[..., None] + taps) * bank[ph])
        y[..., js.start:js.stop] = outs
        for i, j in enumerate(js):
            out = outs[..., i]
            if j % 2 == 0:
                d = out - prev
                e = (edge.real * d.real + edge.imag * d.imag) if out.is_complex() else edge * d
                e = -e.clamp(-1.0, 1.0)
                eta = eta + ki * e
                tau = (tau + kp * e) + eta
                prev = out
            else:
                edge = out
    carry = (tau, eta, prev, edge)
    return (carry, y, taus) if trace else (carry, y)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import load_library

    fn = load_library().csdr_symsync_scan
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [I, P, LL, I, P, I, I, I, LL, F, F, F, F, P, P, P, P, P, P, P, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def symsync_scan(xfull: torch.Tensor, bank: torch.Tensor, carry, loop: ScanLoop):
    """K8: xfull (…, L) float32 or complex64, bank (npfb, W) float32 on the
    same device, carry (τ, η, prev, edge) of shape (…) → (carry, y (…, nout)
    of xfull's dtype)."""
    global launches
    _check(xfull, bank, carry, loop)
    if xfull.device.type == "cpu":
        return symsync_scan_ref(xfull, bank, carry, loop)
    if xfull.device.type != "cuda" or bank.device != xfull.device:
        raise ValueError(f"symsync_scan runs on cuda or cpu tensors, got {xfull.device} "
                         f"with a bank on {bank.device}")
    npfb, W = bank.shape
    wp = 32 * -(-W // 32)   # bank rows padded to whole lanes
    smem = (_RING + wp) * xfull.element_size() + 4 * npfb * wp
    if smem > _SMEM_LIMIT:
        raise ValueError(f"symsync_scan: a {npfb} x {W} bank and the window ring take {smem} B "
                         f"of shared memory (limit {_SMEM_LIMIT})")
    if W > _MAX_TAPS or xfull.shape[-1] >= _MAX_ROW:
        raise ValueError(f"symsync_scan: the kernel takes windows of at most {_MAX_TAPS} taps "
                         f"and rows shorter than {_MAX_ROW} samples, got {W} and "
                         f"{xfull.shape[-1]}")
    rows = int(np.prod(xfull.shape[:-1], dtype=np.int64))
    if rows > 2 ** 31 - 1:
        raise ValueError(f"symsync_scan: {rows} rows is more than the grid takes")
    xfull, bank = xfull.contiguous(), bank.contiguous()
    carry = tuple(c.contiguous() for c in carry)
    y = torch.empty((*xfull.shape[:-1], loop.nout), dtype=xfull.dtype, device=xfull.device)
    out = tuple(torch.empty_like(c) for c in carry)
    if rows == 0 or loop.nout == 0:
        return tuple(c.clone() for c in carry), y
    fn = _kernel_fn()
    with torch.cuda.device(xfull.device):
        stream = torch.cuda.current_stream(xfull.device).cuda_stream
        err = fn(int(xfull.is_complex()), xfull.data_ptr(), xfull.shape[-1], rows,
                 bank.data_ptr(), npfb, W, loop.mk, loop.nout, float(np.float32(loop.start)),
                 float(np.float32(loop.half)), float(np.float32(loop.kp)),
                 float(np.float32(loop.ki)), *(c.data_ptr() for c in carry), y.data_ptr(),
                 *(c.data_ptr() for c in out), stream)
    if err != 0:
        raise RuntimeError(f"symsync_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return out, y
