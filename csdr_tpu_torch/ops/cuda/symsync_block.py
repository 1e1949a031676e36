"""The block-parallel symbol sync (K9) and its plain PyTorch version.

No Pallas counterpart: it replaces the ``jnp`` gathers of
``csdr_tpu/models/symsync.py:SymSync.apply``, which the port first wrote as
eager PyTorch ops (``tone``, ``fit_line``, ``positions`` and the chunked
``bank_sum`` below): ~270 launches and several GB of gathered panels a
block at the DeNBFMSync flow's shape (64 rows of 262,080 samples, k 10, W
81 taps, npfb 64), for work that moves ~81 MB
(``portbench/bounds.sync_scan_bound``, ~24 µs at 3.35 TB/s).  Bytes bound
it; the kernel (``csrc/symsync_block.cu``) reads each input sample twice
and writes nothing larger than the window sums between its two launches:

1. ``sync_tone``: the timing tone Σ |x[i] − x[i−1]|²·rot[i] of each row's
   nw timing windows, as fixed partial sums (…, nw, parts) complex128 (a
   fixed tree, no atomics: two runs are bit-identical; ``parts`` depends
   on the window length alone, so a time-sharded step's partials are the
   serial step's, window by window).  rot is the caller's rotator
   e^{−2πi·i/k}, the tensor the plain version multiplies by;
2. ``sync_interp``: every block sums its row's partials, fits the line as
   ``fit_line`` does (float32, its order), takes each output's position as
   ``positions`` does (no FMA contraction, round half to even), stages the
   span of samples its windows cover in shared memory from the row's
   segments ([hist | x], or [left halo | x | right halo] sharded: no
   concatenation on the card) and sums W taps against the bank held in
   shared memory.  Tile 0 of a row writes the carried τ and, serially, the
   new history.

The caller (``models/symsync.SymSync``) hands in tensors and constants:
the block x, the (npfb, W) bank, the rotator, the state (hist, τ, valid)
and a ``BlockSync``.  ``symsync_block`` (``SymSync.apply``) and
``symsync_block_shard`` (``SymSync.shard_apply``) route by the input's
device: a CPU tensor takes the plain version (``symsync_block_ref``,
``symsync_block_shard_ref``), a CUDA tensor the two launches, or they
raise; no fallback.  Both check the input first, on either device.
``launches`` counts the kernel launches.  Both routes take the energies
in float32, multiply them by the same rotator and sum in float64, then
round each window's sum to complex64:
where the tone sits on the real axis (a signal on an integer timing grid)
the sign of its imaginary part picks τ ≈ 0 or ≈ k at the first window's
unwrap, and a float32 sum would leave that sign to its order.  Kernel and
plain version pick the same window and bank phase wherever their lines
agree; their lines differ by the rounding of those sums.
A window position more than 2^24 samples from its grid point (a carried τ
no block carries) is held at 2^24 on the card, which reads the same
samples as the plain version on rows shorter than that.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ._build import source_ints

__all__ = ["BlockSync", "windows", "tone", "fit_line", "positions", "bank_sum",
           "symsync_block", "symsync_block_ref", "symsync_block_shard",
           "symsync_block_shard_ref", "launches", "MAX_TAPS"]

_TWO_PI = 2.0 * np.pi
_CHUNK = 1 << 24         # elements of one gathered (…, nout, taps) window panel
# the kernel's longest window (W = 2mk + 1), tone parts per window, outputs
# per thread of sync_interp
MAX_TAPS, _MAX_PARTS, _PER = source_ints("symsync_block.cu", "kMaxTaps", "kMaxParts", "kPer")
_MAX_ROWS = 65535        # rows are a grid dimension
_MAX_ROW = 1 << 30       # samples of a row, indexed with int32
_SMEM_LIMIT = 232448     # bytes of shared memory a Hopper block may use
_SMEM_BUDGET = 102400    # a block's shared memory while tiles > 32 threads (two per SM)
_TONE_SEG = 4096         # least samples of one tone part (16 a thread)
_TILES = (256, 128, 64, 32)

launches = 0


@dataclass(frozen=True)
class BlockSync:
    """The block sync's constants: k input samples a symbol, m symbols of
    window each side of the centre (W = 2·m·k + 1 taps), ``out_per_sym``
    outputs a symbol, the carry's slack B and the history's length H."""
    k: int
    m: int
    out_per_sym: int
    B: int
    H: int

    @property
    def start(self) -> int:
        """The first output's grid point in [hist | x]: a constant delay
        centred in the slack, so τ may roam ±(B + k) samples before the
        window leaves the data."""
        return self.H - (self.m * self.k + self.k + self.B)


def windows(n: int, k: int) -> int:
    """The timing windows of an n-sample block (each ≥ 64 symbols, ≤ 8)."""
    return max(1, min(8, n // (64 * k)))


@functools.lru_cache(maxsize=32)
def _centers_on(n: int, nw: int, device: torch.device) -> torch.Tensor:
    """float32 centers of the nw timing sub-windows of an n-sample block
    (cached on the device: a pageable upload would wait for the stream)."""
    return torch.as_tensor(((np.arange(nw) + 0.5) * (n // nw)).astype(np.float32),
                           device=device)


def _check(x: torch.Tensor, bank: torch.Tensor, rot: torch.Tensor, state) -> None:
    """Raise on what neither route takes: x of another dtype than float32
    or complex64 or than the history's, rows that do not match, a bank
    that is not float32 (npfb, W ≤ MAX_TAPS), a rotator that is not x's
    length of complex64, fewer than 2 samples, or rows [hist | x] shorter
    than the window."""
    hist = state[0]
    W = bank.shape[-1]
    if x.dtype not in (torch.float32, torch.complex64) or hist.dtype != x.dtype:
        raise ValueError(f"symsync_block: x must be float32 or complex64 with a history of "
                         f"its dtype, got {x.dtype} and {hist.dtype}")
    if tuple(hist.shape[:-1]) != tuple(x.shape[:-1]) or x.ndim < 1:
        raise ValueError(f"symsync_block: history {tuple(hist.shape)} and x {tuple(x.shape)} "
                         f"must have the same rows")
    if bank.dtype != torch.float32 or bank.ndim != 2:
        raise ValueError(f"symsync_block: the bank must be float32 (npfb, W), got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    if W > MAX_TAPS:
        raise ValueError(f"symsync_block: the kernel takes windows of at most {MAX_TAPS} taps, "
                         f"got {W}")
    if rot.dtype != torch.complex64 or tuple(rot.shape) != (x.shape[-1],):
        raise ValueError(f"symsync_block: the rotator must be complex64 ({x.shape[-1]},), got "
                         f"{rot.dtype} {tuple(rot.shape)}")
    if x.shape[-1] < 2:
        raise ValueError(f"symsync_block: x holds {x.shape[-1]} samples, needs at least 2")
    L = hist.shape[-1] + x.shape[-1]
    if L < W:
        raise ValueError(f"symsync_block: rows of {L} samples are shorter than the "
                         f"{W}-tap window")


def _tone_split(wlen: int) -> tuple[int, int]:
    """(parts, samples a part) of a timing window of ``wlen`` samples: at
    least _TONE_SEG samples a part, at most _MAX_PARTS parts, a whole number
    of 256-thread sweeps; a function of the window length alone."""
    seg = max(_TONE_SEG, 256 * -(-wlen // (256 * _MAX_PARTS)))
    return -(-wlen // seg), seg


# ---- the plain version ---------------------------------------------------------
def _energy(d: torch.Tensor) -> torch.Tensor:
    """|d|², float32, in the kernel's order (re² + im² for complex)."""
    return d.real * d.real + d.imag * d.imag if d.is_complex() else d * d


def tone(x: torch.Tensor, prev, rot: torch.Tensor, nw: int, wlen: int) -> torch.Tensor:
    """The transition-energy timing tone summed over nw windows of wlen
    samples from x's start, (…, nw) complex64; it peaks at symbol
    boundaries, the centers sit k/2 later.  The first term repeats the
    second's, or, with ``prev`` (…, 1), differences against it.  ``rot``
    (x's length) rotates by e^{−2πi·i/k}; a rank's starts at a multiple of
    2π (k | nloc)."""
    s = _energy(x[..., 1:] - x[..., :-1])
    s0 = s[..., :1] if prev is None else _energy(x[..., :1] - prev)
    s = torch.cat([s0, s], dim=-1)  # keep x's length for the rotator
    # float64 products (exact) and sums, each window rounded to complex64
    z = s.to(torch.complex128) * rot.to(torch.complex128)
    Tw = z[..., : nw * wlen].reshape(*x.shape[:-1], nw, wlen).sum(dim=-1)
    return Tw.to(torch.complex64)


def fit_line(Tw: torch.Tensor, n: int, tau_prev, tau_valid, k: int, B: int):
    """Weighted least-squares τ(n) line through the per-window timing
    estimates, one per row, and the bounded end-of-block carry:
    (tm, slope, cm, τ carried)."""
    kf, half = np.float32(k), np.float32(k / 2.0)
    nw = Tw.shape[-1]
    tau_w = -torch.angle(Tw) * np.float32(k / _TWO_PI)                      # mod k
    # unwrap: the first window against the carried estimate, then window to
    # window
    t0 = torch.remainder(tau_w[..., 0], kf)
    d0 = torch.remainder(t0 - tau_prev + half, kf) - half
    t0 = torch.where(tau_valid, tau_prev + d0, t0)
    steps = torch.remainder(tau_w[..., 1:] - tau_w[..., :-1] + half, kf) - half
    tau_seq = t0[..., None] + torch.cat([torch.zeros_like(tau_w[..., :1]),
                                         torch.cumsum(steps, dim=-1)], dim=-1)
    centers = _centers_on(n, nw, Tw.device)
    wgt = Tw.abs() + np.float32(1e-12)
    wsum = wgt.sum(dim=-1)
    cm = (wgt * centers).sum(dim=-1) / wsum
    tm = (wgt * tau_seq).sum(dim=-1) / wsum
    dc = centers - cm[..., None]
    var = (wgt * dc ** 2).sum(dim=-1) + np.float32(1e-6)
    if nw > 1:
        slope = (wgt * dc * (tau_seq - tm[..., None])).sum(dim=-1) / var
    else:
        slope = torch.zeros_like(tm)
    slope = slope.clamp(-0.2, 0.2)  # sanity: ≤ 0.2 samples of drift per sample

    tau_carry = tm + slope * (np.float32(n) - cm)  # τ at the block end
    # bounded carry with hysteresis: only once |τ| leaves the slack does it
    # snap back by whole symbols (a re-centering every block would slip a
    # symbol at every boundary)
    over = torch.clamp(tau_carry.abs() - np.float32(B), min=0.0)
    slip_syms = torch.ceil(over / kf)
    tau_carry = tau_carry - slip_syms * kf * torch.sign(tau_carry)
    return tm, slope, cm, tau_carry


def positions(sync: BlockSync, npfb: int, nout: int, tm, slope, cm, j0: int = 0):
    """Window centers in [hist | x] and bank phases of the outputs j = j0 ..
    j0 + nout − 1, int64 (…, nout), and frac·npfb, float32.

    A position is an exact integer grid point plus a small float32
    residual (one float32 position loses the polyphase fraction past ~2^22
    samples); the residual's float32 ops run in the JAX package's order,
    and ``torch.round`` rounds half to even, as ``jnp.round``."""
    k, ops = sync.k, sync.out_per_sym
    num = torch.arange(j0, j0 + nout, device=tm.device) * k
    base_int = sync.start + torch.div(num, ops, rounding_mode="floor")
    base_frac = (num % ops).to(torch.float32) / np.float32(ops)
    # τ(n) = tm + slope·(n − cm) marks boundaries; centers are k/2 later
    bdiff = (base_int.to(torch.float32) - cm[..., None]) + base_frac
    delta = tm[..., None] + slope[..., None] * bdiff + np.float32(k / 2.0) + base_frac
    dlo = torch.floor(delta)
    ipos = base_int + dlo.to(torch.int64)
    f = (delta - dlo) * npfb
    ph = torch.round(f).to(torch.int64).clamp(0, npfb - 1)
    return ipos, ph, f


def bank_sum(xfull: torch.Tensor, ipos, ph, bank: torch.Tensor, mk: int) -> torch.Tensor:
    """Per output, the (2mk+1)-sample window of xfull around ipos times bank
    row ph, gathered and summed in chunks of taps so that a panel stays
    under _CHUNK elements.  Bank row p holds g(l − mk + p/npfb), so the
    output sits at ipos − p/npfb, not at the fitted ipos + frac: the JAX
    package's convention, kept (ROADMAP Queue C).  Out-of-range window
    samples read as ``jnp`` indexing reads them (a negative index wraps
    once, the rest clamps to the ends)."""
    W = bank.shape[1]
    lead, L = xfull.shape[:-1], xfull.shape[-1]
    c = max(1, min(W, _CHUNK // max(1, ipos.numel())))
    y = None
    for l0 in range(0, W, c):
        offs = torch.arange(l0 - mk, min(l0 + c, W) - mk, device=xfull.device)
        idx = ipos[..., None] + offs                                       # (…, nout, c)
        idx = torch.where(idx < 0, idx + L, idx).clamp_(0, L - 1)
        win = torch.gather(xfull, -1, idx.reshape(*lead, -1)).reshape(idx.shape)
        part = (win * bank[:, l0:l0 + c][ph]).sum(dim=-1)
        y = part if y is None else y + part
    return y


def symsync_block_ref(x: torch.Tensor, bank: torch.Tensor, rot: torch.Tensor, state,
                      sync: BlockSync, line: list | None = None):
    """Plain K9, one block: ((hist, tau, valid), y (…, (n // k)·out_per_sym))."""
    hist, tau_prev, tau_valid = state
    k = sync.k
    n = x.shape[-1]
    nout = (n // k) * sync.out_per_sym
    xfull = torch.cat([hist, x], dim=-1)
    nw = windows(n, k)
    Tw = tone(x, None, rot, nw, n // nw)                                    # (…, nw)
    tm, slope, cm, tau_carry = fit_line(Tw, n, tau_prev, tau_valid, k, sync.B)
    if line is not None:
        line.append((tm, slope, cm))
    ipos, ph, _ = positions(sync, bank.shape[0], nout, tm, slope, cm)
    lead = xfull.shape[:-1]
    y = bank_sum(xfull, ipos.expand(*lead, nout), ph.expand(*lead, nout), bank, sync.m * k)
    return (xfull[..., -sync.H:].clone(), tau_carry, torch.ones_like(tau_valid)), y


def symsync_block_shard_ref(x: torch.Tensor, bank: torch.Tensor, rot: torch.Tensor, state,
                            sync: BlockSync, ctx):
    """Plain K9 of a time rank (``SymSync.shard_apply``): the window sums of
    this rank's windows are gathered over 'time', every rank fits the same
    line and interpolates its own outputs against [left halo H | x | right
    halo m·k + k + B]."""
    hist, tau_prev, tau_valid = state
    k = sync.k
    nloc = x.shape[-1]
    n = nloc * ctx.dt
    nout_loc = (nloc // k) * sync.out_per_sym
    # rank 0 repeats the block head's term, as serial does; the others
    # take the true difference across the segment boundary
    prev1 = ctx.left_halo(x, x[..., :1], 1)
    nw = windows(n, k)
    Tw_loc = tone(x, None if ctx.ti == 0 else prev1, rot, nw // ctx.dt, n // nw)
    Tw = torch.movedim(ctx.all_gather_time(Tw_loc), 0, -2).reshape(*x.shape[:-1], nw)
    tm, slope, cm, tau_carry = fit_line(Tw, n, tau_prev, tau_valid, k, sync.B)

    ext = torch.cat([ctx.left_halo(x, hist, sync.H), x,
                     ctx.right_halo(x, sync.m * k + k + sync.B)], dim=-1)
    ipos, ph, _ = positions(sync, bank.shape[0], nout_loc, tm, slope, cm, j0=ctx.ti * nout_loc)
    lead = x.shape[:-1]
    y = bank_sum(ext, (ipos - ctx.ti * nloc).expand(*lead, nout_loc),
                 ph.expand(*lead, nout_loc), bank, sync.m * k)
    new_hist = ctx.from_last_time(x[..., -sync.H:].contiguous())
    return (new_hist, tau_carry, torch.ones_like(tau_valid)), y


# ---- the kernel ----------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from ._build import load_library

    lib = load_library()
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    tone_fn = lib.csdr_sync_tone
    tone_fn.argtypes = [I, P, LL, I, P, P, LL, I, I, LL, P, P]
    tone_fn.restype = ctypes.c_int
    interp = lib.csdr_sync_interp
    interp.argtypes = [I, P, LL, P, LL, P, LL, I, P, I, I, P, I, P, I, P, I, I, I, I, I, LL, F,
                       F, LL, LL, LL, LL, I, I, P, P, P, P, LL, P]
    interp.restype = ctypes.c_int
    return tone_fn, interp


def _plan(sync: BlockSync, npfb: int, W: int, elem: int) -> tuple[int, int]:
    """(threads a block, staged samples) of ``sync_interp``: the widest tile
    whose bank and staged span fit the shared-memory budget.  A tile of
    t·_PER outputs covers at most (t·_PER − 1)·(k/ops)·1.2 + 1 samples of
    window positions (|slope| ≤ 0.2); the cap takes 1.25 and 64 samples
    more for the float32 rounding of the positions (the kernel holds them
    within 2^24 of their grid points), plus the window."""
    bank = 4 * (-(-npfb * W // 4) * 4)
    step = sync.k / sync.out_per_sym
    for tile in _TILES:
        cap = math.ceil((tile * _PER - 1) * step * 1.25) + W + 64
        smem = bank + cap * elem
        if smem <= (_SMEM_BUDGET if tile > 32 else _SMEM_LIMIT - 1024):
            return tile, cap
    raise ValueError(f"symsync_block: a {npfb} x {W} bank and the staged window take "
                     f"{smem} B of shared memory (limit {_SMEM_LIMIT - 1024})")


def _launch_checks(x: torch.Tensor, L: int, tensors):
    """Raise on what only the kernel refuses: another device than a card,
    operands on another device, more rows than the grid takes, rows of
    2^30 samples or more."""
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"symsync_block runs on cuda or cpu tensors with the bank, rotator "
                         f"and state on their device, got {x.device} and "
                         f"{[str(t.device) for t in tensors]}")
    if rows > _MAX_ROWS or L >= _MAX_ROW:
        raise ValueError(f"symsync_block: the kernel takes at most {_MAX_ROWS} rows shorter "
                         f"than {_MAX_ROW} samples, got {rows} of {L}")


def _rows_of(t: torch.Tensor, lead: tuple, rows: int) -> tuple[torch.Tensor, int]:
    """A per-row state leaf as (contiguous tensor, stride 0 or 1)."""
    if t.numel() == 1:
        return t.reshape(1).contiguous(), 0
    return t.expand(lead).reshape(rows).contiguous(), 1


def _tone(x: torch.Tensor, prev, rot: torch.Tensor, nw: int, wlen: int) -> torch.Tensor:
    """Launch 1: the (…, nw, parts) partial sums of x's timing windows."""
    global launches
    tone_fn, _ = _kernel_fns()
    lead = tuple(x.shape[:-1])
    rows = int(np.prod(lead, dtype=np.int64))
    parts, seg = _tone_split(wlen)
    out = torch.empty((*lead, nw, parts), dtype=torch.complex128, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = tone_fn(int(x.is_complex()), x.data_ptr(), x.shape[-1], rows,
                      None if prev is None else prev.data_ptr(), rot.data_ptr(), wlen, nw,
                      parts, seg, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"symsync_block tone launch failed: CUDA error {err}")
    launches += 1
    return out


def _interp(segs, bank, partials, tau_prev, tau_valid, sync: BlockSync, n: int, nout: int,
            j0: int, origin: int, with_hist: bool, line: list | None = None):
    """Launch 2: (y (…, nout), τ carried (…), the new history or None); with
    ``line`` it also appends the (tm, slope, cm) the outputs sit on."""
    global launches
    _, interp = _kernel_fns()
    a = segs[0]
    lead = tuple(a.shape[:-1])
    rows = int(np.prod(lead, dtype=np.int64))
    lens = [s.shape[-1] for s in segs] + [0] * (3 - len(segs))
    ptrs = [s.data_ptr() for s in segs] + [a.data_ptr()] * (3 - len(segs))
    L = sum(lens)
    k, m = sync.k, sync.m
    npfb, W = bank.shape
    tile, cap = _plan(sync, npfb, W, a.element_size())
    bank = bank.contiguous()
    tau, ts = _rows_of(tau_prev.to(torch.float32), lead, rows)
    valid, vs = _rows_of(tau_valid.to(torch.bool), lead, rows)
    nw, parts = partials.shape[-2:]
    y = torch.empty((*lead, nout), dtype=a.dtype, device=a.device)
    tau_out = torch.empty(lead, dtype=torch.float32, device=a.device)
    hout = min(sync.H, L)
    hist = torch.empty((*lead, hout), dtype=a.dtype, device=a.device) if with_hist else None
    fit = torch.empty((3, *lead), dtype=torch.float32, device=a.device) if line is not None \
        else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = interp(int(a.is_complex()), ptrs[0], lens[0], ptrs[1], lens[1], ptrs[2], lens[2],
                     rows, partials.data_ptr(), nw, parts, tau.data_ptr(), ts, valid.data_ptr(),
                     vs, bank.data_ptr(), npfb, W, k, m * k, sync.out_per_sym, n,
                     float(np.float32(k / (2.0 * np.pi))), float(np.float32(sync.B)),
                     sync.start, j0, origin, nout, tile, cap, y.data_ptr(), tau_out.data_ptr(),
                     None if fit is None else fit.data_ptr(),
                     None if hist is None else hist.data_ptr(), hout, stream)
    if err != 0:
        raise RuntimeError(f"symsync_block interp launch failed: CUDA error {err}")
    launches += 1
    if line is not None:
        line.append(tuple(fit))
    return y, tau_out, hist


def symsync_block(x: torch.Tensor, bank: torch.Tensor, rot: torch.Tensor, state,
                  sync: BlockSync, line: list | None = None):
    """K9, ``SymSync.apply``: x (…, n) float32 or complex64, the (npfb, W)
    bank, the (n,) rotator, state (hist (…, H), tau, valid) →
    ((hist, tau, valid), y (…, (n // k)·out_per_sym)).  ``line``, a list,
    receives the (tm, slope, cm) (…) the outputs were interpolated on, so
    that a test can find where float order picks
    (``chip_smoke.record_ties``)."""
    hist, tau_prev, tau_valid = state
    _check(x, bank, rot, state)
    if x.device.type == "cpu":
        return symsync_block_ref(x, bank, rot, state, sync, line)
    k = sync.k
    n = x.shape[-1]
    hist, x = hist.contiguous(), x.contiguous()
    _launch_checks(x, hist.shape[-1] + n, (bank, rot, *state))
    nw = windows(n, k)
    partials = _tone(x, None, rot, nw, n // nw)
    y, tau_carry, new_hist = _interp((hist, x), bank, partials, tau_prev, tau_valid, sync, n,
                                     (n // k) * sync.out_per_sym, 0, 0, True, line)
    return (new_hist, tau_carry, torch.ones_like(tau_valid)), y


def symsync_block_shard(x: torch.Tensor, bank: torch.Tensor, rot: torch.Tensor, state,
                        sync: BlockSync, ctx):
    """K9 of a time rank, ``SymSync.shard_apply``: the tone's partials of
    this rank's windows are gathered over 'time' (the serial step's
    partials), every rank fits the same line, and interpolates its own
    outputs against [left halo | x | right halo]."""
    hist, tau_prev, tau_valid = state
    _check(x, bank, rot, state)
    if x.device.type == "cpu":
        return symsync_block_shard_ref(x, bank, rot, state, sync, ctx)
    k = sync.k
    x = x.contiguous()
    nloc = x.shape[-1]
    n = nloc * ctx.dt
    nout_loc = (nloc // k) * sync.out_per_sym
    lead = x.shape[:-1]
    prev1 = ctx.left_halo(x, x[..., :1], 1)
    left = ctx.left_halo(x, hist, sync.H).contiguous()
    right = ctx.right_halo(x, sync.m * k + k + sync.B).contiguous()
    _launch_checks(x, left.shape[-1] + nloc + right.shape[-1], (bank, rot, *state))
    nw = windows(n, k)
    part_loc = _tone(x, None if ctx.ti == 0 else prev1.contiguous(), rot, nw // ctx.dt, n // nw)
    parts = part_loc.shape[-1]
    partials = torch.movedim(ctx.all_gather_time(part_loc), 0, -3).reshape(*lead, nw, parts)
    y, tau_carry, _ = _interp((left, x, right), bank, partials.contiguous(), tau_prev,
                              tau_valid, sync, n, nout_loc, ctx.ti * nout_loc, ctx.ti * nloc,
                              False)
    new_hist = ctx.from_last_time(x[..., -sync.H:].contiguous())
    return (new_hist, tau_carry, torch.ones_like(tau_valid)), y
