"""The fused flagship step — DC blocker → NCO → PFB → DFT → FM demod — and
its plain PyTorch twin.

Counterpart of ``csdr_tpu/ops/pallas/flagship_fused.py`` (and of the wide
layout in ``flagship_fused_wide.py``, which computes the same function).
On a CUDA tensor ``flagship_fused_step`` launches the hand-written kernel of
``csrc/flagship_fused.cu`` or raises; only a tensor on the CPU takes the
plain twin, ``flagship_fused_ref``.  ``launches`` counts the calls that
launched the CUDA kernels (one per step; the CPU twin does not count).

The channel pass (``channel_tile``) is a persistent walk: ``channel_plan``
cuts the F frames into tiles of ``tile_frames`` frames and hands each block
a run of them, as many blocks as the card holds at once (fewer where F is
short: then one tile a block).  Only a run's first tile stages the L+1
frames before it; ``staged_samples`` counts what the pass stages, and a
launch adds it and the block's samples to the ``utils/prof`` counters
``flagship.channel_staged_samples`` and ``flagship.samples`` while a
session records.

State (the JAX kernel's layout, with the re/im planes joined):

    phase      float32 ()           NCO phase at the block's first sample
    hist       complex64 (L+1, nch) last L+1 DC-blocked, NCO-shifted frames
    x_last     complex64 ()         last raw input sample
    y_dc_last  complex64 ()         last DC-blocker output sample

``hist`` starts at zeros, so the first frame's demod sees a zero previous
sample (output 0) where ``FMDemod`` starts from a unit sample.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils import prof
from ..iir import dc_blocker_stream
from ..nco import mix_stream, phase_increment, phase_ramp
from ..pfb import pfb_offset, pfb_taps

__all__ = ["flagship_fused_init", "flagship_fused_step", "flagship_fused_ref",
           "permuted_tap_panel", "launches", "DEFAULT_TILE_F", "tile_frames", "channel_plan",
           "staged_samples"]

DEFAULT_TILE_F = 32
_TWO_PI = 2.0 * np.pi
_SCAN_THREADS = 1024   # csrc/flagship_fused.cu kScanThreads
_CHANNEL_THREADS = 256  # csrc/flagship_fused.cu kChannelThreads
_TILE_SAMPLES = 4096    # samples a channel tile takes where tileF allows
_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use
_MODES = {"complex": 0, "u8": 1, "u8_planes": 2}

launches = 0


@functools.lru_cache(maxsize=None)
def permuted_tap_panel(nch: int, m: int, as_db: float) -> np.ndarray:
    """(L+1, nch) panel T̂ with û[i,q] = Σ_J T̂[J,q]·ŝ[i−J, q] equal to the
    PFB branch output u[i, p=(nch−q)%nch] over natural frames
    ŝ[f, q] = x̂[f·nch + q]: the frame reversal becomes a tap permutation."""
    taps = pfb_taps(nch, m, as_db)
    L = taps.shape[0]
    That = np.zeros((L + 1, nch), dtype=np.float32)
    That[:L, 0] = taps[:, 0]
    for q in range(1, nch):
        That[1:L + 1, q] = taps[:, nch - q]
    return That


@functools.lru_cache(maxsize=None)
def _forward_dft(nch: int) -> np.ndarray:
    """Ŵ[q, k] = W[(nch−q) % nch, k] = e^{−j2πkq/nch}."""
    q = np.arange(nch)
    return np.exp(-2j * np.pi * np.outer(q, q) / nch).astype(np.complex64)


def flagship_fused_init(nch: int, device: torch.device, m: int = 7):
    L = 2 * m
    return dict(
        phase=torch.zeros((), dtype=torch.float32, device=device),
        hist=torch.zeros((L + 1, nch), dtype=torch.complex64, device=device),
        x_last=torch.zeros((), dtype=torch.complex64, device=device),
        y_dc_last=torch.zeros((), dtype=torch.complex64, device=device),
    )


def _classify(x):
    """(mode, x0, x1, n) for complex64 (n,), uint8 (2n,) interleaved or a
    (re, im) pair of uint8 (n,) planes; raises on anything else."""
    if isinstance(x, (tuple, list)):
        if len(x) != 2:
            raise ValueError("u8 planes must be a (re, im) pair")
        x0, x1 = x
        for p in (x0, x1):
            if p.dtype != torch.uint8 or p.ndim != 1:
                raise TypeError(f"u8 planes must be 1-D uint8, got {p.dtype} {tuple(p.shape)}")
        if x0.shape != x1.shape or x0.device != x1.device:
            raise ValueError("u8 planes differ in shape or device")
        return "u8_planes", x0, x1, x0.shape[0]
    if x.ndim != 1:
        raise ValueError(f"input must be 1-D, got shape {tuple(x.shape)}")
    if x.dtype == torch.complex64:
        return "complex", x, None, x.shape[0]
    if x.dtype == torch.uint8:
        if x.shape[0] % 2:
            raise ValueError("interleaved u8 input must have even length")
        return "u8", x, None, x.shape[0] // 2
    raise TypeError(f"input must be complex64 or uint8, got {x.dtype}")


def _u8_to_float(v: torch.Tensor) -> torch.Tensor:
    # the kernel's map, v·(1/127.5) − 1
    return v.to(torch.float32) * np.float32(1.0 / 127.5) - np.float32(1.0)


def flagship_fused_ref(state, x, *, nch: int, m: int = 7, as_db: float = 80.0,
                       kf: float = 0.6, dc_alpha: float = 0.0005):
    """Plain PyTorch version of the fused step, on the port's own ops:
    dc_blocker_stream → mix_stream → permuted-tap FIR over [hist | frames]
    → DFT matmul → conjugate-product demod.  Same state and output as the
    kernel."""
    mode, x0, x1, n = _classify(x)
    if mode == "complex":
        xc = x0
    elif mode == "u8":
        f = _u8_to_float(x0).reshape(n, 2)
        xc = torch.complex(f[:, 0], f[:, 1])
    else:
        xc = torch.complex(_u8_to_float(x0), _u8_to_float(x1))
    F = n // nch
    L = 2 * m
    (x_last, y_last), y = dc_blocker_stream(
        (state["x_last"].reshape(1), state["y_dc_last"].reshape(1)), xc, dc_alpha)
    phase, s = mix_stream(state["phase"], y, pfb_offset(nch), up=False)
    ext = torch.cat([state["hist"], s.reshape(F, nch)])          # (F + L + 1, nch)
    That = torch.from_numpy(permuted_tap_panel(nch, m, as_db)).to(xc.device)
    u = None
    for J in range(L + 1):
        term = ext[L - J: L - J + F + 1] * That[J][None, :]
        u = term if u is None else u + term
    d = u @ torch.from_numpy(_forward_dft(nch)).to(xc.device)     # (F + 1, nch)
    audio = torch.angle(d[1:] * d[:-1].conj()) * np.float32(1.0 / (_TWO_PI * kf))
    new_state = dict(phase=phase, hist=ext[F:].contiguous(), x_last=x_last.reshape(()),
                     y_dc_last=y_last.reshape(()))
    return new_state, audio.T.contiguous()


def _dc_split(C: int) -> tuple[int, int]:
    """(samples per thread, threads) for a DC chunk of C samples: 8 samples
    per thread, more where C/8 would exceed a 1024-thread block."""
    spt = 8
    while C // spt > 1024:
        spt *= 2
    if C % spt:
        raise ValueError(f"nch·tileF = {C} does not split into ≤1024 threads of "
                         f"{spt} samples")
    return spt, C // spt


def tile_frames(nch: int, tileF: int, F: int, L: int) -> int:
    """Frames per channel tile: the largest multiple of tileF with
    TF·nch <= 4096 samples (tileF at least), raised above L so that a tile
    holds the next one's FIR halo, and at most F (64 at nch 64: the G = 4
    lanes of the 64-point FFT fill the 256 threads).  The stream's last
    tile takes what is left of F, a multiple of tileF."""
    TF = max(1, _TILE_SAMPLES // (tileF * nch)) * tileF
    while TF <= L:
        TF += tileF
    return min(TF, F)


def channel_plan(nch: int, tileF: int, F: int, L: int, slots: int) -> tuple[int, int, int]:
    """(TF, run, grid): tiles of TF frames, ``run`` consecutive tiles per
    channel block, ``grid`` blocks, as few tiles per block as ``slots``
    resident blocks allow (one where the tiles are fewer than the slots)."""
    TF = tile_frames(nch, tileF, F, L)
    tiles = -(-F // TF)
    run = -(-tiles // max(1, slots))
    return TF, run, -(-tiles // run)


def staged_samples(nch: int, F: int, L: int, TF: int, run: int) -> int:
    """Input samples the channel pass stages for a block of F frames: every
    tile's own, and each run's halo, the L+1 frames before its first tile
    that lie in the block (the stream's earlier frames come from hist)."""
    tiles = -(-F // TF)
    grid = -(-tiles // run)
    return (F + sum(min(L + 1, b * run * TF) for b in range(grid))) * nch


def _replay_splits(nch: int, L: int, TF: int) -> tuple[int, int]:
    """Samples per thread of the channel tile's DC replay: over a run's
    first range (halo and tile), and over a later tile."""
    return -(-(TF + L + 1) * nch // _CHANNEL_THREADS), -(-TF * nch // _CHANNEL_THREADS)


@functools.lru_cache(maxsize=64)
def _constants(nch: int, m: int, as_db: float, tileF: int, dc_alpha: float, n: int,
               device: torch.device):
    """Device-resident design constants of one (configuration, block
    length, device): taps, twiddles, the NCO ramp and powers of r, the
    latter made in float64 on the host.  o_h is the offset of every run's
    halo start inside its chunk."""
    r = 1.0 - dc_alpha
    C = tileF * nch
    spt, nthr = _dc_split(C)
    TF = tile_frames(nch, tileF, n // nch, 2 * m)
    spt_a, spt_b = _replay_splits(nch, 2 * m, TF)
    o_h = -(2 * m + 1) * nch % C
    n_chunks = n // C
    mpt = -(-n_chunks // _SCAN_THREADS)
    tw = np.exp(-2j * np.pi * np.arange(nch) / nch).astype(np.complex64)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(
        spt=spt, m=mpt, rC=float(np.float32(r ** C)), TF=TF, spt_a=spt_a, spt_b=spt_b,
        o_h=o_h,
        r=float(np.float32(r)), g=float(np.float32((1.0 + r) / 2.0)),
        phase_inc=float(np.float32(phase_increment(float(pfb_offset(nch)), int(n)))),
        r_loc=float(np.float32(r ** (o_h % spt))), r_oh=float(np.float32(r ** o_h)),
        taps=put(permuted_tap_panel(nch, m, as_db)),
        twiddle=put(tw),
        ramp2=put(phase_ramp(float(pfb_offset(nch)), 2 * nch)),
        pow_thr=put(np.power(r, spt * np.arange(nthr + 1, dtype=np.float64)).astype(np.float32)),
        pow_blk=put(np.power(r, float(C) * mpt * np.arange(_SCAN_THREADS + 1,
                                                           dtype=np.float64)).astype(np.float32)),
        pow_rep=put(np.power(r, np.outer([spt_a, spt_b], np.arange(
            _CHANNEL_THREADS + 1, dtype=np.float64))).astype(np.float32)),
    )


@functools.lru_cache(maxsize=64)
def _launch_plan(mode: str, nch: int, L: int, tileF: int, F: int, vec: int,
                 device: torch.device) -> tuple[int, int, int]:
    """(TF, run, staged samples) of one launch shape on ``device``: its runs
    sized from the channel blocks the card holds at once."""
    lib = _library()
    TF = tile_frames(nch, tileF, F, L)
    smem = lib.csdr_channel_smem(_MODES[mode], nch, L, TF, vec)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"nch={nch}, tileF={tileF} needs {smem} B of shared memory per "
                         f"tile of {TF} frames (limit {_SMEM_LIMIT}); use a smaller tileF")
    with torch.cuda.device(device):
        slots = lib.csdr_channel_slots(_MODES[mode], nch, L, TF, vec)
    if slots < 1:
        raise RuntimeError(f"no channel block of nch={nch}, {TF} frames fits on {device}")
    TF, run, _ = channel_plan(nch, tileF, F, L, slots)
    return TF, run, staged_samples(nch, F, L, TF, run)


@functools.lru_cache(maxsize=None)
def _library():
    """The built library with the flagship entry points typed."""
    from ._build import load_library

    lib = load_library()
    lib.csdr_scan_threads.restype = lib.csdr_channel_threads.restype = ctypes.c_int
    if (lib.csdr_scan_threads(), lib.csdr_channel_threads()) != (_SCAN_THREADS,
                                                                  _CHANNEL_THREADS):
        raise RuntimeError("csrc/flagship_fused.cu thread counts differ from the wrapper's")
    lib.csdr_channel_smem.restype = ctypes.c_longlong
    lib.csdr_channel_slots.restype = ctypes.c_int
    lib.csdr_channel_smem.argtypes = lib.csdr_channel_slots.argtypes = [ctypes.c_int] * 5
    fn = lib.csdr_flagship_fused
    P, I, LL, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [I, P, P, LL] + [I] * 11 + [Fl] * 7 + [P] * 19
    fn.restype = ctypes.c_int
    return lib


def _check_state(state, nch: int, L: int, device: torch.device):
    want = dict(phase=((), torch.float32), hist=((L + 1, nch), torch.complex64),
                x_last=((), torch.complex64), y_dc_last=((), torch.complex64))
    for k, (shape, dt) in want.items():
        v = state[k]
        if tuple(v.shape) != shape or v.dtype != dt or v.device != device \
                or not v.is_contiguous():
            raise ValueError(f"state[{k!r}] must be a contiguous {dt} {shape} tensor on "
                             f"{device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def flagship_fused_step(state, x, *, nch: int, m: int = 7, as_db: float = 80.0,
                        kf: float = 0.6, dc_alpha: float = 0.0005,
                        tileF: int = DEFAULT_TILE_F):
    """(state, x) → (state, audio (nch, n/nch) float32).

    ``x`` is complex64 (n,), uint8 (2n,) interleaved rtl_sdr cu8, or a
    (re, im) pair of uint8 (n,) planes; cu8 is converted inside the kernel
    as v·(1/127.5) − 1.  n must be a multiple of nch·tileF.  On CUDA the
    three launches of ``csrc/flagship_fused.cu`` run on the current stream;
    on the CPU the plain twin runs."""
    global launches
    mode, x0, x1, n = _classify(x)
    L = 2 * m
    if nch < 2:
        raise ValueError(f"nch must be >= 2, got {nch}")
    if tileF < 8 or tileF % 8:
        raise ValueError(f"tileF must be a positive multiple of 8, got {tileF}")
    if n == 0 or n % (nch * tileF):
        raise ValueError(f"block of {n} samples is not a positive multiple of "
                         f"nch·tileF = {nch * tileF}")
    for p in (x0, x1):
        if p is not None and not p.is_contiguous():
            raise ValueError("input must be contiguous")
    device = x0.device
    _check_state(state, nch, L, device)
    if device.type == "cpu":
        return flagship_fused_ref(state, x, nch=nch, m=m, as_db=as_db, kf=kf,
                                  dc_alpha=dc_alpha)
    if device.type != "cuda":
        raise ValueError(f"flagship_fused_step runs on cuda or cpu tensors, got {device}")
    if mode == "u8" and x0.data_ptr() % 2:
        raise ValueError("interleaved u8 input must start on an even byte (uchar2 loads)")
    lib = _library()
    spt, _ = _dc_split(nch * tileF)
    n_chunks = n // (nch * tileF)
    if n_chunks >= 2 ** 31:  # one CUDA block per chunk
        raise ValueError(f"block of {n} samples is too long")
    F = n // nch
    # 16-byte loads in the DC chunk pass and the channel tiles' prefetch:
    # every chunk and tile starts 16-aligned
    vec = int(nch * tileF % 16 == 0 and all(p is None or p.data_ptr() % 16 == 0
                                             for p in (x0, x1)))
    TF, run, staged = _launch_plan(mode, nch, L, tileF, F, vec, device)
    c = _constants(nch, m, float(as_db), tileF, float(dc_alpha), n, device)
    # few allocations: the step's host time is a good part of its wall time
    cstate = torch.empty((L + 1) * nch + 2, dtype=torch.complex64, device=device)
    new_state = dict(phase=torch.empty((), dtype=torch.float32, device=device),
                     hist=cstate[:-2].view(L + 1, nch), x_last=cstate[-2], y_dc_last=cstate[-1])
    chunk_end, chunk_in, partial = torch.empty((3, n_chunks), dtype=torch.complex64,
                                               device=device)
    audio = torch.empty((nch, F), dtype=torch.float32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.csdr_flagship_fused(
            _MODES[mode], ptr(x0), ptr(x1), n, nch, L, tileF, TF, run, spt, c["m"], c["spt_a"],
            c["spt_b"], c["o_h"], vec, c["r"], c["g"], c["rC"], c["r_loc"], c["r_oh"],
            float(np.float32(1.0 / (_TWO_PI * kf))), c["phase_inc"],
            ptr(c["taps"]), ptr(c["twiddle"]), ptr(c["ramp2"]), ptr(c["pow_thr"]),
            ptr(c["pow_blk"]), ptr(c["pow_rep"]), ptr(state["phase"]), ptr(state["hist"]),
            ptr(state["x_last"]), ptr(state["y_dc_last"]), ptr(new_state["phase"]),
            ptr(new_state["hist"]), ptr(new_state["x_last"]), ptr(new_state["y_dc_last"]),
            ptr(chunk_end), ptr(chunk_in), ptr(partial), ptr(audio), stream)
    if err != 0:
        raise RuntimeError(f"flagship_fused kernel launch failed: CUDA error {err}")
    launches += 1
    prof.count("flagship.samples", n)
    prof.count("flagship.channel_staged_samples", staged)
    return new_state, audio
