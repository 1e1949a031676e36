"""Fused PFB tail — branch FIR → DFT → (FM demod) — and its plain PyTorch
versions.

Counterpart of ``csdr_tpu/ops/pallas/pfb_fused.py``: ``pfb_fm_fused`` (K3)
and ``pfb_channelize_fused`` (K4) take the same panels, taps and (column
shard of the) DFT matrix as the JAX functions, with complex64 in place of
the re/im planes, and return channel-major ``(ncho, F)`` where the JAX
functions return ``(F, ncho)``.  On a CUDA tensor each launches the
hand-written kernel of ``csrc/pfb_fused.cu`` or raises; only a tensor on
the CPU takes the plain version (``pfb_fm_fused_ref``,
``pfb_channelize_fused_ref``).  ``launches[name]`` counts the calls that
launched each kernel.

The NCO pre-shift and the frame panels stay in PyTorch, as the JAX package
leaves them to XLA (``frame_panels``).  Streaming steps:

  * ``channelized_fm_pfb_init/step`` — K3 behind the NCO; state
    ``(phase, hist_x (nch−1,), hist_v (L, nch))``, the JAX
    ``channelized_fm_pallas_init`` layout (``hist_v`` holds one frame more
    than the eager channelizer's: the demod's previous frame).
  * ``channelize_pfb_step`` — K4 behind the NCO; state
    ``(phase, (hist_x, hist_v (L−1, nch)))``, exactly ``PFBChannelizer``'s.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..nco import mix_stream
from ..pfb import pfb_design, pfb_offset

__all__ = ["pfb_fm_fused", "pfb_channelize_fused", "pfb_fm_fused_ref",
           "pfb_channelize_fused_ref", "frame_panels", "pfb_design",
           "channelized_fm_pfb_init", "channelized_fm_pfb_step", "channelize_pfb_step",
           "launches", "DEFAULT_TILE_F"]

DEFAULT_TILE_F = 64
_TWO_PI = 2.0 * np.pi
_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use
_TILE_SAMPLES = 4096   # kernel tiles: at most this many samples ...
_TILE_FRAMES = 512     # ... and frames

launches = {"pfb_fm_fused": 0, "pfb_channelize_fused": 0}


def frame_panels(hist_x: torch.Tensor, hist_v: torch.Tensor, xs: torch.Tensor, nch: int):
    """Frame panels v[i, p] = xs[i·nch − p] behind the ``hist_v`` frames;
    returns (new hist_x, vfull (H + F, nch))."""
    if xs.shape[0] % nch:
        raise ValueError(f"block of {xs.shape[0]} samples is not a multiple of nch = {nch}")
    F = xs.shape[0] // nch
    xfull = torch.cat([hist_x, xs])
    v = xfull[: F * nch].reshape(F, nch).flip(1)
    return xfull[F * nch:].clone(), torch.cat([hist_v, v])


def _branch_fir(vfull, taps, nout: int):
    """u[t] = Σ_l taps[l]·vfull[t + L − 1 − l] for t < nout."""
    L = taps.shape[0]
    u = None
    for l in range(L):
        term = vfull[L - 1 - l: L - 1 - l + nout] * taps[l][None, :]
        u = term if u is None else u + term
    return u


def pfb_fm_fused_ref(vfull, taps, W, *, nch: int, L: int, kf: float = 0.6):
    """Plain K3: vfull (F + L, nch) complex64 → audio (ncho, F) float32."""
    F = vfull.shape[0] - L
    d = _branch_fir(vfull, taps, F + 1) @ W                       # (F + 1, ncho)
    audio = torch.angle(d[1:] * d[:-1].conj()) * np.float32(1.0 / (_TWO_PI * kf))
    return audio.T.contiguous()


def pfb_channelize_fused_ref(vfull, taps, W, *, nch: int, L: int):
    """Plain K4: vfull (F + L − 1, nch) complex64 → channels (ncho, F)
    complex64."""
    F = vfull.shape[0] - (L - 1)
    return (_branch_fir(vfull, taps, F) @ W).T.contiguous()


def kernel_tile(F: int, tileF: int, nch: int) -> int:
    """The kernel's frames per tile, a divisor or multiple of tileF that
    divides F: tileF halved (while even and above 16) until a tile spans at
    most _TILE_SAMPLES samples, or doubled while it still divides F and
    stays within _TILE_SAMPLES samples and _TILE_FRAMES frames."""
    TF = tileF
    while TF * nch > _TILE_SAMPLES and TF % 2 == 0 and TF > 16:
        TF //= 2
    while F % (2 * TF) == 0 and 2 * TF * nch <= _TILE_SAMPLES and 2 * TF <= _TILE_FRAMES:
        TF *= 2
    return TF


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import load_library

    lib = load_library()
    fn = lib.csdr_pfb_fused
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, ctypes.c_longlong, I, I, I, I, ctypes.c_float, P, P]
    fn.restype = ctypes.c_int
    lib.csdr_pfb_smem.argtypes = [I, I, I, I, I]
    lib.csdr_pfb_smem.restype = ctypes.c_longlong
    return fn, lib.csdr_pfb_smem


def _check(name: str, vfull, taps, W, nch: int, L: int, tileF: int, demod: bool) -> int:
    """Validate the operands of K3/K4; returns F."""
    H = L if demod else L - 1
    if vfull.dtype != torch.complex64 or vfull.ndim != 2 or vfull.shape[1] != nch:
        raise ValueError(f"{name}: vfull must be complex64 (F + {H}, {nch}), got "
                         f"{vfull.dtype} {tuple(vfull.shape)}")
    if not vfull.is_contiguous():
        raise ValueError(f"{name}: vfull must be contiguous")
    if taps.dtype != torch.float32 or tuple(taps.shape) != (L, nch):
        raise ValueError(f"{name}: taps must be float32 ({L}, {nch}), got "
                         f"{taps.dtype} {tuple(taps.shape)}")
    if W.dtype != torch.complex64 or W.ndim != 2 or W.shape[0] != nch or W.shape[1] < 1:
        raise ValueError(f"{name}: W must be complex64 ({nch}, ncho), got "
                         f"{W.dtype} {tuple(W.shape)}")
    if not (taps.device == W.device == vfull.device):
        raise ValueError(f"{name}: operands on {vfull.device}, {taps.device}, {W.device}")
    if L < 1 or nch < 1:
        raise ValueError(f"{name}: need L >= 1 and nch >= 1, got L={L}, nch={nch}")
    if tileF < 1:
        raise ValueError(f"{name}: tileF must be positive, got {tileF}")
    F = vfull.shape[0] - H
    if F <= 0 or F % tileF:
        raise ValueError(f"{name}: {F} frames is not a positive multiple of tileF = {tileF}")
    if F // tileF >= 2 ** 31:
        raise ValueError(f"{name}: {F} frames is too long")
    return F


def _launch(name: str, demod: bool, vfull, taps, W, nch: int, L: int, tileF: int,
            inv_kf: float, out: torch.Tensor):
    device = vfull.device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")
    ncho = W.shape[1]
    F = out.shape[1]
    TF = kernel_tile(F, tileF, nch)
    fn, smem_of = _kernel_fn()
    smem = smem_of(int(demod), nch, ncho, L, TF)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: nch={nch}, ncho={ncho}, tileF={tileF} needs {smem} B of "
                         f"shared memory per block (limit {_SMEM_LIMIT}); use a smaller tileF")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(int(demod), vfull.data_ptr(), taps.data_ptr(), W.data_ptr(), F, nch, ncho, L,
                 TF, inv_kf, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def pfb_fm_fused(vfull, taps, W, *, nch: int, L: int, tileF: int = DEFAULT_TILE_F,
                 kf: float = 0.6):
    """K3: vfull (F + L, nch) complex64 panels (L history frames in front,
    already NCO-shifted and frame-reversed), taps (L, nch) float32, W
    (nch, ncho) complex64 — the DFT matrix or a column shard of it → audio
    (ncho, F) float32.  F must be a multiple of tileF."""
    F = _check("pfb_fm_fused", vfull, taps, W, nch, L, tileF, True)
    if vfull.device.type == "cpu":
        return pfb_fm_fused_ref(vfull, taps, W, nch=nch, L=L, kf=kf)
    W = W.contiguous()
    out = torch.empty((W.shape[1], F), dtype=torch.float32, device=vfull.device)
    return _launch("pfb_fm_fused", True, vfull, taps.contiguous(), W, nch, L, tileF,
                   float(np.float32(1.0 / (_TWO_PI * kf))), out)


def pfb_channelize_fused(vfull, taps, W, *, nch: int, L: int, tileF: int = DEFAULT_TILE_F):
    """K4: K3 without the demod.  vfull (F + L − 1, nch) → channels
    (ncho, F) complex64."""
    F = _check("pfb_channelize_fused", vfull, taps, W, nch, L, tileF, False)
    if vfull.device.type == "cpu":
        return pfb_channelize_fused_ref(vfull, taps, W, nch=nch, L=L)
    W = W.contiguous()
    out = torch.empty((W.shape[1], F), dtype=torch.complex64, device=vfull.device)
    return _launch("pfb_channelize_fused", False, vfull, taps.contiguous(), W, nch, L, tileF,
                   0.0, out)


def channelized_fm_pfb_init(nch: int, device: torch.device, m: int = 7):
    """(phase, hist_x (nch−1,), hist_v (L, nch)), zeros."""
    L = 2 * m
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((nch - 1,), dtype=torch.complex64, device=device),
            torch.zeros((L, nch), dtype=torch.complex64, device=device))


def channelized_fm_pfb_step(state, x, *, nch: int, m: int = 7, as_db: float = 80.0,
                            kf: float = 0.6, tileF: int = DEFAULT_TILE_F):
    """Fused ``PFBChannelizer >> PerChannel(FMDemod)``: (state, x (n,)
    complex64) → (state, audio (nch, n/nch) float32).  ``hist_v`` starts at
    zeros, so frame 0's demod sees a zero previous sample where ``FMDemod``
    starts from a unit sample."""
    phase, hist_x, hist_v = state
    new_phase, xs = mix_stream(phase, x, pfb_offset(nch), up=False)
    new_hist_x, vfull = frame_panels(hist_x, hist_v, xs, nch)
    taps, W = pfb_design(nch, m, float(as_db), x.device)
    audio = pfb_fm_fused(vfull, taps, W, nch=nch, L=2 * m, tileF=tileF, kf=kf)
    F = audio.shape[1]
    return (new_phase, new_hist_x, vfull[F:].clone()), audio


def channelize_pfb_step(state, x, *, nch: int, m: int = 7, as_db: float = 80.0,
                        tileF: int = DEFAULT_TILE_F):
    """Fused ``PFBChannelizer``: (state, x (n,) complex64) → (state,
    channels (nch, n/nch) complex64), with ``PFBChannelizer``'s state."""
    phase, (hist_x, hist_v) = state
    new_phase, xs = mix_stream(phase, x, pfb_offset(nch), up=False)
    new_hist_x, vfull = frame_panels(hist_x, hist_v, xs, nch)
    taps, W = pfb_design(nch, m, float(as_db), x.device)
    d = pfb_channelize_fused(vfull, taps, W, nch=nch, L=2 * m, tileF=tileF)
    F = d.shape[1]
    return (new_phase, (new_hist_x, vfull[F:].clone())), d
