"""Causal valid FIR with real taps (K5) and its plain PyTorch version.

Counterpart of ``csdr_tpu/ops/pallas/fir_kernel.py:pallas_fir_valid``, the
``"pallas_mxu"`` strategy of ``ops/fir.conv_valid``:

    y[..., i] = Σ_k h[k] · xfull[..., i + K − 1 − k],   i < n,

for real taps h (K,) over rows xfull (..., n + K − 1) of float32 or
complex64; any leading batch axes.  On a CUDA tensor ``fir_valid`` launches
the hand-written kernel of ``csrc/fir_valid.cu`` or raises; only a tensor on
the CPU takes the plain version ``fir_valid_ref`` (a ``conv1d`` over the real
planes; cuDNN's TF32 is off package-wide, so it runs in full float32).
``launches`` counts the calls that launched the kernel.

The kernel runs the FIR as a Toeplitz matrix product on the tensor cores
in bf16x3 (``bf16x3.py``): frames of ``FRAME`` outputs, k-steps of 16 taps,
runs of ``RUN`` outputs per work item and tap chunks of ``CHUNK_STEPS``
k-steps (the constants of the CUDA source).  Its A operand comes from the
tap-pair tables of ``tap_tables``, made once per taps and device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import source_ints
from .bf16x3 import pack_pairs, split_bf16

__all__ = ["fir_valid", "fir_valid_ref", "launches", "k_steps", "tap_tables"]

_MAX_ROWS = 65535      # grid.y (K6's launch)
_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use
# outputs per frame (wgmma's M), frames per work item (N), k-steps per tap
# chunk, and the pad of a tap table (word Q holds g[Q − TAP_PAD])
FRAME, FRAMES, CHUNK_STEPS, TAP_PAD = source_ints("fir_valid.cu", "kFrame", "kFrames",
                                                  "kChunkSteps", "kTapPad")
RUN = FRAME * FRAMES   # outputs per work item

launches = 0


def _real_taps(taps) -> np.ndarray:
    taps = np.asarray(taps)
    if np.iscomplexobj(taps) or taps.ndim != 1 or len(taps) < 1:
        raise ValueError(f"fir_valid takes real taps (K,), got {taps.dtype} {taps.shape}")
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _taps_on(key: bytes, device: torch.device) -> torch.Tensor:
    """The reversed float32 taps (K,) on ``device``, made once per taps and
    device: a blocking host→device copy synchronises the stream."""
    return torch.from_numpy(np.frombuffer(key, np.float32)[::-1].copy()).to(device)


def k_steps(K: int) -> int:
    """k-steps of 16 in the Toeplitz product: C = K + FRAME − 1 rounded up."""
    return -(-(K + FRAME - 1) // 16)


def tap_tables(h: np.ndarray) -> np.ndarray:
    """The kernel's A-operand tables for real taps h (K,): (2, 16·KS + 64)
    uint32, hi then lo, word Q = (g[Q − 64], g[Q − 63]) packed low then high,
    g the reversed taps, zero outside [0, K)."""
    K = len(h)
    KS = k_steps(K)
    g = np.zeros(16 * KS + TAP_PAD + 1, np.float32)
    g[TAP_PAD:TAP_PAD + K] = np.asarray(h, np.float32)[::-1]
    hi, lo = split_bf16(g)
    return np.stack([pack_pairs(hi[:-1], hi[1:]), pack_pairs(lo[:-1], lo[1:])])


@functools.lru_cache(maxsize=64)
def _tables_on(key: bytes, device: torch.device) -> torch.Tensor:
    """``tap_tables`` on ``device`` as int32 words, made once per taps and
    device (a blocking host→device copy synchronises the stream)."""
    t = tap_tables(np.frombuffer(key, np.float32))
    return torch.from_numpy(t.view(np.int32)).to(device)


def valid_len(name: str, xfull: torch.Tensor, K: int) -> int:
    """Validate FIR rows xfull (..., n + K − 1) of float32 or complex64, as
    the JAX functions do; returns n.  Shared by K5 and K6."""
    if xfull.dtype not in (torch.float32, torch.complex64) or xfull.ndim < 1:
        raise ValueError(f"{name}: xfull must be float32 or complex64 rows, got "
                         f"{xfull.dtype} {tuple(xfull.shape)}")
    n = xfull.shape[-1] - (K - 1)
    if n <= 0:
        raise ValueError(f"{name}: input ({xfull.shape[-1]}) must be longer than taps-1 "
                         f"({K - 1}) — the valid convolution would be empty")
    return n


def launch_rows(name: str, xfull: torch.Tensor) -> int:
    """The launch's limits on rows that are not on the CPU: a CUDA tensor,
    contiguous, at most 65535 rows (grid.y); returns the number of rows.
    Shared by K5 and K6."""
    if xfull.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {xfull.device}")
    if not xfull.is_contiguous():
        raise ValueError(f"{name}: xfull must be contiguous")
    rows = int(np.prod(xfull.shape[:-1], dtype=np.int64))
    if rows > _MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows is more than {_MAX_ROWS}")
    return rows


def fir_valid_ref(xfull: torch.Tensor, taps) -> torch.Tensor:
    """Plain K5: a float32 ``conv1d`` with the reversed taps over the real
    planes (complex rows run as their re and im planes)."""
    h = _real_taps(taps)
    K = len(h)
    n = valid_len("fir_valid", xfull, K)
    g = _taps_on(h.tobytes(), xfull.device)
    lead = xfull.shape[:-1]
    planes = torch.view_as_real(xfull).movedim(-1, -2) if xfull.is_complex() else xfull
    y = torch.nn.functional.conv1d(planes.reshape(-1, 1, xfull.shape[-1]), g.view(1, 1, K))
    if xfull.is_complex():
        y = y.reshape(*lead, 2, n).movedim(-2, -1).contiguous()
        return torch.view_as_complex(y)
    return y.reshape(*lead, n)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import load_library

    lib = load_library()
    fn = lib.csdr_fir_valid
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, P, P, LL, LL, I, I, P, P]
    fn.restype = ctypes.c_int
    lib.csdr_fir_valid_smem.argtypes = [I, I]
    lib.csdr_fir_valid_smem.restype = LL
    return fn, lib.csdr_fir_valid_smem


def fir_valid(xfull: torch.Tensor, taps) -> torch.Tensor:
    """K5: xfull (..., n + K − 1) float32 or complex64, taps (K,) real →
    (..., n) of xfull's dtype."""
    global launches
    h = _real_taps(taps)
    K = len(h)
    n = valid_len("fir_valid", xfull, K)
    if xfull.device.type == "cpu":
        return fir_valid_ref(xfull, h)
    rows = launch_rows("fir_valid", xfull)
    out = torch.empty((*xfull.shape[:-1], n), dtype=xfull.dtype, device=xfull.device)
    if rows == 0:
        return out
    fn, smem_of = _kernel_fn()
    cplx = int(xfull.is_complex())
    KS = k_steps(K)
    smem = smem_of(cplx, KS)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fir_valid: {smem} B of shared memory per block (limit {_SMEM_LIMIT})")
    tables = _tables_on(h.tobytes(), xfull.device)
    with torch.cuda.device(xfull.device):
        stream = torch.cuda.current_stream(xfull.device).cuda_stream
        err = fn(cplx, xfull.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), n,
                 xfull.shape[-1], KS, rows, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fir_valid kernel launch failed: CUDA error {err}")
    launches += 1
    return out
