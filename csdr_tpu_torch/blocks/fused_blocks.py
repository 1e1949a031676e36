"""Blocks backed by the hand-written CUDA kernels.

Counterpart of ``csdr_tpu/blocks/pallas_blocks.py``: ``FlagshipFused``
(the whole chain, K1/K2), ``PFBFusedFM`` (``PallasChannelizedFM``, K3) and
``PFBFusedChannelizer`` (the channelizer alone on K4, which the JAX package
calls inside its sharded AGC flow).  ``tileF=None`` takes the card's
best-known tile from ``utils/autotune`` (the kernel's default without a
cache entry); the block's granule, nch·tileF, follows it."""

from __future__ import annotations

from fractions import Fraction

import torch

from ..core.block import Block
from ..ops import pfb as pfb_ops
from ..ops.cuda import flagship_fused as ff
from ..ops.cuda import pfb_fused as pf
from ..utils import autotune

__all__ = ["FlagshipFused", "PFBFusedFM", "PFBFusedChannelizer"]


class FlagshipFused(Block):
    """dc_blocker >> PFB channelizer >> PerChannel(FM demod) as one fused
    step (``ops/cuda/flagship_fused.py``): one CUDA kernel chain on a CUDA
    tensor, its plain twin on a CPU tensor.

    Takes complex64 (n,) samples, or cu8 as uint8 (n, 2) rows (one row per
    IQ sample, as ``io.sources.cu8_file_source`` yields them), (2n,)
    interleaved bytes or a (re, im) pair of uint8 planes; the kernel converts
    cu8 itself, so the host→device copy carries 2 bytes per sample."""

    def __init__(self, nch: int, kf: float = 0.6, m: int = 7, as_db: float = 80.0,
                 tileF: int | None = None, dc_alpha: float = 0.0005):
        self.nch, self.kf, self.m, self.as_db, self.dc_alpha = nch, kf, m, as_db, dc_alpha
        self.tileF = autotune.lookup("flagship_fused", nch) if tileF is None else tileF
        self.rate = Fraction(1, nch)
        self.granule = nch * self.tileF
        # "/torch-v1": the state is the JAX narrow kernel's, with complex hist
        # and the x_last / y_dc_last scalars in place of the (4,) scal vector
        # — a saved state of another layout must not resume into this block
        self.name = f"flagship_fused({nch})/torch-v1"

    def init(self, device: torch.device):
        return ff.flagship_fused_init(self.nch, device, self.m)

    def apply(self, state, x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.uint8 and x.ndim == 2:
            x = x.reshape(-1)  # (n, 2) rows → (2n,) interleaved, a view
        return ff.flagship_fused_step(state, x, nch=self.nch, m=self.m, as_db=self.as_db,
                                      kf=self.kf, dc_alpha=self.dc_alpha, tileF=self.tileF)


class PFBFusedFM(Block):
    """PFB channelizer >> PerChannel(FM demod) with the channelizer's NCO in
    PyTorch and the FIR, DFT and demod in the K3 kernel
    (``ops/cuda/pfb_fused.channelized_fm_pfb_step``).  Drop-in for
    ``firpfbch_channelizer(nch) >> PerChannel(fm_demodulator(kf))`` from
    frame 1 on; the state is the JAX ``PallasChannelizedFM``'s."""

    def __init__(self, nch: int, kf: float = 0.6, m: int = 7, as_db: float = 80.0,
                 tileF: int | None = None):
        self.nch, self.kf, self.m, self.as_db = nch, kf, m, as_db
        self.tileF = autotune.lookup("pfb_fm_fused", nch) if tileF is None else tileF
        self.rate = Fraction(1, nch)
        self.granule = nch * self.tileF
        self.name = f"pfb_fused_fm({nch})"

    def init(self, device: torch.device):
        return pf.channelized_fm_pfb_init(self.nch, device, self.m)

    def apply(self, state, x):
        return pf.channelized_fm_pfb_step(state, x, nch=self.nch, m=self.m, as_db=self.as_db,
                                          kf=self.kf, tileF=self.tileF)


class PFBFusedChannelizer(Block):
    """``PFBChannelizer`` with the FIR and DFT in the K4 kernel
    (``ops/cuda/pfb_fused.channelize_pfb_step``): the same rate, output
    (nch, n/nch) complex64 and state, and a granule of nch·tileF."""

    def __init__(self, nch: int, m: int = 7, as_db: float = 80.0, tileF: int | None = None):
        self.nch, self.m, self.as_db = nch, m, as_db
        self.tileF = autotune.lookup("pfb_channelize_fused", nch) if tileF is None else tileF
        self.rate = Fraction(1, nch)
        self.granule = nch * self.tileF
        # "/torch-v1", as FlagshipFused: a layout version for saved states;
        # this first layout is PFBChannelizer's, so either block resumes the
        # other's state
        self.name = f"pfb_fused_channelizer({nch})/torch-v1"

    def init(self, device: torch.device):
        return (torch.zeros((), dtype=torch.float32, device=device),
                pfb_ops.pfb_analyze_init(self.nch, device, self.m))

    def apply(self, state, x):
        return pf.channelize_pfb_step(state, x, nch=self.nch, m=self.m, as_db=self.as_db,
                                      tileF=self.tileF)
