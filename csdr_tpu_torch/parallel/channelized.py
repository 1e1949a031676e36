"""The channelized FM receiver sharded over a ('time', 'ch') mesh.

Counterpart of ``csdr_tpu/parallel/channelized.py``: dcBlocker → NCO
pre-shift → PFB(nch) → [per-channel AGC + squelch] → per-channel FM demod
(→ per-channel audio decimator), one process per device.

  * 'time': each rank holds a contiguous segment of nloc samples of the
    block.  Every stage that carries state gets its left neighbour's tail
    with one halo exchange (``ShardCtx.left_halo`` / ``send_right``).
  * 'ch': the DFT across the PFB branches is a product with W (nch × nch);
    each rank multiplies only its column shard, so it holds nch/dc channels,
    and the per-channel stages run on those alone.

The recurrences (DC blocker, the AGC's log gain) cross segment boundaries
exactly (``ShardCtx.linrec``).  The NCO's phase at a segment's start comes
from the rank's time index.  Carried state is replicated on every rank;
each leaf is taken from the last time rank (channel leaves gathered over
'ch' first), so streaming across blocks is exact on any mesh shape.

``use_fused`` runs the PFB FIR and the DFT shard in the K3 kernel with the
demod (``ops/cuda/pfb_fused.pfb_fm_fused``) or, with the AGC between them,
in K4 (``pfb_channelize_fused``); otherwise the same arithmetic runs as
PyTorch ops, the DFT shard a ``torch.matmul``.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..blocks import u8_to_iq
from ..core.sharding import CH, ShardCtx
from ..ops import pfb as pfb_ops
from ..ops.agc import agc_shard_stream
from ..ops.cuda import pfb_fused as pf
from ..ops.demod import freqdem_stream
from ..ops.fir import fir_decim_stream
from ..ops.iir import dc_blocker_shard_stream
from ..ops.nco import mix_stream, phase_increment
from ..utils.firdes import firdecim_kaiser

__all__ = ["ShardedChannelizedFM"]

_TWO_PI = 2.0 * np.pi


@dataclass
class ShardedChannelizedFM:
    """dcBlocker → NCO pre-shift → PFB(nch) → per-channel FM demod (→ audio
    decimator) over ``mesh`` (a DeviceMesh with dimensions ("time", "ch")).
    Every rank constructs it and calls ``step`` together; each returns its
    (nch/dc, nloc/nch/audio_decim) float32 share of the audio."""

    mesh: object
    nch: int
    block_size: int          # global samples per step
    kf: float = 0.6
    m: int = 7               # PFB taps per branch, semi-length
    as_db: float = 80.0
    audio_decim: int = 1
    dc_alpha: float = 0.0005
    agc_threshold_db: float | None = None   # per-channel AGC + squelch
    agc_signal_level: float = 1e-3
    use_fused: bool = False  # the PFB FIR, DFT shard (and demod) in K3 / K4
    tileF: int = pf.DEFAULT_TILE_F           # K3/K4 frames per tile

    def __post_init__(self):
        self.ctx = ShardCtx(self.mesh)
        self.dt, self.dc = self.ctx.dt, self.ctx.dc
        if self.nch % self.dc:
            raise ValueError(f"{self.nch} channels do not split over {self.dc} ch ranks")
        if self.block_size % (self.dt * self.nch * self.audio_decim):
            raise ValueError(f"block of {self.block_size} samples is not a multiple of "
                             f"time ranks · nch · audio_decim = "
                             f"{self.dt * self.nch * self.audio_decim}")
        self.nloc = self.block_size // self.dt
        self.nch_loc = self.nch // self.dc
        self.L = 2 * self.m
        f_loc = self.nloc // self.nch
        # K3 reads one history frame more than the FIR: the demod's d[t−1]
        self.pfb_halo = (self.L * self.nch + self.nch - 1 if self.use_fused
                         else self.L * self.nch - 1)
        if self.use_fused:
            self.tileF = min(self.tileF, f_loc)
            if f_loc % self.tileF:
                raise ValueError(f"{f_loc} frames per segment is not a multiple of "
                                 f"tileF = {self.tileF}")
        self.fir_taps = (firdecim_kaiser(self.audio_decim, 10, 60.0).astype(np.float32)
                         if self.audio_decim > 1 else None)
        # each stage's halo must fit in one neighbour's segment
        if self.nloc < self.pfb_halo:
            raise ValueError(f"segment of {self.nloc} samples is shorter than the PFB's "
                             f"{self.pfb_halo}-sample halo")
        if self.fir_taps is not None and f_loc < len(self.fir_taps) - 1:
            raise ValueError(f"{f_loc} frames per segment is shorter than the audio "
                             f"decimator's {len(self.fir_taps) - 1}-frame halo")
        self.rate = Fraction(1, self.nch * self.audio_decim)
        self.device = dev = self.ctx.device
        self._omega = float(pfb_ops.pfb_offset(self.nch))
        self._delta = np.float32(phase_increment(self._omega, self.nloc))
        c0 = self.ctx.ci * self.nch_loc
        self._rows = slice(c0, c0 + self.nch_loc)   # this rank's channels
        taps, W = pfb_ops.pfb_design(self.nch, self.m, float(self.as_db), dev)
        self._taps, self._W = taps, W[:, self._rows].contiguous()
        self._u8 = u8_to_iq()

    out_layout = CH   # each rank's output is its (nch/dc, F/dt) panel

    def rate_tree(self):
        return self.rate

    def flush_len(self) -> int:
        return 0

    # ---- state ----------------------------------------------------------
    def init(self):
        dev, nch = self.device, self.nch
        K = len(self.fir_taps) - 1 if self.fir_taps is not None else 0
        return dict(
            dc_x=torch.zeros((1,), dtype=torch.complex64, device=dev),
            dc_y=torch.zeros((1,), dtype=torch.complex64, device=dev),
            phase=torch.zeros((), dtype=torch.float32, device=dev),
            pfb_tail=torch.zeros((self.pfb_halo,), dtype=torch.complex64, device=dev),
            demod_last=torch.ones((nch,), dtype=torch.complex64, device=dev),
            fir_tail=torch.zeros((nch, K), dtype=torch.float32, device=dev),
            agc_lng=torch.full((nch,), float(np.float32(np.log(1.0 / self.agc_signal_level))),
                               dtype=torch.float32, device=dev),
            agc_above=torch.zeros((nch,), dtype=torch.bool, device=dev),
        )

    def _channels(self, v: torch.Tensor) -> torch.Tensor:
        """(nch_loc, ...) per-rank channel rows → (nch, ...) as the last time
        rank holds them, on every rank."""
        return self.ctx.from_last_time(self.ctx.all_gather_ch(v.contiguous()))

    # ---- the sharded step -------------------------------------------------
    def step(self, state, x):
        """(state, this rank's segment: complex64 (nloc,) or cu8 as uint8
        (nloc, 2) rows) → (state, audio (nch/dc, nloc/nch/audio_decim)
        float32 of this rank's channels and frames)."""
        ctx = self.ctx
        if x.dtype == torch.uint8:
            _, x = self._u8.apply((), x)

        # DC blocker: a distributed linear recurrence
        (dc_x, dc_y), xdc = dc_blocker_shard_stream((state["dc_x"], state["dc_y"]), x, ctx,
                                                    self.dc_alpha)
        new = dict(dc_x=dc_x, dc_y=dc_y)

        # NCO pre-shift, the segment's phase from the rank's time index
        phase0 = state["phase"] + self._delta * np.float32(ctx.ti)
        _, xs = mix_stream(phase0, xdc, self._omega, up=False)
        new["phase"] = torch.remainder(state["phase"] + self._delta * np.float32(self.dt),
                                       np.float32(_TWO_PI))
        new["pfb_tail"] = ctx.from_last_time(xs[-self.pfb_halo:].contiguous())

        # PFB: frame panels behind the history frames (L − 1; L for K3) from
        # the left halo
        nch, L = self.nch, self.L
        halo = ctx.left_halo(xs, state["pfb_tail"], self.pfb_halo)
        _, vfull = pfb_ops.halo_panels(halo, xs, nch)

        agc = self.agc_threshold_db is not None
        if not agc:
            new.update(agc_lng=state["agc_lng"], agc_above=state["agc_above"])
        if self.use_fused and not agc:
            # K3: the extra history frame is the demod's previous frame
            audio = pf.pfb_fm_fused(vfull, self._taps, self._W, nch=nch, L=L,
                                    tileF=self.tileF, kf=self.kf)
            new["demod_last"] = state["demod_last"]
        else:
            if self.use_fused:
                d = pf.pfb_channelize_fused(vfull[1:], self._taps, self._W, nch=nch, L=L,
                                            tileF=self.tileF)
            else:
                d = pf.pfb_channelize_fused_ref(vfull, self._taps, self._W, nch=nch, L=L)
            if agc:
                d = self._agc(state, d, new)
            # FM demod with a one-frame halo
            left = ctx.send_right(d[:, -1].contiguous())
            last = state["demod_last"][self._rows] if left is None else left
            _, audio = freqdem_stream(last[:, None], d, self.kf)
            new["demod_last"] = self._channels(d[:, -1])

        # per-channel audio decimator with a (K−1)-frame halo
        if self.fir_taps is None:
            new["fir_tail"] = state["fir_tail"]
        else:
            K = len(self.fir_taps)
            left = ctx.send_right(audio[:, -(K - 1):].contiguous())
            hist = state["fir_tail"][self._rows] if left is None else left
            new["fir_tail"] = self._channels(audio[:, -(K - 1):])
            _, audio = fir_decim_stream(self.fir_taps, self.audio_decim, hist, audio)
        return new, audio

    def _agc(self, state, d, new):
        """Per-channel AGC + squelch across the time mesh (``ops/agc.py``:
        liquid's agc_crcf at bandwidth 0.1) along each channel row, its
        carried leaves gathered over the channel rows."""
        rows = self._rows
        (new["agc_lng"], new["agc_above"]), y = agc_shard_stream(
            (state["agc_lng"][rows], state["agc_above"][rows]), d, self.ctx, 0.1,
            self.agc_threshold_db, carried=self._channels)
        return y
