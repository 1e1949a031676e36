"""The flagship kernel (K1) time-sharded over a ('time', 'ch' = 1) mesh.

Counterpart of ``csdr_tpu/parallel/flagship.py``.  Every rank runs the whole
fused step (``ops/cuda/flagship_fused.flagship_fused_step``: DC blocker →
NCO → PFB → DFT → FM demod) on its contiguous segment of nloc samples.  K1's
carried state couples the segments in three ways, each resolved with one
collective round before the kernel runs:

  * ``hist`` — the last L+1 DC-blocked, NCO-shifted frames before the
    segment.  Each rank solves its own tail's DC recurrence with zero carry
    over a suffix window of W samples, corrects it in closed form with its
    incoming carry, shifts it by the NCO at its global sample indices and
    sends it right (``ShardCtx.send_right``);
  * ``x_last`` — the left neighbour's last raw sample (one-sample halo);
  * ``y_dc_last`` — the incoming DC carry, rebuilt from the all-gathered
    zero-carry end values with the host float64 decay tables:
    y_in[i] = a^(i·nloc)·y₀ + Σ_{j<i} a^(nloc·(i−1−j))·w_end[j].

Rank i's NCO phase is the carried phase plus (i·nloc·ω) mod 2π, made in
float64 on the host, so the halo it receives carries exactly the phase the
serial kernel gave those samples.  The carried state comes from the last
rank's kernel outputs.  The JAX module also aligns the NCO's 128-lane
phase fold of its wide TPU layout; K1 has no such layout, and its own
constraint is nloc % (nch·tileF) == 0.

Suffix window: with dc_alpha = 5e-4 the DC pole is a = 0.9995 and a
sample's weight in the recurrence falls as a^d, below 1e-28 at d = 2^17.
For nloc > W = 2^17 the zero-carry solve covers only the segment's last W
samples; the dropped weight a^W is far below float32 resolution.  For
nloc ≤ W it covers the segment and the result is exact.

At one time rank the step is the serial kernel itself, bit for bit, unless
``force_full`` runs the whole pre-pass and collective program with trivial
exchanges (the one-card check of that program).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..core.sharding import CH, ShardCtx, _astep_table, _carry_coef_table
from ..ops.cuda import flagship_fused as ff
from ..ops.linrec import linrec
from ..ops.nco import _ramp_on, phase_increment
from ..ops.pfb import pfb_offset

__all__ = ["ShardedFlagship"]

_TWO_PI = 2.0 * np.pi

# suffix window of the pre-pass's zero-carry DC solve: a^(2^17) ≈ 1e-28 at
# the production dc_alpha, far below float32 resolution of a carried value
_DC_WINDOW = 1 << 17


@functools.lru_cache(maxsize=None)
def _tail_coef(a: float, nloc: int, hs: int) -> np.ndarray:
    """(hs,) float32 a^(p+1) for the last ``hs`` local positions p = nloc−hs
    .. nloc−1: the incoming carry's weight in each halo sample's DC output
    (float64-accumulated; exact 0 at production nloc, where the carry's
    influence is gone)."""
    p = np.arange(nloc - hs, nloc, dtype=np.float64)
    return np.power(float(a), p + 1.0).astype(np.float32)


def _segment_complex(x) -> torch.Tensor:
    """A segment in any of K1's input forms as complex64, cu8 mapped as the
    kernel maps it (v·(1/127.5) − 1)."""
    if isinstance(x, (tuple, list)):
        re, im = x
    elif x.dtype == torch.uint8:
        rows = x.reshape(-1, 2)
        re, im = rows[:, 0], rows[:, 1]
    else:
        return x
    return torch.complex(ff._u8_to_float(re), ff._u8_to_float(im))


def _suffix(x, start: int):
    """Samples start.. of a segment in any of K1's input forms."""
    if isinstance(x, (tuple, list)):
        return tuple(p[start:] for p in x)
    if x.dtype == torch.uint8:
        return x.reshape(-1, 2)[start:]
    return x[start:]


@dataclass
class ShardedFlagship:
    """``flagship_fused_step`` time-sharded over ``mesh`` (a DeviceMesh
    with dimensions ("time", "ch"), "ch" of size 1): the serial kernel's
    state leaves and its (nch, n/nch) float32 audio, each rank holding its
    segment's frames, streaming across blocks on any time-axis size.  Every
    rank of the mesh constructs it and calls ``step`` together."""

    mesh: object
    nch: int
    block_size: int              # global samples per step
    kf: float = 0.6
    m: int = 7
    as_db: float = 80.0
    dc_alpha: float = 0.0005
    tileF: int = ff.DEFAULT_TILE_F
    # run the pre-pass and collective program at one time rank too, where it
    # would otherwise delegate to the serial kernel
    force_full: bool = False

    def __post_init__(self):
        self.ctx = ShardCtx(self.mesh)
        if self.ctx.dc != 1:
            raise NotImplementedError(
                f"ShardedFlagship shards over time only; the 'ch' dimension has size "
                f"{self.ctx.dc} (ShardedChannelizedFM shards channels)")
        self.dt = self.ctx.dt
        if 64 % self.nch:
            raise ValueError(f"ShardedFlagship needs nch | 64, got {self.nch}")
        if self.block_size % self.dt:
            raise ValueError(f"block of {self.block_size} samples does not split into "
                             f"{self.dt} time segments")
        self.nloc = self.block_size // self.dt
        gran = self.nch * self.tileF
        if self.nloc % gran:
            raise ValueError(f"segment of {self.nloc} samples is not a multiple of "
                             f"nch·tileF = {gran}")
        self.L = 2 * self.m
        self.hs = (self.L + 1) * self.nch   # halo samples: K1's hist
        if self.nloc < self.hs:
            raise ValueError(f"segment of {self.nloc} samples is shorter than the "
                             f"{self.hs}-sample halo")
        self.r = 1.0 - self.dc_alpha
        self.W = min(self.nloc, _DC_WINDOW)
        self.rate = Fraction(1, self.nch)
        self.device = self.ctx.device
        omega = pfb_offset(self.nch)
        self._omega = float(omega)
        # this rank's NCO phase offset and the block's phase step, float64-made
        self._phase_off = np.float32(phase_increment(self._omega, self.ctx.ti * self.nloc))
        self._phase_step = np.float32(phase_increment(self._omega, self.block_size))
        # this rank's row of the decay tables, the halo's carry weights and
        # NCO ramp, on the device once
        r, ti, dev = float(self.r), self.ctx.ti, self.device
        self._coef = torch.from_numpy(_carry_coef_table(r, self.nloc, self.dt, False)[ti]).to(dev)
        self._astep = float(_astep_table(r, self.nloc, self.dt, False)[ti])
        self._tail_coef = torch.from_numpy(_tail_coef(r, self.nloc, self.hs)).to(dev)
        self._tail_ramp = _ramp_on(self._omega, self.nloc, dev)[self.nloc - self.hs:]

    out_layout = CH   # each rank's output is its (nch, F/dt) panel

    def init(self):
        return ff.flagship_fused_init(self.nch, self.device, self.m)

    def rate_tree(self):
        return self.rate

    def flush_len(self) -> int:
        return 0

    def _kernel(self, state, x):
        return ff.flagship_fused_step(state, x, nch=self.nch, m=self.m, as_db=self.as_db,
                                      kf=self.kf, dc_alpha=self.dc_alpha, tileF=self.tileF)

    def step(self, state, x):
        """(state, this rank's segment) → (state, audio (nch, nloc/nch)
        float32 of this segment).  The segment is complex64 (nloc,), cu8 as
        uint8 (nloc, 2) rows or (2·nloc,) interleaved bytes, or a (re, im)
        pair of uint8 (nloc,) planes."""
        if not isinstance(x, (tuple, list)) and x.dtype == torch.uint8 and x.ndim == 2:
            x = x.reshape(-1)   # rows → interleaved bytes, a view
        if self.dt == 1 and not self.force_full:
            return self._kernel(state, x)
        ctx, nloc, hs, W = self.ctx, self.nloc, self.hs, self.W
        r, dev = self.r, self.device

        # the suffix the pre-pass reads: the last W samples and the one before
        tail = _segment_complex(_suffix(x, nloc - W - (W < nloc)))
        # one-sample raw halo: the previous sample for the DC difference
        xprev = ctx.left_halo(tail, state["x_last"].reshape(1), 1)

        # suffix-window zero-carry DC solve
        xw = tail[-W:]
        wprev0 = xprev if W == nloc else tail[:1]
        forcing = np.float32((1.0 + r) / 2.0) * (xw - torch.cat([wprev0, xw[:-1]]))
        w = linrec(forcing, float(r), torch.zeros((), dtype=torch.complex64, device=dev))

        # closed-form incoming DC carry from the gathered end values
        ends = ctx.all_gather_time(w[-1])                                   # (dt,)
        y_in = self._astep * state["y_dc_last"] + (self._coef * ends).sum()

        # the halo: this tail's corrected DC output, NCO-shifted at its global
        # sample indices, shipped right as K1's hist rows
        phase = torch.remainder(state["phase"] + self._phase_off, np.float32(_TWO_PI))
        dc_tail = w[W - hs:] + self._tail_coef * y_in
        theta = phase + self._tail_ramp
        shifted = dc_tail * torch.polar(torch.ones_like(theta), -theta)
        left = ctx.send_right(shifted.reshape(self.L + 1, self.nch))
        hist = state["hist"] if left is None else left

        st = dict(phase=phase, hist=hist, x_last=xprev[0].contiguous(),
                  y_dc_last=y_in.contiguous())
        st2, audio = self._kernel(st, x)

        # the carried state: the last rank's kernel outputs
        new_state = dict(
            phase=torch.remainder(state["phase"] + self._phase_step, np.float32(_TWO_PI)),
            hist=ctx.from_last_time(st2["hist"]),
            x_last=ctx.from_last_time(st2["x_last"]),
            y_dc_last=ctx.from_last_time(st2["y_dc_last"]),
        )
        return new_state, audio
