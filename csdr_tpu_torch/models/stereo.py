"""FM stereo (pilot-tone) decoder.

Counterpart of ``csdr_tpu/models/stereo.py`` (reference stereoFMDecoder:
pilot 19 kHz, pilot FIR half-band 800 Hz of length quad_rate/1350, audio
FIRs 15 kHz, order-2 de-emphasis at 5 kHz, stereo gain 2, group-delay
compensation).  The pilot is isolated by its band-pass, so its analytic
phase is known in closed form and the 38 kHz subcarrier is (pilot/|pilot|)²
for every sample at once; then the matrix L+R ± (L−R), de-emphasis,
decimation.

Input: the FM-demodulated composite (real, quad_rate), as the reference's
DeFMS flow makes it with fmDemodulator 0.8.  Output: (2, n/decim), row 0
left, row 1 right.  One stream (not inside ``PerChannel``).

Time-sharded (``shard_apply``) the same graph runs with its stateful
primitives swapped: the pilot NCO's phase from the float64 per-rank table,
the FIR histories, the group-delay line and the decimators' histories from
the left neighbour, the de-emphasis poles through ``ShardCtx.linrec``.  The
output is a (2, n′) panel on a mesh with one ch rank.

``pll_mode="scan"`` regenerates the subcarrier with the JAX package's
per-sample second-order PLL (``fms_pll_scan``, the reference's liquid
fmsPll) instead, on its own kernel (``ops/cuda/pll_scan.py``, K7); its
carry is the state's ``pll`` leaf.  That mode does not shard.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block
from ..core.sharding import CH
from ..ops import fir as fir_ops
from ..ops import iir as iir_ops
from ..ops import nco as nco_ops
from ..ops.nco import _ramp_on, phase_increment
from ..utils import firdes, iirdes

__all__ = ["StereoFMDecoder", "stereo_fm_decoder", "pilot_subcarrier", "fms_pll_scan"]

_TWO_PI = 2.0 * np.pi
PLL_MODES = ("closed_form", "scan")


def pilot_analytic(omega19: float, gdelay: float, theta0: torch.Tensor, c: torch.Tensor,
                   h_pilot: np.ndarray, pilot_hist: torch.Tensor, fir_fn=fir_ops.fir_stream):
    """The pilot's mix-down (its NCO at ``theta0`` on the block's first
    sample) and low-pass (``fir_fn``) on one block, and its analytic form
    p_a at the group-delayed time base, |p|·e^{j(ω19(n−gd)+θp)}.  Returns
    (new pilot_hist, p_a)."""
    n = c.shape[-1]
    theta = theta0 + _ramp_on(float(omega19), int(n), c.device)
    m19 = c.to(torch.complex64) * torch.polar(torch.ones_like(theta), -theta)
    pilot_hist, pilot_bb = fir_fn(h_pilot, pilot_hist, m19)
    gd_phase = np.float32(np.mod(omega19 * gdelay, _TWO_PI))
    rot = theta - gd_phase
    return pilot_hist, pilot_bb * torch.polar(torch.ones_like(rot), rot)


def pilot_subcarrier(omega19: float, gdelay: float, theta0: torch.Tensor, c: torch.Tensor,
                     h_pilot: np.ndarray, pilot_hist: torch.Tensor, fir_fn=fir_ops.fir_stream):
    """``pilot_analytic``'s phasor normalized, u = p_a/|p_a|: (new
    pilot_hist, u); shared by the stereo and RDS decoders."""
    pilot_hist, p_a = pilot_analytic(omega19, gdelay, theta0, c, h_pilot, pilot_hist, fir_fn)
    return pilot_hist, p_a / (p_a.abs() + 1e-12)


def fms_pll_scan(p_a: torch.Tensor, state, omega: float, bw: float):
    """The reference's per-sample pilot PLL (liquid fmsPll): a second-order
    loop tracking the analytic pilot p_a, with the JAX package's gains
    α = 4·bw, β = 4·bw² in float32.  Returns ((θ, freq), e^{2jθ[n]}), the
    regenerated 38 kHz subcarrier; K7 on the card, its plain loop on the
    CPU."""
    from ..ops.cuda.pll_scan import pll_scan

    return pll_scan(p_a, state, np.float32(omega), np.float32(4.0 * bw),
                    np.float32(4.0 * bw * bw))


def pilot_phases(omega19: float, phase19: torch.Tensor, n: int, ctx=None):
    """(the pilot NCO's phase on this block's first sample, the carried
    phase after the block): serial, or on a time rank of ``ctx``, where
    the block is every rank's n samples and the rank starts at its float64
    offset (``ops/nco.phase_table``), with no collective."""
    two_pi = np.float32(_TWO_PI)
    if ctx is None:
        return phase19, torch.remainder(phase19 + np.float32(phase_increment(omega19, n)),
                                        two_pi)
    off = nco_ops.phase_table(omega19, n, ctx.dt)[ctx.ti]
    inc = np.float32(phase_increment(omega19, n * ctx.dt))
    return torch.remainder(phase19 + off, two_pi), torch.remainder(phase19 + inc, two_pi)


def delay_line(buf: torch.Tensor, x: torch.Tensor):
    """The block delayed by len(buf) samples: (new buf, delayed block)."""
    full = torch.cat([buf, x], dim=-1)
    n = x.shape[-1]
    return full[..., n:].clone(), full[..., :n]


def shard_delay_line(ctx, buf: torch.Tensor, x: torch.Tensor):
    """``delay_line`` on a time rank: the delayed samples from the left
    neighbour's tail, the new buffer the last time rank's."""
    d = buf.shape[-1]
    halo = ctx.left_halo(x, buf, d)
    delayed = torch.cat([halo, x], dim=-1)[..., :x.shape[-1]]
    return ctx.from_last_time(x[..., -d:].contiguous()), delayed


class StereoFMDecoder(Block):
    def __init__(self, quad_rate: float, decim: int, pilot_hz: float = 19000.0,
                 pilot_fir_halfband_hz: float = 800.0, audio_cutoff_hz: float = 15000.0,
                 deemph_order: int = 2, deemph_cutoff_hz: float = 5000.0,
                 stereo_gain: float = 2.0, pll_mode: str = "closed_form"):
        if pll_mode not in PLL_MODES:
            raise ValueError(f"StereoFMDecoder pll_mode={pll_mode!r}: use one of {PLL_MODES}")
        self.quad_rate = quad_rate
        self.decim = decim
        self.omega19 = _TWO_PI * pilot_hz / quad_rate
        nfir = int(round(quad_rate / 1350.0))
        self.h_pilot = firdes.kaiser_lowpass(nfir, pilot_fir_halfband_hz / quad_rate, 60.0)
        self.h_audio = firdes.kaiser_lowpass(nfir, audio_cutoff_hz / quad_rate, 60.0)
        self.gdelay = int(round(firdes.group_delay(self.h_pilot, 100.0 / quad_rate)))
        self.stereo_gain = stereo_gain
        self.pll_mode = pll_mode
        self.pll_bw = 9.0 / quad_rate  # the reference's 9 Hz loop bandwidth
        self.deemph = iirdes.sos_to_onepole(
            iirdes.butter_sos(deemph_order, deemph_cutoff_hz / quad_rate), real_io=True)
        self.h_decim = firdes.firdecim_kaiser(decim, 10, 60.0) if decim > 1 else None
        self.rate = Fraction(1, decim)
        self.granule = decim
        self.name = f"stereo_fm({quad_rate:.0f},{decim})"

    def init(self, device: torch.device):
        z = lambda n, dt: torch.zeros((n,), dtype=dt, device=device)  # noqa: E731
        Ka = len(self.h_audio)
        st = dict(
            phase19=torch.zeros((), dtype=torch.float32, device=device),
            pilot_hist=z(len(self.h_pilot) - 1, torch.complex64),
            delay_buf=z(self.gdelay, torch.float32),
            lpr_hist=z(Ka - 1, torch.float32),
            lmr_hist=z(Ka - 1, torch.complex64),
            deemph_l=iir_ops.onepole_cascade_init(self.deemph, False, device),
            deemph_r=iir_ops.onepole_cascade_init(self.deemph, False, device),
            # the scan PLL's carry (theta, freq); the closed-form path
            # leaves it unchanged
            pll=(torch.zeros((), dtype=torch.float32, device=device),
                 torch.zeros((), dtype=torch.float32, device=device)),
        )
        if self.h_decim is not None:
            st["decim_l"] = z(len(self.h_decim) - 1, torch.float32)
            st["decim_r"] = z(len(self.h_decim) - 1, torch.float32)
        return st

    def flush_len(self) -> int:
        # the group-delay line withholds gdelay composite samples from the
        # audio paths; rounded up to the decimator so the last frame comes out
        return -(-self.gdelay // self.decim) * self.decim

    def apply(self, state, c):
        theta0, new_phase = pilot_phases(self.omega19, state["phase19"], c.shape[-1])

        def decim_fn(hist, x):
            return fir_ops.fir_decim_stream(self.h_decim, self.decim, hist, x)

        return self._process(state, c, theta0, new_phase, fir_ops.fir_stream, delay_line,
                             iir_ops.onepole_cascade_stream, decim_fn)

    def _process(self, state, c, theta0, new_phase, fir_fn, delay_fn, deemph_fn, decim_fn):
        """The decode graph with its stateful primitives injected: ``apply``
        passes the streaming forms, ``shard_apply`` their ``ShardCtx``
        ones; the arithmetic is the same."""
        s = dict(state)
        s["pilot_hist"], p_a = pilot_analytic(self.omega19, self.gdelay, theta0, c,
                                              self.h_pilot, s["pilot_hist"], fir_fn)
        s["phase19"] = new_phase
        if self.pll_mode == "scan":
            s["pll"], sub38 = fms_pll_scan(p_a, s["pll"], self.omega19, self.pll_bw)
        else:
            u = p_a / (p_a.abs() + 1e-12)
            sub38 = u * u  # e^{j(2ω19(n−gd)+2θp)}: the regenerated 38 kHz subcarrier

        # the composite delayed by the pilot filter's group delay
        s["delay_buf"], cd = delay_fn(s["delay_buf"], c)

        # L−R: mix down by the subcarrier, 15 kHz low-pass, × stereo gain
        lmr_in = cd.to(torch.complex64) * sub38.conj()
        s["lmr_hist"], lmr_bb = fir_fn(self.h_audio, s["lmr_hist"], lmr_in)
        lmr = np.float32(self.stereo_gain) * lmr_bb.real
        # L+R: 15 kHz low-pass of the delayed composite
        s["lpr_hist"], lpr = fir_fn(self.h_audio, s["lpr_hist"], cd)

        s["deemph_l"], left = deemph_fn(self.deemph, s["deemph_l"], lpr + lmr)
        s["deemph_r"], right = deemph_fn(self.deemph, s["deemph_r"], lpr - lmr)
        if self.h_decim is not None:
            s["decim_l"], left = decim_fn(s["decim_l"], left)
            s["decim_r"], right = decim_fn(s["decim_r"], right)
        return s, torch.stack([left, right])

    # ---- sharded: time only ---------------------------------------------------
    def shard_apply(self, state, c, ctx):
        nloc = c.shape[-1]
        theta0, new_phase = pilot_phases(self.omega19, state["phase19"], nloc, ctx)

        def dist_linrec(v, a, carry):
            y, _, new_carry = ctx.linrec(v, a, carry)
            return y, new_carry

        def deemph_fn(casc, st, x):
            return iir_ops.onepole_cascade_stream(casc, st, x, linrec_fn=dist_linrec,
                                                  fir_fn=ctx.fir)

        def decim_fn(hist, x):
            h = len(self.h_decim) - 1
            _, y = fir_ops.fir_decim_stream(self.h_decim, self.decim,
                                            ctx.left_halo(x, hist, h), x)
            return ctx.from_last_time(x[..., -h:].contiguous()), y

        return self._process(state, c, theta0, new_phase, ctx.fir,
                             lambda buf, x: shard_delay_line(ctx, buf, x), deemph_fn, decim_fn)

    def shard_validate(self, nloc, ctx):
        if self.pll_mode == "scan":
            raise NotImplementedError(
                f"{self.name}: pll_mode='scan' is a per-sample feedback loop and cannot be "
                f"time-sharded; use the closed-form default")
        if ctx.dc != 1:
            raise ValueError(f"{self.name}: stereo output (2, n) shards over time only: use a "
                             f"mesh with ch=1")
        halo = max(len(self.h_pilot) - 1, len(self.h_audio) - 1, self.gdelay,
                   len(self.h_decim) - 1 if self.h_decim is not None else 0)
        if nloc < halo:
            raise ValueError(f"{self.name}: local segment {nloc} shorter than the largest "
                             f"halo {halo}: use a larger block or fewer time shards")
        if nloc % self.decim:
            raise ValueError(f"{self.name}: local segment {nloc} not a multiple of decim "
                             f"{self.decim}")
        return nloc // self.decim

    def shard_layout(self, in_layout):
        return CH  # the (2, n′) panel, gathered over the time ranks


def stereo_fm_decoder(quad_rate: float, decim: int, **kw) -> Block:
    return StereoFMDecoder(quad_rate, decim, **kw)
