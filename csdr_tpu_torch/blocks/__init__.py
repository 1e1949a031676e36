"""DSP blocks — counterparts of the blocks of the same names in
``csdr_tpu/blocks/__init__.py``.

Reference export          → here
------------------------------------------------------------------
resampler r as            → resampler(rate, as_db)
mixUp f / mixDown f       → mix_up(f) / mix_down(f)
fmDemodulator kf          → fm_demodulator(kf)
amDemodulator             → am_demodulator()
fskDemodulator m k bw     → fsk_demodulator(m_bits, k, bandwidth)
firDecimator m            → fir_decimator(m)
firFilterRNyquist k m b   → fir_filter_rnyquist(k, m, beta, mu)
realToComplex             → real_to_complex()
complexToReal             → complex_to_real()
automaticGainControl t    → automatic_gain_control(t)
dcBlocker                 → dc_blocker()
firpfbchChannelizer n     → firpfbch_channelizer(nch)
firFilterCKaiser n fc ... → fir_filter_c_kaiser(n, fc, as_db, mu)
iirFilter / iirCFilter    → iir_filter / iir_cfilter(order, fc, f0, ap, as_db, ftype)
wbFMDemodulator q d       → wbfm_demodulator(quad_rate, decim)
(explicit taps)           → fir_filter(taps, complex_input, strategy=…)
(extensions)              → ssb_demodulator(side, bw), cw_demodulator(bw, pitch),
                            fir_interpolator(p)
(cu8 capture input)       → u8_to_iq()

Every block works along the last axis, so inside ``PerChannel`` a
(nch, n) panel runs every channel at once and the state gains a leading
channel axis.

Sharded over time (``parallel/generic.ShardedChain``): the stateless blocks
as they are; ``Mixer`` from its float64 per-rank phase offset, with no
collective; ``DCBlocker``, ``IIRFilter`` and ``AGC`` on the distributed
recurrence (``ShardCtx.linrec``); the FIR family, the resamplers, the
Hilbert blocks and ``FMDemod`` through ``TailStateBlock``'s left halo;
``PFBChannelizer`` turns the stream into the channel layout, each rank
holding its (nch/dc, F/dt) panel.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Lambda, TailStateBlock, chain
from ..core.sharding import CH, TIME
from ..ops import agc as agc_ops
from ..ops import demod as demod_ops
from ..ops import fir as fir_ops
from ..ops import hilbert as hilbert_ops
from ..ops import iir as iir_ops
from ..ops import nco as nco_ops
from ..ops import pfb as pfb_ops
from ..ops import resamp as resamp_ops
from ..utils import firdes, iirdes

__all__ = ["u8_to_iq", "mix_up", "mix_down", "fm_demodulator", "am_demodulator",
           "ssb_demodulator", "cw_demodulator", "fir_filter", "fir_filter_c_kaiser",
           "fir_filter_rnyquist", "fir_decimator", "fir_interpolator", "dc_blocker", "firpfbch_channelizer", "automatic_gain_control",
           "resampler", "iir_filter", "iir_cfilter", "wbfm_demodulator", "fsk_demodulator",
           "real_to_complex", "complex_to_real",
           "U8ToIQ", "Mixer", "FMDemod", "AMDemod", "FSKDemod", "FIRFilter", "FIRDecim",
           "FIRInterp", "DCBlocker", "IIRFilter", "PFBChannelizer", "AGC", "HalfbandDecim",
           "RationalResampler", "RealToComplex", "ComplexToReal"]

_TWO_PI = 2.0 * np.pi


class U8ToIQ(Block):
    """rtl_sdr cu8 capture → complex64, on the device, so the host→device
    copy carries 2 bytes per sample instead of 8.  The port's cu8 stream is
    (n, 2) uint8 rows, one row per IQ sample, so this block is 1:1 in
    samples (the JAX package's ``u8_to_iq`` takes the flat (2n,) bytes)."""

    name = "u8_to_iq"
    stateless = True

    def apply(self, state, x):
        f = (x.to(torch.float32) - 127.5) * np.float32(1.0 / 127.5)
        return state, torch.complex(f[:, 0], f[:, 1])


def u8_to_iq() -> Block:
    return U8ToIQ()


class Mixer(Block):
    """NCO frequency shift (reference mixUp/mixDown); ``omega`` in
    radians/sample.  State: the phase, float32."""

    def __init__(self, omega: float, up: bool):
        self.omega = float(omega)
        self.up = up
        self.name = f"mix_{'up' if up else 'down'}({omega:.6g})"

    def init(self, device: torch.device):
        return torch.zeros((), dtype=torch.float32, device=device)

    def apply(self, state, x):
        return nco_ops.mix_stream(state, x, self.omega, self.up)

    def shard_apply(self, state, x, ctx):
        """The phase is affine in the global sample index: each time rank
        starts at the carried phase plus its float64 offset, with no
        collective."""
        nloc = x.shape[-1]
        off = nco_ops.phase_table(self.omega, nloc, ctx.dt)[ctx.ti]
        local = torch.remainder(state + off, np.float32(_TWO_PI))
        _, y = nco_ops.mix_stream(local, x, self.omega, self.up)
        inc = np.float32(nco_ops.phase_increment(self.omega, nloc * ctx.dt))
        return torch.remainder(state + inc, np.float32(_TWO_PI)), y

    def shard_validate(self, nloc, ctx):
        return nloc


def mix_up(omega: float) -> Block:
    return Mixer(omega, up=True)


def mix_down(omega: float) -> Block:
    return Mixer(omega, up=False)


class FMDemod(TailStateBlock):
    """FM demodulator (reference fmDemodulator).  State = previous input
    sample."""

    tail_len = 1
    fuse_zero_tail = False  # its init is a unit sample, not zero

    def __init__(self, kf: float):
        self.kf = float(kf)
        self.name = f"fm_demod({kf})"

    def init(self, device: torch.device):
        # previous sample of unit magnitude and zero phase, not zero
        return torch.ones((1,), dtype=torch.complex64, device=device)

    def apply(self, state, x):
        return demod_ops.freqdem_stream(state, x, self.kf)


def fm_demodulator(kf: float) -> Block:
    return FMDemod(kf)


class AMDemod(Block):
    """AM envelope demodulator, mod index 0.8, DSB, carrier present
    (reference amDemodulator)."""

    stateless = True

    def __init__(self, mod_index: float = 0.8, suppressed: bool = False):
        self.mod_index = mod_index
        self.suppressed = suppressed
        self.name = "am_demod"

    def apply(self, state, x):
        return state, demod_ops.amdem(x, self.mod_index, self.suppressed)


def am_demodulator(mod_index: float = 0.8, suppressed: bool = False) -> Block:
    return AMDemod(mod_index, suppressed)


class FSKDemod(Block):
    """M-FSK demodulator (reference fskDemodulator): k input samples → one
    uint32 symbol."""

    stateless = True

    def __init__(self, m_bits: int, k: int, bandwidth: float):
        self.m_bits, self.k, self.bandwidth = m_bits, k, bandwidth
        self.rate = Fraction(1, k)
        self.granule = k
        self.name = f"fsk_demod(m={m_bits},k={k})"

    def apply(self, state, x):
        return state, demod_ops.fskdem_block(x, self.m_bits, self.k, self.bandwidth)


def fsk_demodulator(m_bits: int, k: int, bandwidth: float) -> Block:
    return FSKDemod(m_bits, k, bandwidth)


def _real_part(name: str = "re") -> Block:
    # a view of the complex block's storage; sinks and kernels want it dense
    return Lambda(lambda x: x.real.contiguous(), name=name)


def ssb_demodulator(side: str = "usb", bandwidth: float = 0.0125, as_db: float = 60.0,
                    gain: float = 2.0, n: int | None = None) -> Block:
    """Single-sideband demodulator: a one-sided complex band-pass (Kaiser
    low-pass of cutoff B/2 shifted by ±B/2) and the real part; ``gain=2``
    undoes the ½ of Re[A·e^{jωt}].  ``bandwidth`` is B normalized to the
    sample rate."""
    side = side.lower()
    if side not in ("usb", "lsb"):
        raise ValueError(f"ssb_demodulator side must be 'usb'/'lsb', got {side!r}")
    if not (0.0 < bandwidth < 0.5):
        raise ValueError(f"ssb bandwidth {bandwidth} not in (0, 0.5) of fs")
    if n is None:
        n = firdes.kaiser_filter_len(max(0.1 * bandwidth, 0.002), as_db)
    h = firdes.kaiser_lowpass(n, bandwidth / 2.0, as_db) * gain
    shift = bandwidth / 2.0 if side == "usb" else -bandwidth / 2.0
    k = np.arange(n) - (n - 1) / 2.0
    taps = (h * np.exp(2j * np.pi * shift * k)).astype(np.complex64)
    bp = FIRFilter(taps, complex_input=True, name=f"ssb_{side}({bandwidth:.4g})")
    return chain(bp, _real_part())


def cw_demodulator(bandwidth: float = 0.002, pitch: float = 0.0029, as_db: float = 60.0) -> Block:
    """CW (Morse) demodulator: a narrow Kaiser low-pass (±bandwidth/2) around
    the carrier at DC, a BFO shift to the audible ``pitch``, and the real
    part; both normalized to the sample rate."""
    if not (0.0 < bandwidth < 0.5):
        raise ValueError(f"cw bandwidth {bandwidth} not in (0, 0.5) of fs")
    n = firdes.kaiser_filter_len(max(0.5 * bandwidth, 0.001), as_db)
    lp = FIRFilter(firdes.kaiser_lowpass(n, bandwidth / 2.0, as_db),
                   complex_input=True, name=f"cw_lp({bandwidth:.4g})")
    return chain(lp, mix_up(_TWO_PI * pitch), _real_part())


class FIRFilter(TailStateBlock):
    """Same-rate streaming FIR from an explicit tap vector; ``strategy`` is
    ``ops/fir.conv_valid``'s."""

    def __init__(self, taps: np.ndarray, complex_input: bool, name: str = "fir",
                 scale: float = 1.0, strategy: str = "auto"):
        self.taps = np.asarray(taps) * scale
        self.tail_len = len(self.taps) - 1
        self.complex_input = complex_input
        self.strategy = strategy
        self.name = name

    def init(self, device: torch.device):
        cplx = self.complex_input or np.iscomplexobj(self.taps)
        return torch.zeros((len(self.taps) - 1,),
                           dtype=torch.complex64 if cplx else torch.float32, device=device)

    def apply(self, state, x):
        return fir_ops.fir_stream(self.taps, state, x, self.strategy)


def fir_filter(taps, complex_input=True, **kw) -> FIRFilter:
    return FIRFilter(taps, complex_input, **kw)


def fir_filter_c_kaiser(n: int, fc: float, as_db: float = 60.0, mu: float = 0.0) -> FIRFilter:
    """Complex FIR, Kaiser design, unity passband (reference firFilterCKaiser)."""
    taps = firdes.kaiser_lowpass(n, fc, as_db, mu)
    return FIRFilter(taps, complex_input=True, name=f"fir_kaiser({n},{fc:.4g})")


def fir_filter_rnyquist(k: int, m: int, beta: float, mu: float = 0.0) -> FIRFilter:
    """Real GMSK receive matched filter (reference firFilterRNyquist): the
    ``gmsk_rx`` design (unity tx·rx cascade gain at the symbol instant),
    delayed by the fractional sample ``mu``."""
    taps = firdes.fractional_delay(firdes.gmsk_rx(k, m, max(beta, 0.1)), mu, extend=True)
    return FIRFilter(taps, complex_input=False, name=f"fir_gmskrx(k={k},m={m})")


class FIRDecim(TailStateBlock):
    """Kaiser decimating FIR (reference firDecimator: semi-length 10, 60 dB)."""

    def __init__(self, m: int, semilen: int = 10, as_db: float = 60.0,
                 complex_input: bool = False):
        self.m = m
        self.taps = firdes.firdecim_kaiser(m, semilen, as_db)
        self.tail_len = len(self.taps) - 1
        self.complex_input = complex_input
        self.rate = Fraction(1, m)
        self.granule = m
        self.name = f"fir_decim({m})"

    def init(self, device: torch.device):
        dt = torch.complex64 if self.complex_input else torch.float32
        return torch.zeros((len(self.taps) - 1,), dtype=dt, device=device)

    def apply(self, state, x):
        return fir_ops.fir_decim_stream(self.taps, self.m, state, x)


def fir_decimator(m: int, **kw) -> Block:
    if m == 1:
        return Lambda(lambda x: x, name="fir_decim(1)")
    return FIRDecim(m, **kw)


class FIRInterp(TailStateBlock):
    """Kaiser interpolating FIR: zero-stuff by p and filter with the
    decimator's design scaled by p.  State: the last ⌈K/p⌉ − 1 inputs."""

    def __init__(self, p: int, semilen: int = 10, as_db: float = 60.0,
                 complex_input: bool = True):
        self.p = p
        self.taps = firdes.firdecim_kaiser(p, semilen, as_db) * p
        self.tail_len = -(-len(self.taps) // p) - 1
        self.complex_input = complex_input
        self.rate = Fraction(p, 1)
        self.name = f"fir_interp({p})"

    def init(self, device: torch.device):
        dt = torch.complex64 if self.complex_input else torch.float32
        return torch.zeros((self.tail_len,), dtype=dt, device=device)

    def apply(self, state, x):
        return fir_ops.fir_interp_stream(self.taps, self.p, state, x)


def fir_interpolator(p: int, **kw) -> Block:
    return FIRInterp(p, **kw)


class DCBlocker(Block):
    """IQ DC notch (reference dcBlocker, α = 0.0005)."""

    def __init__(self, alpha: float = 0.0005, complex_input: bool = True):
        self.alpha = alpha
        self.complex_input = complex_input
        self.name = "dc_blocker"

    def init(self, device: torch.device):
        return iir_ops.dc_blocker_init(device, self.complex_input)

    def apply(self, state, x):
        return iir_ops.dc_blocker_stream(state, x, self.alpha)

    def shard_apply(self, state, x, ctx):
        return iir_ops.dc_blocker_shard_stream(state, x, ctx, self.alpha)

    def shard_validate(self, nloc, ctx):
        return nloc


def dc_blocker(alpha: float = 0.0005, complex_input: bool = True) -> Block:
    return DCBlocker(alpha, complex_input)


class IIRFilter(Block):
    """IIR prototype filter (reference iirFilter/iirCFilter): ``ftype``
    selects butter/cheby1/cheby2/ellip/bessel, ``f0`` ≠ 0 a band-pass
    centred there, ``ap``/``as_db`` the ripple and attenuation where the
    family uses them.  Runs as parallel one-pole partial fractions
    (``ops/iir.py``)."""

    def __init__(self, order: int, fc: float, complex_input: bool,
                 ftype: str = "butter", f0: float = 0.0, ap: float = 1.0,
                 as_db: float = 40.0):
        self.order, self.fc = order, fc
        self.complex_input = complex_input
        sos = iirdes.prototype_sos(ftype, order, fc, f0, ap, as_db)
        self.casc = iirdes.sos_to_onepole(sos, not complex_input)
        self.name = f"iir_{ftype}({order},{fc:.4g}" + (f",f0={f0:.4g})" if f0 else ")")

    def init(self, device: torch.device):
        return iir_ops.onepole_cascade_init(self.casc, self.complex_input, device)

    def apply(self, state, x):
        return iir_ops.onepole_cascade_stream(self.casc, state, x)

    def shard_apply(self, state, x, ctx):
        """The same cascade with the distributed FIR history and pole
        carries injected."""
        def dist_linrec(v, a, c):
            y, _, new_carry = ctx.linrec(v, a, c)
            return y, new_carry

        return iir_ops.onepole_cascade_stream(self.casc, state, x, linrec_fn=dist_linrec,
                                              fir_fn=ctx.fir)

    def shard_validate(self, nloc, ctx):
        if nloc < 2:
            raise ValueError(f"{self.name}: local segment too short")
        return nloc


def iir_filter(order: int, fc: float, f0: float = 0.0, ap: float = 10.0,
               as_db: float = 10.0, ftype: str = "butter") -> Block:
    """Real IIR (reference iirFilter); Butterworth ignores ap/as_db."""
    return IIRFilter(order, fc, complex_input=False, ftype=ftype, f0=f0, ap=ap, as_db=as_db)


def iir_cfilter(order: int, fc: float, f0: float = 0.0, ap: float = 10.0,
                as_db: float = 10.0, ftype: str = "butter") -> Block:
    """Complex IIR (reference iirCFilter)."""
    return IIRFilter(order, fc, complex_input=True, ftype=ftype, f0=f0, ap=ap, as_db=as_db)


class PFBChannelizer(Block):
    """Polyphase filterbank channelizer with the reference's NCO pre-shift:
    (n,) complex → (nch, n/nch); channel k centred at 2π(k − (nch−1)/2)/nch."""

    def __init__(self, nch: int, m: int = 7, as_db: float = 80.0):
        self.nch, self.m, self.as_db = nch, m, as_db
        self.rate = Fraction(1, nch)
        self.granule = nch
        self.name = f"pfb_channelizer({nch})"

    def init(self, device: torch.device):
        return (torch.zeros((), dtype=torch.float32, device=device),
                pfb_ops.pfb_analyze_init(self.nch, device, self.m))

    def apply(self, state, x):
        phase, pfb_state = state
        phase, shifted = nco_ops.mix_stream(phase, x, pfb_ops.pfb_offset(self.nch), up=False)
        pfb_state, y = pfb_ops.pfb_analyze_stream(pfb_state, shifted, self.nch, self.m,
                                                  self.as_db)
        return (phase, pfb_state), y

    def shard_apply(self, state, x, ctx):
        """Time-sharded channelizer with a channel-sharded output: the NCO
        pre-shift from the rank's float64 phase offset (no collective), the
        polyphase history as one raw-sample halo of L·nch − 1 from the left
        neighbour, and the DFT on this rank's columns of W only, so the
        (nch/dc, F) panel lands on its (ch, time) rank with no further
        exchange.  The carried (hist_x, hist_v) is a function of the last
        L·nch − 1 shifted samples: one broadcast from the last time rank
        carries both."""
        phase, (hist_x, hist_v) = state
        nch, L = self.nch, 2 * self.m
        nloc = x.shape[-1]
        omega = pfb_ops.pfb_offset(nch)
        off = nco_ops.phase_table(omega, nloc, ctx.dt)[ctx.ti]
        _, xs = nco_ops.mix_stream(torch.remainder(phase + off, np.float32(_TWO_PI)), x, omega,
                                   up=False)
        inc = np.float32(nco_ops.phase_increment(omega, nloc * ctx.dt))
        new_phase = torch.remainder(phase + inc, np.float32(_TWO_PI))

        H = L * nch - 1
        carried = torch.cat([hist_v.flip(1).reshape(-1), hist_x])
        halo = ctx.left_halo(xs, carried, H)
        _, vfull = pfb_ops.halo_panels(halo, xs, nch)                # (L − 1 + F, nch)
        taps, W = pfb_ops.pfb_design(nch, self.m, float(self.as_db), x.device)
        cols = nch // ctx.dc
        d = pfb_ops.branch_dft(vfull, taps, W[:, ctx.ci * cols:(ctx.ci + 1) * cols])

        tail = ctx.from_last_time(xs[-H:].contiguous())
        hist_v = tail[:(L - 1) * nch].reshape(L - 1, nch).flip(1)
        return (new_phase, (tail[(L - 1) * nch:], hist_v)), d

    def shard_validate(self, nloc, ctx):
        if ctx.layout != TIME:
            raise ValueError(f"{self.name}: channelizer input must be a 1-D time-sharded "
                             f"stream")
        if nloc % self.nch:
            raise ValueError(f"{self.name}: local segment {nloc} not a multiple of "
                             f"nch={self.nch}")
        H = 2 * self.m * self.nch - 1
        if nloc < H:
            raise ValueError(f"{self.name}: local segment {nloc} shorter than the "
                             f"{H}-sample polyphase halo")
        if self.nch % ctx.dc:
            raise ValueError(f"{self.name}: nch={self.nch} not divisible by the "
                             f"{ctx.dc}-way channel mesh axis")
        return nloc // self.nch

    def shard_layout(self, in_layout):
        return CH


def firpfbch_channelizer(nch: int, **kw) -> Block:
    return PFBChannelizer(nch, **kw)


class AGC(Block):
    """AGC with squelch (reference automaticGainControl: bandwidth 0.1,
    signal level 1e-3).  State (ln_gain, prev_above); inside ``PerChannel``
    both gain a leading channel axis."""

    def __init__(self, squelch_threshold_db: float | None, bandwidth: float = 0.1,
                 signal_level: float = 1e-3):
        self.squelch_threshold_db = squelch_threshold_db
        self.bandwidth = bandwidth
        self.signal_level = signal_level
        self.name = f"agc({squelch_threshold_db})"

    def init(self, device: torch.device):
        return agc_ops.agc_init(device, self.signal_level)

    def apply(self, state, x):
        return agc_ops.agc_stream(state, x, self.bandwidth, self.squelch_threshold_db)

    def shard_apply(self, state, x, ctx):
        return agc_ops.agc_shard_stream(state, x, ctx, self.bandwidth,
                                        self.squelch_threshold_db)

    def shard_validate(self, nloc, ctx):
        return nloc


def automatic_gain_control(threshold_db: float) -> Block:
    return AGC(threshold_db)


class RationalResampler(TailStateBlock):
    """Polyphase P/Q resampler; its state is the (L−1)-sample input tail."""

    def __init__(self, P: int, Q: int, as_db: float = 60.0, complex_input: bool = True):
        self.P, self.Q, self.as_db = P, Q, as_db
        self.tail_len = resamp_ops.rational_taps(P, Q, as_db).shape[1] - 1
        self.complex_input = complex_input
        self.rate = Fraction(P, Q)
        self.granule = Q
        self.name = f"resamp({P}/{Q})"

    def init(self, device: torch.device):
        dt = torch.complex64 if self.complex_input else torch.float32
        return resamp_ops.rational_resample_init(self.P, self.Q, device, self.as_db, dt)

    def apply(self, state, x):
        return resamp_ops.rational_resample_stream(state, x, self.P, self.Q, self.as_db)


class HalfbandDecim(TailStateBlock):
    """2:1 half-band decimator, one stage of the multi-stage resampler."""

    rate = Fraction(1, 2)
    granule = 2

    def __init__(self, as_db: float = 60.0, semilen: int = 12, complex_input: bool = True):
        self.taps = firdes.halfband_kaiser(semilen, as_db) * 2.0
        self.tail_len = len(self.taps) - 1
        self.complex_input = complex_input
        self.name = "halfband_decim"

    def init(self, device: torch.device):
        dt = torch.complex64 if self.complex_input else torch.float32
        return torch.zeros((len(self.taps) - 1,), dtype=dt, device=device)

    def apply(self, state, x):
        return fir_ops.fir_decim_stream(self.taps, 2, state, x)


class RealToComplex(TailStateBlock):
    """Real → IQ, Hilbert 2:1 (reference realToComplex); the output is
    centred at π."""

    rate = Fraction(1, 2)
    granule = 2
    name = "real_to_complex"
    tail_len = len(hilbert_ops.hilbert_taps()) - 1

    def init(self, device: torch.device):
        return hilbert_ops.real_to_complex_init(device)

    def apply(self, state, x):
        return hilbert_ops.real_to_complex_stream(state, x)


class ComplexToReal(TailStateBlock):
    """IQ → real, Hilbert 1:2 (reference complexToReal)."""

    rate = Fraction(2, 1)
    name = "complex_to_real"
    tail_len = -(-len(hilbert_ops.hilbert_taps()) // 2) - 1

    def init(self, device: torch.device):
        return hilbert_ops.complex_to_real_init(device)

    def apply(self, state, x):
        return hilbert_ops.complex_to_real_stream(state, x)


def real_to_complex() -> Block:
    return RealToComplex()


def complex_to_real() -> Block:
    return ComplexToReal()


def resampler(rate: float, as_db: float = 60.0, complex_input: bool = True) -> Block:
    """Arbitrary-rate resampler (reference ``resampler r as``): half-band 2:1
    stages bring the remaining ratio into (0.5, 1], a rational polyphase
    stage finishes; the rate is realized exactly as a rational."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    stages: list[Block] = []
    r = float(rate)
    while r <= 0.5:
        stages.append(HalfbandDecim(as_db, complex_input=complex_input))
        r *= 2.0
    frac = resamp_ops.rational_approx(r)
    if frac != 1:
        stages.append(RationalResampler(frac.numerator, frac.denominator, as_db, complex_input))
    if not stages:
        return Lambda(lambda x: x, name="resamp(1)")
    return chain(*stages) if len(stages) > 1 else stages[0]


def wbfm_demodulator(quad_rate: float, decim: int) -> Block:
    """Wideband FM (reference wbFMDemodulator): FM demod (kf 0.6) → order-2
    Butterworth de-emphasis at 5 kHz/quad_rate → Kaiser decimator."""
    deemph = iir_filter(2, 5000.0 / quad_rate)
    return chain(fm_demodulator(0.6), deemph, fir_decimator(decim))
