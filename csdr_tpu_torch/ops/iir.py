"""IIR filters as parallel one-pole recurrences, and the DC blocker.

Counterpart of ``csdr_tpu/ops/iir.py``, solved with the blocked recurrence
in ``ops/linrec.py``.  An IIR prototype is decomposed
(``utils/iirdes.sos_to_onepole``) into stages of a 3-tap FIR numerator and
one or two one-pole partial fractions, each solved over the whole block at
once.  Everything works along the last axis: inside ``PerChannel`` a
(nch, n) panel filters every row, and the state gains a leading channel
axis.

The DC blocker is y[n] = r·y[n−1] + g·(x[n] − x[n−1]), r = 1−α, g = (1+r)/2.

Sharded over time, the cascade takes the distributed FIR history and pole
carries (``linrec_fn``/``fir_fn``, ``core/sharding.ShardCtx``) and
``dc_blocker_shard_stream`` the left neighbour's last input and the
distributed recurrence.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.iirdes import OnePoleCascade
from .fir import fir_stream
from .linrec import linrec

__all__ = ["onepole_cascade_init", "onepole_cascade_stream", "dc_blocker_init",
           "dc_blocker_stream", "dc_blocker_shard_stream"]


def onepole_cascade_init(casc: OnePoleCascade, complex_input: bool, device: torch.device):
    """Per stage (FIR history (2,) of the input's dtype, pole carries (2,)
    complex64), zeros."""
    xdt = torch.complex64 if complex_input else torch.float32
    return tuple((torch.zeros((2,), dtype=xdt, device=device),
                  torch.zeros((2,), dtype=torch.complex64, device=device))
                 for _ in range(casc.poles.shape[0]))


def _local_linrec(v: torch.Tensor, a, carry: torch.Tensor):
    u = linrec(v, a, carry)
    return u, u[..., -1]


def onepole_cascade_stream(casc: OnePoleCascade, state, x: torch.Tensor,
                           linrec_fn=None, fir_fn=None):
    """Apply the cascade to one block; returns (new_state, y).  Real input
    evaluates a conjugate pole pair as y = 2·Re(r·u) and carries the
    conjugate; two distinct real poles (odd-order band-pass sections) run as
    two real recurrences; complex input evaluates both poles.

    ``linrec_fn(v, a, carry) -> (u, end carry)`` and ``fir_fn(taps, hist,
    x) -> (new_hist, v)`` default to the single-device solve and
    ``fir_stream``; the sharded IIR block passes the distributed ones, so
    both run the same cascade algebra."""
    linrec_fn = linrec_fn or _local_linrec
    fir_fn = fir_fn or fir_stream
    c64 = torch.complex64
    complex_input = x.is_complex()
    new_state = []
    for s in range(casc.poles.shape[0]):
        fir_hist, carries = state[s]
        p0, p1 = casc.poles[s]
        r0, r1 = casc.residues[s]
        c0, c1 = carries[..., 0], carries[..., 1]
        fir_hist, v = fir_fn(casc.fir[s], fir_hist, x)
        if p1 == 0.0:
            if p0 == 0.0:  # no pole: the numerator alone
                y = v * (complex(np.complex64(r0)) if complex_input
                         else float(np.float32(r0.real)))
                new_carries = carries
            else:  # one real or complex pole
                cplx_pole = abs(p0.imag) > 0
                u, e = linrec_fn(v, complex(p0) if cplx_pole else float(p0.real), c0)
                y = u * (complex(np.complex64(r0)) if complex_input or cplx_pole
                         else float(np.float32(r0.real)))
                if y.is_complex() and not complex_input:
                    y = y.real
                new_carries = torch.stack([e.to(c64), c1], dim=-1)
        elif complex_input:
            u0, e0 = linrec_fn(v, complex(p0), c0)
            u1, e1 = linrec_fn(v, complex(p1), c1)
            y = complex(np.complex64(r0)) * u0 + complex(np.complex64(r1)) * u1
            new_carries = torch.stack([e0.to(c64), e1.to(c64)], dim=-1)
        elif abs(np.conj(p0) - p1) < 1e-9 and abs(p0.imag) > 0:
            # a conjugate pair on real input: y = 2·Re(r0·u0)
            u0, e0 = linrec_fn(v.to(c64), complex(p0), c0)
            y = 2.0 * (complex(np.complex64(r0)) * u0).real
            new_carries = torch.stack([e0.to(c64), e0.to(c64).conj()], dim=-1)
        else:
            # two distinct real poles in one section (scipy pairs real poles,
            # e.g. in odd-order band-pass designs)
            u0, e0 = linrec_fn(v, float(p0.real), c0.real)
            u1, e1 = linrec_fn(v, float(p1.real), c1.real)
            y = float(np.float32(r0.real)) * u0 + float(np.float32(r1.real)) * u1
            new_carries = torch.stack([e0.to(c64), e1.to(c64)], dim=-1)
        new_state.append((fir_hist, new_carries))
        x = y.to(torch.complex64 if complex_input else torch.float32)
    return tuple(new_state), x


def dc_blocker_init(device: torch.device, complex_input: bool = True):
    """(previous input sample, previous output sample), each shaped (1,)."""
    dt = torch.complex64 if complex_input else torch.float32
    return (torch.zeros((1,), dtype=dt, device=device),
            torch.zeros((1,), dtype=dt, device=device))


def dc_blocker_stream(state, x: torch.Tensor, alpha: float = 0.0005):
    """One block of the reference's head-of-chain dc_blocker(0.0005)."""
    x_prev_last, y_last = state
    r = 1.0 - alpha
    g = np.float32((1.0 + r) / 2.0)
    prev = torch.cat([x_prev_last, x[:-1]])
    forcing = g * (x - prev)
    y = linrec(forcing, float(r), y_last[0])
    return (x[-1:], y[-1:]), y


def dc_blocker_shard_stream(state, x: torch.Tensor, ctx, alpha: float = 0.0005):
    """The DC blocker on this rank's time segment: the previous input from
    the left neighbour (a one-sample halo), the output recurrence across
    the ranks (``ShardCtx.linrec``)."""
    x_prev_last, y_last = state
    r = 1.0 - alpha
    g = np.float32((1.0 + r) / 2.0)
    prev = torch.cat([ctx.left_halo(x, x_prev_last, 1), x[:-1]])
    forcing = g * (x - prev)
    y, _, y_end = ctx.linrec(forcing, float(r), y_last[0])
    return (ctx.from_last_time(x[-1:].contiguous()), y_end.reshape(1)), y
