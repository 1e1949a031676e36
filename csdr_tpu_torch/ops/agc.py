"""Automatic gain control with squelch.

Counterpart of ``csdr_tpu/ops/agc.py`` (``agc_init``, ``agc_stream``):
liquid's agc_crcf as the reference CLI drives it (bandwidth 0.1, signal
level 1e-3), with no per-sample loop:

  * the log-domain gain recurrence
        ln g[n+1] = (1−α)·ln g[n] − (α/2)·ln(|x[n]|² + ε)
    is a first-order linear recurrence, solved by ``ops/linrec.py``;
  * rssi[n] = −20·log10(g[n]);
  * a sample passes the squelch only when its rssi and its predecessor's
    are both above the threshold (the reference passes only steady
    SIGNALHI samples).

Works along the last axis: a (nch, n) channel panel with (nch,) states
runs every channel at once (``core/block.PerChannel``).
``agc_shard_stream`` runs it on a rank's time segment: the log-gain
recurrence across the ranks (``ShardCtx.linrec``), the squelch's previous
decision from the left neighbour.
"""

from __future__ import annotations

import numpy as np
import torch

from .linrec import linrec

__all__ = ["agc_init", "agc_stream", "agc_shard_stream"]

_LN10_OVER_20 = np.log(10.0) / 20.0


def agc_init(device: torch.device, signal_level: float = 1e-3):
    """Carried state (ln_gain float32, prev_above bool), gain initialised to
    1/level as liquid's agc_crcf_set_signal_level does."""
    return (torch.tensor(np.float32(np.log(1.0 / signal_level)), device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def agc_stream(state, x: torch.Tensor, bandwidth: float = 0.1,
               squelch_threshold_db: float | None = None):
    """One block of AGC along the last axis; returns (new_state, y).

    ``squelch_threshold_db=None`` disables the squelch (nothing is zeroed)."""
    ln_g, prev_above = state
    alpha = float(bandwidth)
    e2 = x.abs() ** 2
    b = np.float32(-0.5 * alpha) * torch.log(e2 + np.float32(1e-30))
    ln_g_next = linrec(b.to(torch.float32), 1.0 - alpha, ln_g)     # ln g[n+1]
    ln_gains = torch.cat([ln_g[..., None], ln_g_next[..., :-1]], dim=-1)  # applied at n
    y = x * torch.exp(ln_gains)

    if squelch_threshold_db is not None:
        rssi = -ln_gains / np.float32(_LN10_OVER_20)
        above = rssi > np.float32(squelch_threshold_db)
        above_prev = torch.cat([prev_above[..., None], above[..., :-1]], dim=-1)
        y = torch.where(above & above_prev, y, torch.zeros((), dtype=y.dtype, device=y.device))
        new_prev = above[..., -1]
    else:
        new_prev = prev_above
    return (ln_g_next[..., -1], new_prev), y


def agc_shard_stream(state, x: torch.Tensor, ctx, bandwidth: float = 0.1,
                     squelch_threshold_db: float | None = None, carried=None):
    """``agc_stream`` on this rank's time segment, along the last axis.

    The incoming carry of the distributed recurrence is the gain applied at
    the segment's first sample; the squelch's previous ``above`` crosses
    from the left neighbour as a one-sample halo.  ``carried(v)`` makes a
    carried leaf from this rank's end values ``v``; by default the last
    time rank's (``ctx.from_last_time``).  ``ShardedChannelizedFM`` passes
    its gather of the channel rows."""
    ln_g, prev_above = state
    alpha = float(bandwidth)
    b = np.float32(-0.5 * alpha) * torch.log(x.abs() ** 2 + np.float32(1e-30))
    ln_g_next, ln_g_in, new_ln_g = ctx.linrec(b.to(torch.float32), 1.0 - alpha, ln_g)
    ln_gains = torch.cat([ln_g_in[..., None], ln_g_next[..., :-1]], dim=-1)  # applied at n
    y = x * torch.exp(ln_gains)
    if carried is None:
        carried = ctx.from_last_time
    else:
        new_ln_g = carried(ln_g_next[..., -1])
    if squelch_threshold_db is None:
        return (new_ln_g, prev_above), y
    above = -ln_gains / np.float32(_LN10_OVER_20) > np.float32(squelch_threshold_db)
    left = ctx.send_right(above[..., -1].contiguous())
    above_prev = torch.cat([(prev_above if left is None else left)[..., None],
                            above[..., :-1]], dim=-1)
    y = torch.where(above & above_prev, y, torch.zeros((), dtype=y.dtype, device=y.device))
    return (new_ln_g, carried(above[..., -1].contiguous())), y
