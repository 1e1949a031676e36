"""Plain reference of the nbfm64 configuration: 64-channel channelized
NBFM on cu8 (composable-sdr's ``firpfbch`` + ``freqdem``), the function
that ``FlagshipFused`` (K1) computes: cu8 → DC notch → NCO pre-shift →
polyphase split and DFT → FM demod per channel, from zero state.

The audio of a block depends on the stream before it only through the DC
notch, whose memory r^n ≈ e^(−4,194) is nought after one 2^23-sample
block, and the channelizer's last 15 frames.  So the reference computes a
block from that block and the one before it, as one stream from zero
state, and needs no state of the program.  A constant phase of the NCO
cancels in the demod's conjugate product, so its phase starts at 0.
"""

from __future__ import annotations

import math

import torch

from .dsp import channelize, cu8_to_complex, dc_block, fm_demod, pfb_shift


def audio(blocks: list, cfg: dict, cdtype=torch.complex128, tf32: bool = False) -> torch.Tensor:
    """(nch, F) audio of the last of ``blocks`` ((n, 2) uint8 each, the
    stream's consecutive blocks, the first of them at the stream's start
    or a block after its predecessor)."""
    nch = cfg["nch"]
    x = torch.cat([cu8_to_complex(b, cdtype) for b in blocks])
    s = pfb_shift(dc_block(x, cfg["dc_alpha"]), nch)
    d = channelize(s, nch, cfg["m"], cfg["as_db"], tf32=tf32)
    # K1's history starts at zeros: the first frame's previous sample is 0
    a = fm_demod(d, cfg["kf"], 0.0)
    return a[:, -(blocks[-1].shape[0] // nch):]


def judge(cases: list, cfg: dict, traffic: dict) -> list:
    """Per compared block {"audio_rms_rad": the root mean square, over every
    channel and frame, of the gap between the phase steps the program's
    audio and the reference's stand for, (got − want)·2π·kf wrapped into
    [−π, π) (two right demods of a step near ±π read either end)}.

    The mean square and not the largest gap: the float32 DC notch's rounding
    collects at DC (its noise gain is 1/(1 − r²) ≈ 1,000), so the two
    channels beside DC read a few 1e-5 rad on every sound run, where the
    other 62 read ~1e-7."""
    out = []
    scale = 2 * math.pi * cfg["kf"]
    fill = 2 * cfg["m"] + 1
    for c in cases:
        want = audio(c["inputs"], cfg)
        got = torch.as_tensor(c["got"]).to(want.device).to(torch.float64)
        if len(c["inputs"]) == 1:
            # the stream's start: while the channelizer fills, a frame is the
            # sum of a few edge taps, whose phase is rounding; not compared
            want, got = want[:, fill:], got[:, fill:]
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            out.append({"audio_rms_rad": float("inf")})
            continue
        d = torch.remainder((got - want) * scale + math.pi, 2 * math.pi) - math.pi
        out.append({"audio_rms_rad": d.pow(2).mean().sqrt().item()})
    return out


def control(cases: list, cfg: dict, traffic: dict) -> list:
    """The reference in the program's place one step below float32: float32
    throughout, its DFT on TF32 operands."""
    return [dict(c, got=audio(c["inputs"], cfg, torch.complex64, tf32=True).float())
            for c in cases]
