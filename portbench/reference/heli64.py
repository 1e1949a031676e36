"""Plain reference of the heli64 configuration: composable-sdr's ``-c 64
--demod "DeNBFMSync 10"`` (``fmDemWithSync``: ``symSyncR 10 4 0 64 .
fmDemodulator 0.2`` per channel behind a 64-way ``firpfbch`` split of cu8),
as the port's pfb_fused graph runs it: cu8 → DC notch → NCO pre-shift →
polyphase split and DFT → per channel FM demod (its first previous sample
1) → block-mode symbol sync, two outputs per symbol.

A block's outputs depend on the stream before it through the DC notch
(nought after one block), the channelizer's, demod's and sync's histories
(all inside the previous block) and the sync's carried timing estimate τ,
one number per channel that every earlier block moved.  So the reference
computes a block from it and the block before it, with the τ it is given:
for the first blocks of a run its own, carried from the stream's start;
for the blocks sampled later in the run the program's τ as the program
carried it into that block, whose update over the block is then held
against the reference's on its own (``tau_err``).  Every channel is
compared: the traffic puts telemetry on each of them, since the FM demod
of a channel of pure noise turns on rounding wherever a phase step lies
near ±π, and no comparison of two right implementations holds there.
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp import channelize, cu8_to_complex, dc_block, fm_demod, pfb_shift, real_dtype
from .sync import either_pick_error, sync_block, sync_history, tau_error


def block_result(blocks: list, cfg: dict, tau_prev, valid, cdtype=torch.complex128,
                 tf32: bool = False) -> dict:
    """``sync_block``'s result for the last of ``blocks`` on every channel,
    the stream starting at ``blocks[0]``."""
    nch, k = cfg["nch"], cfg["sync_k"]
    x = torch.cat([cu8_to_complex(b, cdtype) for b in blocks])
    s = pfb_shift(dc_block(x, cfg["dc_alpha"]), nch)
    d = channelize(s, nch, cfg["m"], cfg["as_db"], tf32=tf32)
    dm = fm_demod(d, 0.02 * k, 1.0 + 0.0j)
    n = blocks[-1].shape[0] // nch
    H = sync_history(k, cfg["sync_m"])
    rd = real_dtype(cdtype)
    hist = dm[:, -n - H:-n] if len(blocks) > 1 else torch.zeros(nch, H, dtype=rd,
                                                                 device=x.device)
    return sync_block(dm[:, -n:], hist, tau_prev.to(x.device).to(rd),
                      valid.to(x.device), k, cfg["sync_m"], cfg["sync_npfb"],
                      cfg["tie_width"])


def _walk(cases: list, cfg: dict, cdtype, tf32: bool):
    """(case, the result for it) in order: start blocks carry the
    reference's own τ from the stream's start, sampled blocks take the
    program's."""
    tau = torch.zeros(cfg["nch"], dtype=torch.float64)
    valid = torch.zeros(cfg["nch"], dtype=torch.bool)
    for c in cases:
        if not c["start"]:
            tau = torch.as_tensor(c["carried_before"]["tau"]).double()
            valid = torch.as_tensor(c["carried_before"]["tau_valid"])
        res = block_result(c["inputs"], cfg, tau, valid, cdtype, tf32)
        yield c, res
        tau, valid = res["tau"].double().cpu(), torch.ones(cfg["nch"], dtype=torch.bool)


def judge(cases: list, cfg: dict, traffic: dict) -> list:
    """Per compared block {"sync_err": the largest gap of the program's
    outputs on every channel from the reference's (either pick), relative
    to each channel's largest output; "tau_err": the largest gap, in
    samples, of the τ the program carried out of the block from the
    reference's (0 where the run ended before the program carried one)}."""
    k = cfg["sync_k"]
    out = []
    for c, res in _walk(cases, cfg, torch.complex128, False):
        got = np.asarray(c["got"])
        if got.shape != tuple(res["y"].shape) or not np.isfinite(got).all():
            out.append({"sync_err": float("inf"), "tau_err": float("inf")})
            continue
        after = c.get("carried_after")
        tau = 0.0 if after is None else tau_error(np.asarray(after["tau"]), res, k)
        out.append({"sync_err": either_pick_error(got, res), "tau_err": tau})
    return out


def control(cases: list, cfg: dict, traffic: dict) -> list:
    """The reference in the program's place one step below float32: float32
    throughout, its DFT on TF32 operands; its outputs and its carried τ."""
    return [dict(c, got=res["y"].cpu().numpy(), carried_after={"tau": res["tau"].cpu().numpy()})
            for c, res in _walk(cases, cfg, torch.complex64, True)]
