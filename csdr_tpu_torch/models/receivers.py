"""Receiver graphs — counterpart of ``csdr_tpu/models/receivers.py``:
the front end (offset mixer + resampler), the single-channel flows
(``wbfm_receiver``, ``nbfm_receiver``, ``am_receiver``, ``raw_capture``) and
the channelized ones (``channelized_receiver``, ``channelized_fm_receiver``).

The flagship model is ``channelized_fm_receiver``: an nch-channel PFB split
plus per-channel FM demod, the benchmark target of the JAX package
(BASELINE.json config 5)."""

from __future__ import annotations

import numpy as np

from ..core.block import Block, MixChannels, PerChannel, chain
from .. import blocks as B

__all__ = ["front_end", "wbfm_receiver", "nbfm_receiver", "am_receiver", "raw_capture",
           "channelized_receiver", "channelized_fm_receiver"]


def front_end(sample_rate: float, offset_hz: float = 0.0, bandwidth: float = 0.0,
              as_db: float = 60.0) -> list[Block]:
    """Offset mixer + resampler, as the reference's front end: f =
    2π·offset/fs, offset > 0 → mix_down(f), offset < 0 → mix_up(−f); the
    resampling rate is bandwidth/sample_rate (0 = none)."""
    stages: list[Block] = []
    if offset_hz:
        f = 2.0 * np.pi * offset_hz / sample_rate
        stages.append(B.mix_down(f) if f > 0 else B.mix_up(-f))
    if bandwidth and bandwidth != sample_rate:
        stages.append(B.resampler(bandwidth / sample_rate, as_db))
    return stages


def _agc(threshold_db: float | None) -> list[Block]:
    # `is not None`: 0.0 dB is a legitimate squelch threshold, not "off"
    return [B.automatic_gain_control(threshold_db)] if threshold_db is not None else []


def wbfm_receiver(sample_rate: float, bandwidth: float, decim: int, offset_hz: float = 0.0,
                  agc_threshold_db: float | None = None) -> Block:
    """DeWBFM flow: front end >> dc_blocker >> [AGC] >> WBFM demod, mono
    audio at (bandwidth or sample_rate)/decim."""
    quad_rate = bandwidth or sample_rate
    return chain(*front_end(sample_rate, offset_hz, bandwidth), B.dc_blocker(),
                 *_agc(agc_threshold_db), B.wbfm_demodulator(quad_rate, decim))


def nbfm_receiver(sample_rate: float, bandwidth: float, kf: float, offset_hz: float = 0.0,
                  agc_threshold_db: float | None = None) -> Block:
    """DeNBFM flow: front end >> dc_blocker >> [AGC] >> FM demod."""
    return chain(*front_end(sample_rate, offset_hz, bandwidth), B.dc_blocker(),
                 *_agc(agc_threshold_db), B.fm_demodulator(kf))


def am_receiver(sample_rate: float, bandwidth: float, offset_hz: float = 0.0,
                agc_threshold_db: float | None = None) -> Block:
    """DeAM flow: front end >> dc_blocker >> [AGC] >> AM envelope."""
    return chain(*front_end(sample_rate, offset_hz, bandwidth), B.dc_blocker(),
                 *_agc(agc_threshold_db), B.am_demodulator())


def raw_capture(sample_rate: float, bandwidth: float = 0.0, offset_hz: float = 0.0,
                agc_threshold_db: float | None = None) -> Block:
    """DeNo flow: front end >> dc_blocker >> [AGC], raw complex out."""
    return chain(*front_end(sample_rate, offset_hz, bandwidth), B.dc_blocker(),
                 *_agc(agc_threshold_db))


def channelized_receiver(nch: int, per_channel: Block | None, mix: bool = False,
                         sample_rate: float = 2.56e6, bandwidth: float = 0.0,
                         offset_hz: float = 0.0, agc_threshold_db: float | None = None,
                         backend: str = "eager") -> Block:
    """dc_blocker >> PFB split into nch channels >> an optional per-channel
    chain; ``mix=True`` sums the channels into one stream.

    As in the JAX package, the AGC runs inside the per-channel chain, before
    ``per_channel``, and only when there is one.  ``backend="eager"`` splits
    with ``PFBChannelizer``; ``backend="pfb_fused"`` with
    ``PFBFusedChannelizer`` (the K4 kernel, granule nch·tileF)."""
    if backend == "eager":
        channelizer = B.firpfbch_channelizer(nch)
    elif backend == "pfb_fused":
        from ..blocks.fused_blocks import PFBFusedChannelizer

        channelizer = PFBFusedChannelizer(nch)
    else:
        raise ValueError(f"backend must be 'eager' or 'pfb_fused', got {backend!r}")
    stages: list[Block] = [
        *front_end(sample_rate, offset_hz, bandwidth),
        B.dc_blocker(),
        channelizer,
    ]
    per = per_channel
    if per_channel is not None and agc_threshold_db is not None:
        per = chain(*_agc(agc_threshold_db), per_channel)
    if per is not None:
        stages.append(PerChannel(per, nch))
    if mix:
        stages.append(MixChannels())
    return chain(*stages)


def channelized_fm_receiver(nch: int, kf: float = 0.6, audio_decim: int = 1,
                            mix: bool = False, backend: str = "eager", **kw) -> Block:
    """The flagship model: nch-channel PFB channelize + per-channel FM demod
    (+ a per-channel FIR decimator for ``audio_decim > 1``).

    ``backend="eager"`` is the plain-torch graph ``dc_blocker >>
    firpfbch_channelizer >> PerChannel(fm_demodulator)`` (the JAX package's
    ``"xla"``); ``backend="pfb_fused"`` is ``dc_blocker >> PFBFusedFM``, the
    channelizer's FIR, DFT and the demod in the K3 kernel (the JAX
    package's ``"pallas"``); ``backend="fused"`` runs the whole chain as
    the fused CUDA kernel (``FlagshipFused``; the JAX package's
    ``"pallas_full"`` and ``"pallas_wide"``)."""
    if backend not in ("eager", "fused", "pfb_fused"):
        raise ValueError(f"backend must be 'eager', 'fused' or 'pfb_fused', got {backend!r}")
    if backend == "eager":
        kw.pop("tileF", None)  # fused-only knob
        per = B.fm_demodulator(kf) if audio_decim == 1 else chain(
            B.fm_demodulator(kf), B.fir_decimator(audio_decim))
        return channelized_receiver(nch, per, mix=mix, **kw)

    from ..blocks.fused_blocks import FlagshipFused, PFBFusedFM

    if kw.get("agc_threshold_db") is not None:
        # the fused kernels demodulate inside the kernel; per-channel AGC
        # would have to sit between channelize and demod
        raise ValueError(
            f"agc_threshold_db is not supported with the {backend} backend (AGC must "
            "run between channelizer and demod); use backend='eager', or "
            "channelized_receiver(..., backend='pfb_fused') for the K4 channelizer")
    stages: list[Block] = [*front_end(kw.get("sample_rate", 2.56e6), kw.get("offset_hz", 0.0),
                                      kw.get("bandwidth", 0.0))]
    if backend == "fused":
        stages.append(FlagshipFused(nch, kf, tileF=kw.get("tileF")))
    else:
        stages += [B.dc_blocker(), PFBFusedFM(nch, kf, tileF=kw.get("tileF"))]
    if audio_decim > 1:
        stages.append(PerChannel(B.fir_decimator(audio_decim), nch))
    if mix:
        stages.append(MixChannels())
    return chain(*stages)
