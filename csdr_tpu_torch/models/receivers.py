"""Receiver graphs — counterpart of ``csdr_tpu/models/receivers.py``
(``channelized_receiver`` and ``channelized_fm_receiver``).

The flagship model is ``channelized_fm_receiver``: an nch-channel PFB split
plus per-channel FM demod, the benchmark target of the JAX package
(BASELINE.json config 5)."""

from __future__ import annotations

from ..core.block import Block, MixChannels, PerChannel, chain
from .. import blocks as B

__all__ = ["channelized_receiver", "channelized_fm_receiver"]


def _front_end(offset_hz: float, bandwidth: float, sample_rate: float) -> list[Block]:
    """The offset mixer and resampler are not ported yet (ROADMAP Queue A):
    the front end exists only as the identity."""
    if offset_hz:
        raise NotImplementedError(
            "offset_hz != 0 needs the offset mixer, not yet ported in csdr_tpu_torch "
            "(ROADMAP Queue A: front end)")
    if bandwidth and bandwidth != sample_rate:
        raise NotImplementedError(
            "bandwidth needs the rational resampler, not yet ported in csdr_tpu_torch "
            "(ROADMAP Queue A: front end)")
    return []


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
        *_front_end(offset_hz, bandwidth, sample_rate),
        B.dc_blocker(),
        channelizer,
    ]
    per = per_channel
    if per_channel is not None and agc_threshold_db is not None:
        per = chain(B.automatic_gain_control(agc_threshold_db), per_channel)
    if per is not None:
        stages.append(PerChannel(per, nch))
    if mix:
        stages.append(MixChannels())
    return chain(*stages)


def channelized_fm_receiver(nch: int, kf: float = 0.6, audio_decim: int = 1,
                            mix: bool = False, backend: str = "eager", **kw) -> Block:
    """The flagship model: nch-channel PFB channelize + per-channel FM demod.

    ``backend="eager"`` is the plain-torch graph ``dc_blocker >>
    firpfbch_channelizer >> PerChannel(fm_demodulator)`` (the JAX package's
    ``"xla"``); ``backend="pfb_fused"`` is ``dc_blocker >> PFBFusedFM``, the
    channelizer's FIR, DFT and the demod in the K3 kernel (the JAX
    package's ``"pallas"``); ``backend="fused"`` runs the whole chain as
    the fused CUDA kernel (``FlagshipFused``; the JAX package's
    ``"pallas_full"`` and ``"pallas_wide"``)."""
    if backend not in ("eager", "fused", "pfb_fused"):
        raise ValueError(f"backend must be 'eager', 'fused' or 'pfb_fused', got {backend!r}")
    if audio_decim > 1:
        raise NotImplementedError(
            "audio_decim > 1 needs the FIR decimator, not yet ported in csdr_tpu_torch "
            "(ROADMAP Queue A: FIR decimator)")
    if backend == "eager":
        kw.pop("tileF", None)  # fused-only knob
        return channelized_receiver(nch, B.fm_demodulator(kf), mix=mix, **kw)

    from ..blocks.fused_blocks import FlagshipFused, PFBFusedFM

    if kw.get("agc_threshold_db") is not None:
        # the fused kernels demodulate inside the kernel; per-channel AGC
        # would have to sit between channelize and demod
        raise ValueError(
            f"agc_threshold_db is not supported with the {backend} backend (AGC must "
            "run between channelizer and demod); use backend='eager', or "
            "channelized_receiver(..., backend='pfb_fused') for the K4 channelizer")
    stages: list[Block] = [*_front_end(kw.get("offset_hz", 0.0), kw.get("bandwidth", 0.0),
                                       kw.get("sample_rate", 2.56e6))]
    if backend == "fused":
        stages.append(FlagshipFused(nch, kf, tileF=kw.get("tileF")))
    else:
        stages += [B.dc_blocker(), PFBFusedFM(nch, kf, tileF=kw.get("tileF"))]
    if mix:
        stages.append(MixChannels())
    return chain(*stages)
