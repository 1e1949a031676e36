"""Receiver graphs of csdr_tpu_torch: the channelized and single-channel
receivers, broadcast FM (``stereo``, ``rds``) and the packet receivers
(``hdlc``, ``ais``, ``aprs``, ``rtty``, ``pocsag``, ``adsb``, ``morse``)."""

from . import adsb, ais, aprs, hdlc, morse, pocsag, rtty
from .receivers import channelized_fm_receiver, channelized_receiver

__all__ = ["channelized_receiver", "channelized_fm_receiver", "adsb", "ais", "aprs", "hdlc",
           "morse", "pocsag", "rtty"]
