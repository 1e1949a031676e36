"""Receiver graphs of csdr_tpu_torch: the channelized and single-channel
receivers, broadcast FM (``stereo``, ``rds``), the packet receivers
(``hdlc``, ``ais``, ``aprs``, ``rtty``, ``pocsag``, ``adsb``, ``morse``),
symbol sync and tracking (``symsync``), the coded modem (``modem``), the
coded 4-FSK beacon (``beacon``) and the imagery receivers (``apt``,
``sstv``, ``wefax``)."""

from . import adsb, ais, aprs, apt, beacon, hdlc, modem, morse, pocsag, rtty, sstv, wefax
from .receivers import channelized_fm_receiver, channelized_receiver
from .symsync import SymSync, fm_dem_with_sync, sym_sync_c, sym_sync_r, sym_tracker

__all__ = ["channelized_receiver", "channelized_fm_receiver", "SymSync", "sym_sync_r",
           "sym_sync_c", "sym_tracker", "fm_dem_with_sync", "adsb", "ais", "aprs", "beacon",
           "hdlc", "modem", "morse", "pocsag", "rtty", "apt", "sstv", "wefax"]
