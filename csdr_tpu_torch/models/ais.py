"""AIS receiver — ITU-R M.1371 position reports from a GMSK baseband.

Counterpart of ``csdr_tpu/models/ais.py``: 9600 baud GMSK (BT = 0.4),
NRZI, HDLC framing, CRC-16/X-25, 168-bit position payloads.  The
sample-rate part (GMSK demodulation to bit levels, ``blocks/gmsk.py``) runs
on the device; the flag search, de-stuffing, CRC and field extraction
(``models/hdlc.py``) run on the host over the 9.6 kb/s bit stream.

Wire conventions (the test encoder uses the same, so the chain is held as
an exact inverse pair): NRZI (a zero toggles the level), 0x7E flags, a 0
stuffed after five 1s, bytes LSB first, the FCS appended little-endian;
payload fields in the NMEA 6-bit armour order (each byte MSB first).
"""

from __future__ import annotations

import numpy as np

from ..blocks.gmsk import gmsk_demodulator, gmsk_mod
from ..core.block import Block, chain
from .hdlc import crc16_x25, frame_to_wire_bits, hdlc_frames, nrzi_decode, nrzi_encode

__all__ = ["ais_receiver", "decode_bits", "parse_payload", "crc16_x25", "nrzi_decode",
           "nrzi_encode", "make_position_report", "ais_burst_bits", "ais_modulate"]

AIS_BAUD = 9600.0


def ais_receiver(sample_rate: float, m: int = 3, bt: float = 0.4) -> Block:
    """GMSK demod at 9600 baud → bit levels (before NRZI decoding);
    ``sample_rate`` must be n·9600 with n ≥ 2."""
    k = sample_rate / AIS_BAUD
    if abs(k - round(k)) > 1e-9 or round(k) < 2:
        raise ValueError(f"AIS needs sample_rate = n·9600 with n ≥ 2, got {sample_rate}")
    return chain(gmsk_demodulator(m, int(round(k)), bt))


def decode_bits(levels: np.ndarray) -> list[dict]:
    """NRZI → flags → de-stuff → CRC (``models/hdlc.py``) → ``parse_payload``
    for every valid frame; CRC-valid frames too short for type + MMSI are
    skipped."""
    out = []
    for payload in hdlc_frames(levels):
        msg = parse_payload("".join(f"{byte:08b}" for byte in payload))
        if msg is not None:
            out.append(msg)
    return out


def _i(bits: str, lo: int, n: int) -> int:
    return int(bits[lo:lo + n], 2)


def _s(bits: str, lo: int, n: int) -> int:
    v = _i(bits, lo, n)
    return v - (1 << n) if v & (1 << (n - 1)) else v


def parse_payload(pb: str) -> dict | None:
    """Fields of message types 1/2/3 (class-A position report, ITU-R M.1371
    table 45); other types give type + mmsi only; None if too short."""
    if len(pb) < 38:
        return None
    msg = {"type": _i(pb, 0, 6), "mmsi": _i(pb, 8, 30)}
    if msg["type"] in (1, 2, 3) and len(pb) >= 144:
        msg.update(
            sog_kn=_i(pb, 50, 10) / 10.0,
            lon_deg=_s(pb, 61, 28) / 600000.0,
            lat_deg=_s(pb, 89, 27) / 600000.0,
            cog_deg=_i(pb, 116, 12) / 10.0,
        )
    return msg


def make_position_report(mmsi: int, lat_deg: float, lon_deg: float, sog_kn: float = 0.0,
                         cog_deg: float = 0.0, msg_type: int = 1) -> str:
    """168-bit class-A position payload (NMEA bit order)."""
    def u(v, n):
        return format(int(v) & ((1 << n) - 1), f"0{n}b")

    pb = (u(msg_type, 6) + u(0, 2) + u(mmsi, 30) + u(0, 4) + u(128, 8)
          + u(round(sog_kn * 10), 10) + u(0, 1)
          + u(round(lon_deg * 600000), 28) + u(round(lat_deg * 600000), 27)
          + u(round(cog_deg * 10), 12) + u(511, 9) + u(60, 6)
          + u(0, 2) + u(0, 3) + u(0, 1) + u(0, 19))
    if len(pb) != 168:
        raise AssertionError(len(pb))
    return pb


def ais_burst_bits(payload_bits: str, training: int = 24) -> np.ndarray:
    """Payload → over-the-air bit levels (``models/hdlc.frame_to_wire_bits``)."""
    data = bytes(int(payload_bits[i:i + 8], 2) for i in range(0, len(payload_bits), 8))
    return frame_to_wire_bits(data, training)


def ais_modulate(levels: np.ndarray, k: int, m: int = 3, bt: float = 0.4) -> np.ndarray:
    """GMSK-modulate bit levels at k samples per bit (the test transmitter)."""
    return gmsk_mod(np.asarray(levels, np.int64), k, m, bt)
