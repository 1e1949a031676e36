"""HDLC bit layer shared by the packet decoders (AIS, AX.25/APRS).

Copied from ``csdr_tpu/models/hdlc.py`` (numpy): NRZI coding, 0x7E flag
delimiting, bit de-stuffing (a 0 after five 1s), LSB-first byte assembly
and the CRC-16/X-25 FCS of ITU-R M.1371 (``models/ais.py``) and AX.25
(``models/aprs.py``), plus the open-loop bit clock ``sample_bits`` that the
AFSK and POCSAG decoders share.  Host side by design: these are irregular,
data-dependent computations on kb/s bit streams; the sample-rate work
stays on the device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FLAG", "crc16_x25", "nrzi_decode", "nrzi_encode", "destuff", "stuff",
           "hdlc_frames", "frame_to_wire_bits", "sample_bits"]

FLAG = "01111110"


def sample_bits(score: np.ndarray, k: int) -> np.ndarray:
    """Bit-centre sampling at k samples per bit, aligned to the dominant
    transition phase mod k (adequate for drift-free captures).  Positive
    score = bit level 1."""
    s = (np.asarray(score) > 0).astype(np.uint8)
    tr = np.flatnonzero(s[1:] != s[:-1]) + 1
    phase = int(np.bincount(tr % k, minlength=k).argmax()) if len(tr) else 0
    return s[np.arange(phase + k // 2, len(s), k)]


def nrzi_decode(levels: np.ndarray) -> np.ndarray:
    """NRZI: decoded bit = 1 iff the level did not change (0 = transition)."""
    lv = np.asarray(levels).astype(np.uint8)
    prev = np.concatenate([lv[:1], lv[:-1]])
    return (lv == prev).astype(np.uint8)


def nrzi_encode(bits: np.ndarray, start_level: int = 0) -> np.ndarray:
    toggles = 1 - np.asarray(bits, dtype=np.uint8)
    levels = (start_level + np.cumsum(toggles)) & 1
    return levels.astype(np.uint8)


def crc16_x25(data: bytes) -> int:
    """CRC-16/X-25 (reflected 0x1021 = 0x8408, init 0xFFFF, xorout 0xFFFF)."""
    crc = 0xFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc ^ 0xFFFF


def destuff(bits: str) -> str | None:
    """Remove the 0 stuffed after every run of five 1s; None if a run of six
    1s appears (only flags may hold one)."""
    out = []
    ones = 0
    i = 0
    while i < len(bits):
        b = bits[i]
        out.append(b)
        if b == "1":
            ones += 1
            if ones == 5:
                i += 1  # skip the stuffed 0
                if i < len(bits) and bits[i] == "1":
                    return None
                ones = 0
        else:
            ones = 0
        i += 1
    return "".join(out)


def stuff(bits: str) -> str:
    out = []
    ones = 0
    for b in bits:
        out.append(b)
        if b == "1":
            ones += 1
            if ones == 5:
                out.append("0")
                ones = 0
        else:
            ones = 0
    return "".join(out)


def hdlc_frames(levels: np.ndarray) -> list[bytes]:
    """NRZI-decode a level stream, find flag-delimited segments, de-stuff,
    assemble LSB-first bytes and check the CRC-16/X-25 FCS; returns the
    payload bytes (FCS stripped) of every valid frame."""
    bits = "".join("1" if b else "0" for b in nrzi_decode(levels))
    frames = []
    flags = [m for m in range(len(bits)) if bits[m:m + 8] == FLAG]
    for a, b in zip(flags, flags[1:]):
        seg = bits[a + 8:b]
        if len(seg) < 8 * (2 + 1):  # at least one data byte + FCS
            continue
        d = destuff(seg)
        if d is None or len(d) % 8:
            continue
        data = bytes(int(d[i:i + 8][::-1], 2) for i in range(0, len(d), 8))
        payload, fcs = data[:-2], data[-2:]
        if crc16_x25(payload) == fcs[0] | (fcs[1] << 8):
            frames.append(payload)
    return frames


def frame_to_wire_bits(payload: bytes, training: int = 24) -> np.ndarray:
    """Payload bytes → over-the-air bit levels: training 0101…, flag,
    stuffed LSB-first data + FCS, flag, NRZI-encoded (the encoder half,
    the packet decoders' test transmitter)."""
    fcs = crc16_x25(payload)
    wire = payload + bytes([fcs & 0xFF, fcs >> 8])
    raw = "".join(f"{byte:08b}"[::-1] for byte in wire)  # LSB first
    frame = "01" * (training // 2) + FLAG + stuff(raw) + FLAG
    bits = np.frombuffer(frame.encode(), np.uint8) - ord("0")
    return nrzi_encode(bits)
