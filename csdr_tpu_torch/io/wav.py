"""WAV and Sun AU float-PCM codecs (pure numpy).

Copied from ``csdr_tpu/io/wav.py``: IEEE-float WAV (format tag 3,
little-endian; int16 and int32 PCM are read too) and Sun AU (encoding 6,
float32 big-endian; int16 is read too).  The reference asks libsndfile for
big-endian WAV floats, which libsndfile coerces; both packages write
standard little-endian float WAV."""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_wav", "read_wav", "probe_wav", "write_au", "read_au",
           "WavWriter", "AuWriter"]


def probe_wav(path: str) -> tuple[int, int, int]:
    """Header-only probe: returns (sample_rate, channels, format_tag) without
    reading the payload (the CLI's source sniff must not read a multi-GB
    capture twice).  Raises ValueError if the file is not a readable WAV."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: missing fmt chunk")
            cid, csz = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                tag, nch, sr, _br, _ba, bits = struct.unpack("<HHIIHH", f.read(16))
                if (tag, bits) not in ((3, 32), (1, 16), (1, 32)):
                    raise ValueError(f"{path}: unsupported WAV format "
                                     f"tag={tag} bits={bits}")
                return sr, nch, tag
            f.seek(csz + (csz & 1), 1)


def write_wav(path: str, data: np.ndarray, sample_rate: int):
    """data: (n,) mono or (n, ch) float32 in [-1, 1]."""
    w = WavWriter(path, sample_rate, 1 if data.ndim == 1 else data.shape[1])
    w.write(data)
    w.close()


def read_wav(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csz = struct.unpack("<4sI", hdr)
            body = f.read(csz + (csz & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", body[:16])
            elif cid == b"data":
                data = body[:csz]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        tag, nch, sr, _br, _ba, bits = fmt
        if tag == 3 and bits == 32:
            arr = np.frombuffer(data, dtype="<f4")
        elif tag == 1 and bits == 16:
            arr = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif tag == 1 and bits == 32:
            arr = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported WAV format tag={tag} bits={bits}")
        if nch > 1:
            arr = arr.reshape(-1, nch)
        return arr.astype(np.float32), sr


class WavWriter:
    """Streaming float32 WAV writer; header patched on close."""

    def __init__(self, path: str, sample_rate: int, channels: int = 1):
        self.f = open(path, "wb")
        self.sr = int(sample_rate)
        self.ch = int(channels)
        self.nbytes = 0
        self._write_header(0)

    def _write_header(self, data_bytes: int):
        ba = 4 * self.ch
        self.f.write(b"RIFF")
        self.f.write(struct.pack("<I", 36 + data_bytes))
        self.f.write(b"WAVE")
        self.f.write(b"fmt ")
        self.f.write(struct.pack("<IHHIIHH", 16, 3, self.ch, self.sr, self.sr * ba, ba, 32))
        self.f.write(b"data")
        self.f.write(struct.pack("<I", data_bytes))

    def write(self, data: np.ndarray):
        buf = np.asarray(data, dtype="<f4").reshape(-1).tobytes()
        self.f.write(buf)
        self.nbytes += len(buf)

    def close(self):
        self.f.seek(0)
        self._write_header(self.nbytes)
        self.f.close()


class AuWriter:
    """Sun AU float32 (big-endian) writer, the reference's AU option; the
    data size is patched on close."""

    def __init__(self, path: str, sample_rate: int, channels: int = 1):
        self.f = open(path, "wb")
        self.sr = int(sample_rate)
        self.ch = int(channels)
        self.nbytes = 0
        # magic, data offset, data size (unknown until close), encoding 6
        self.f.write(struct.pack(">4sIIIII", b".snd", 24, 0xFFFFFFFF, 6, self.sr, self.ch))

    def write(self, data: np.ndarray):
        buf = np.asarray(data, dtype=">f4").reshape(-1).tobytes()
        self.f.write(buf)
        self.nbytes += len(buf)

    def close(self):
        self.f.seek(8)
        self.f.write(struct.pack(">I", self.nbytes))
        self.f.close()


def write_au(path: str, data: np.ndarray, sample_rate: int):
    w = AuWriter(path, sample_rate, 1 if data.ndim == 1 else data.shape[1])
    w.write(data)
    w.close()


def read_au(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        magic, off, size, enc, sr, ch = struct.unpack(">4sIIIII", f.read(24))
        if magic != b".snd":
            raise ValueError(f"{path}: not an AU file")
        f.seek(off)
        raw = f.read() if size == 0xFFFFFFFF else f.read(size)
        if enc == 6:
            arr = np.frombuffer(raw, dtype=">f4").astype(np.float32)
        elif enc == 3:
            arr = (np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0)
        else:
            raise ValueError(f"{path}: unsupported AU encoding {enc}")
        if ch > 1:
            arr = arr.reshape(-1, ch)
        return arr, sr
