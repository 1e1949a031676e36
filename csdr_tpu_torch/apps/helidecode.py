"""helidecode — offline FSK frame decoder → KML track + Octave plot.

Counterpart of ``csdr_tpu/apps/helidecode.py`` (numpy and ``re``, copied):
reads the .f32 output of the DeNBFMSync flow (2 samples/symbol), slices
bits from every 2nd sample (sign → bit), finds 710-bit frames between sync
patterns, decodes 10-bit characters (8 data bits LSB-first), parses
"AN <deg> <mmss>\\r\\nBW <deg> <mmss>\\r\\n" coordinates, de-glitches them
with a 0.1 km haversine gate, and writes KML (+ an Octave plot of the first
20k samples).

    python -m csdr_tpu_torch.apps.helidecode output.f32
"""

from __future__ import annotations

import os
import re
import sys
from dataclasses import dataclass

import numpy as np

__all__ = ["decode_file", "bits_from_samples", "frames_from_bits", "decode_frame",
           "parse_coords", "clean_coords", "to_kml", "to_octave", "main", "Coord"]

# sync pattern: "11"+6*'0' + 2 bits + "01"+6*'0' + 2 bits
_SYNC_RE = re.compile(r"11000000[01][01]01000000[01][01]")
_FRAME_LEN = 710


@dataclass(frozen=True)
class Coord:
    lat_deg: float
    lat_min: float
    lat_sec: float
    lon_deg: float
    lon_min: float
    lon_sec: float

    def lat(self) -> float:
        return self.lat_deg + self.lat_min / 60.0 + self.lat_sec / 3600.0

    def lon(self) -> float:
        return self.lon_deg + self.lon_min / 60.0 + self.lon_sec / 3600.0


def bits_from_samples(samples: np.ndarray) -> str:
    """Every 2nd sample (symbol centers at 2 samp/sym), sign-sliced:
    v > 0 → '0' else '1' (HeliDecode.hs:171-178).  Vectorized — a
    multi-hundred-MB capture has tens of millions of symbols."""
    centers = np.asarray(samples)[0::2]
    return ((centers <= 0).astype(np.uint8) + ord("0")).tobytes().decode("ascii")


def frames_from_bits(bits: str) -> list[str]:
    """The 710-bit runs BETWEEN sync-pattern matches (sepCap lefts,
    HeliDecode.hs:82-85)."""
    frames, last = [], 0
    for m in _SYNC_RE.finditer(bits):
        seg = bits[last:m.start()]
        if len(seg) == _FRAME_LEN:
            frames.append(seg)
        last = m.end()
    tail = bits[last:]
    if len(tail) == _FRAME_LEN:
        frames.append(tail)
    return frames


def decode_frame(frame: str) -> bytes:
    """10-bit chars: first 8 bits, LSB-first (HeliDecode.hs:88-100)."""
    out = []
    for i in range(0, len(frame) - 9, 10):
        b = 0
        for j, c in enumerate(frame[i:i + 8]):
            if c == "1":
                b |= 1 << j
        out.append(b)
    return bytes(out)


_COORD_RE = re.compile(
    r"AN (-?\d+) (\d{2})(-?\d+)\r\nBW (-?\d+) (\d{2})(-?\d+)\r\n")


def parse_coords(text: str) -> list[Coord]:
    """Loc = deg, 2-digit minutes, seconds = (n/100)·60 (HeliDecode.hs:47-57).
    Only the LEADING run of coordinate records counts — the reference parses
    with ``many parseCoord`` anchored at position 0 (HeliDecode.hs:66-67), so
    a frame with leading garbage yields no coords and anything after the
    first malformed record is ignored."""
    out = []
    pos = 0
    while (m := _COORD_RE.match(text, pos)) is not None:
        pos = m.end()
        lat_d, lat_m, lat_s, lon_d, lon_m, lon_s = m.groups()
        out.append(Coord(
            float(int(lat_d)), float(int(lat_m)), int(lat_s) / 100.0 * 60.0,
            float(int(lon_d)), float(int(lon_m)), int(lon_s) / 100.0 * 60.0,
        ))
    return out


def _dist_km(a: Coord, b: Coord) -> float:
    """Haversine, R = 6371 km (HeliDecode.hs:108-124)."""
    lat_a, lat_b = np.radians(a.lat()), np.radians(b.lat())
    lon_a, lon_b = np.radians(a.lon()), np.radians(b.lon())
    h = (np.sin((lat_b - lat_a) / 2) ** 2
         + np.cos(lat_a) * np.cos(lat_b) * np.sin((lon_b - lon_a) / 2) ** 2)
    return float(6371.0 * 2.0 * np.arctan2(np.sqrt(h), np.sqrt(1.0 - h)))


def clean_coords(coords: list[Coord], max_jump_km: float = 0.1) -> list[Coord]:
    """Keep the EARLIER coord of each close pair (HeliDecode.hs:126-129:
    ``fmap snd $ filter ... $ zip (tail cs) cs`` — snd of (successor,
    predecessor) is the predecessor)."""
    return [c1 for c1, c2 in zip(coords, coords[1:]) if _dist_km(c1, c2) < max_jump_km]


def to_kml(path: str, coords: list[Coord]):
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>'
                '<kml xmlns="http://www.opengis.net/kml/2.2">'
                "<Document><name>Helo</name>\n")
        for n, c in enumerate(coords):
            f.write(f"<Placemark><TimeStamp><when>{n}</when></TimeStamp>"
                    f"<Point><coordinates>{-c.lon():f},{c.lat():f},0</coordinates>"
                    "</Point></Placemark>\n")
        f.write("</Document></kml>\n")


def to_octave(path: str, samples: np.ndarray):
    base = os.path.splitext(os.path.basename(path))[0]
    with open(path, "w") as f:
        f.write("clear all; close all;\nk = 4; v = [];\n")
        for v in samples:
            f.write(f"v(end+1) = {v:12.4e};\n")
        f.write(
            "n = length(v); t = [0:(n-1)]/2; idx = 1:2:n;\n"
            "figure('color','white','position',[100 100 1200 400]);\n"
            "plot(t,v,'-','Color',[1 1 1]*0.6,...\n"
            "     t(idx),v(idx),'o','Color',[0 0.2 0.4]);\n"
            "axis([0 t(end) -2.5 2.5]); grid on;\n"
            "xlabel('Time [symbol index]'); ylabel('symsync output');\n"
            f'print -dpng -color "-S1200,600" {base}.png\n'
        )


def decode_file(path: str, kml_path: str = "output.kml",
                octave_path: str = "output.m") -> list[Coord]:
    samples = np.fromfile(path, dtype="<f4")
    bits = bits_from_samples(samples)
    frames = frames_from_bits(bits)
    texts = [decode_frame(fr)[2:].decode("latin1") for fr in frames]
    coords = clean_coords([c for t in texts for c in parse_coords(t)])
    to_octave(octave_path, samples[:20000])
    to_kml(kml_path, coords)
    return coords


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: helidecode <capture.f32>")
        return 1
    coords = decode_file(args[0])
    print(f"decoded {len(coords)} coordinates -> output.kml, output.m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
