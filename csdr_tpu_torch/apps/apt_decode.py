"""Offline NOAA APT decoder: .f32 wideband-FM audio (or .cf32 IQ through a
built-in FM demodulator) → weather image as a binary PGM (P5) file.

Counterpart of ``csdr_tpu/apps/apt_decode.py``: the coherent 2400 Hz
subcarrier detector and word-rate decimator (``models/apt.apt_receiver``)
stream through a Pipeline on the device; sync framing and level calibration
run on the host (``models/apt.decode_words``).

    python -m csdr_tpu_torch.apps.apt_decode audio.f32 -s 33280 -o image.pgm \\
        [--device cuda|cpu]
    python -m csdr_tpu_torch.apps.apt_decode capture.cf32 -s 33280 --channel a
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import blocks as B
from ..core.block import chain
from ..io.sources import cf32_file_source, f32_file_source
from ..models import apt
from ._offline import add_device, collect

__all__ = ["main", "write_pgm"]


def write_pgm(path: str, image: np.ndarray) -> None:
    """Binary PGM (P5), the no-dependency grayscale interchange format."""
    h, w = image.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(image, np.uint8).tobytes())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="apt-decode",
        description="Decode a NOAA APT weather image from an audio/IQ capture")
    p.add_argument("filename", metavar="FILE", help="input .f32 FM audio or .cf32 IQ capture")
    p.add_argument("-s", "--samplerate", type=float, default=33280.0, metavar="DOUBLE",
                   help="capture sample rate (n×4160)")
    p.add_argument("--kf", type=float, default=0.6, metavar="DOUBLE",
                   help="WBFM deviation for .cf32 inputs")
    p.add_argument("-o", "--output", default=None, metavar="PGM",
                   help="output image path (default: FILE.pgm)")
    p.add_argument("--channel", choices=["full", "a", "b"], default="full",
                   help="write the full 2080-word lines or one 909-px video channel")
    p.add_argument("--blocksize", type=int, default=1 << 17, metavar="INT")
    add_device(p)
    return p


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    try:
        rx = apt.apt_receiver(opts.samplerate)
    except ValueError as e:
        print(e)
        return 1
    if opts.filename.endswith(".cf32"):
        graph = chain(B.fm_demodulator(opts.kf), rx)
        src = cf32_file_source(opts.filename)
    else:
        graph = rx
        src = f32_file_source(opts.filename)
    words = collect(graph, src, opts.blocksize, opts.device)
    if words is None:
        return 1
    image, info = apt.decode_words(np.asarray(words))
    if info["lines"] == 0:
        print("no APT sync found")
        return 1
    if opts.channel != "full":
        va, vb = apt.split_channels(image)
        image = va if opts.channel == "a" else vb
    out = opts.output or (opts.filename.rsplit(".", 1)[0] + ".pgm")
    write_pgm(out, image)
    print(f"{info['lines']} line(s), levels [{info['level_lo']:.4f}, "
          f"{info['level_hi']:.4f}] -> {out} ({image.shape[1]}x{image.shape[0]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
