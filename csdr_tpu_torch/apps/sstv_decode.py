"""Offline SSTV decoder: .f32 audio → RGB image as a binary PPM (P6) file.

Counterpart of ``csdr_tpu/apps/sstv_decode.py``: Martin M1/M2 with VIS
auto-detect (``models/sstv.py``).  The product discriminator to
instantaneous frequency streams through a Pipeline on the device; VIS and
sync framing and the scanline resampling run on the host.

    python -m csdr_tpu_torch.apps.sstv_decode audio.f32 -s 11025 -o image.ppm \\
        [--device cuda|cpu]
    python -m csdr_tpu_torch.apps.sstv_decode rec.f32 -s 11025 --mode martin2
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.sources import f32_file_source
from ..models import sstv
from ._offline import add_device, collect

__all__ = ["main", "write_ppm"]


def write_ppm(path: str, image: np.ndarray) -> None:
    """Binary PPM (P6), the no-dependency RGB interchange format."""
    h, w, _ = image.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(image, np.uint8).tobytes())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sstv-decode", description="Decode an SSTV (Martin) image from an audio capture")
    p.add_argument("filename", metavar="FILE", help="input .f32 audio")
    p.add_argument("-s", "--samplerate", type=float, default=11025.0, metavar="DOUBLE")
    p.add_argument("--mode", choices=[*sstv.MODES, "auto"], default="auto",
                   help="force a mode for headerless recordings")
    p.add_argument("-o", "--output", default=None, metavar="PPM",
                   help="output image path (default: FILE.ppm)")
    p.add_argument("--blocksize", type=int, default=1 << 17, metavar="INT")
    add_device(p)
    return p


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    try:
        rx = sstv.sstv_receiver(opts.samplerate)
    except ValueError as e:
        print(e)
        return 1
    freq = collect(rx, f32_file_source(opts.filename), opts.blocksize, opts.device)
    if freq is None:
        return 1
    mode = None if opts.mode == "auto" else opts.mode
    image, info = sstv.decode_freq(np.asarray(freq), opts.samplerate, mode)
    if info["lines"] == 0:
        print("no SSTV transmission found" + ("" if info["mode"] else " (no VIS; try --mode)"))
        return 1
    out = opts.output or (opts.filename.rsplit(".", 1)[0] + ".ppm")
    write_ppm(out, image)
    print(f"{info['mode']}: {info['lines']} line(s)"
          f"{' (VIS)' if info['vis_detected'] else ''} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
