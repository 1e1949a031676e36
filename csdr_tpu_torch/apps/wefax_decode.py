"""Offline WEFAX (radiofax) decoder: .f32 audio → marine chart as PGM.

Counterpart of ``csdr_tpu/apps/wefax_decode.py``: the product
discriminator (``models/wefax.py``) streams through a Pipeline on the
device; phasing alignment and line resampling run on the host.

    python -m csdr_tpu_torch.apps.wefax_decode rec.f32 -s 12000 -o chart.pgm \\
        [--device cuda|cpu]
    python -m csdr_tpu_torch.apps.wefax_decode rec.f32 -s 12000 --lpm 90
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.sources import f32_file_source
from ..models import wefax
from ._offline import add_device, collect
from .apt_decode import write_pgm

__all__ = ["main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wefax-decode", description="Decode a WEFAX/radiofax chart from an audio capture")
    p.add_argument("filename", metavar="FILE", help="input .f32 audio")
    p.add_argument("-s", "--samplerate", type=float, default=12000.0, metavar="DOUBLE")
    p.add_argument("--lpm", type=float, default=120.0,
                   help="lines per minute (from the broadcast schedule)")
    p.add_argument("-o", "--output", default=None, metavar="PGM")
    p.add_argument("--blocksize", type=int, default=1 << 17, metavar="INT")
    add_device(p)
    return p


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    try:
        rx = wefax.wefax_receiver(opts.samplerate)
    except ValueError as e:
        print(e)
        return 1
    freq = collect(rx, f32_file_source(opts.filename), opts.blocksize, opts.device)
    if freq is None:
        return 1
    image, info = wefax.decode_freq(np.asarray(freq), opts.samplerate, opts.lpm)
    if info["lines"] == 0:
        print(f"no WEFAX phasing found (score {info['phasing_score']:.2f})")
        return 1
    out = opts.output or (opts.filename.rsplit(".", 1)[0] + ".pgm")
    write_pgm(out, image)
    print(f"{info['lines']} line(s) at {opts.lpm:g} lpm "
          f"(phasing {info['phasing_score']:.2f}) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
