"""Offline POCSAG decoder: .cf32 FSK baseband (or .f32 discriminator audio)
→ decoded pager messages, one per line.

Counterpart of ``csdr_tpu/apps/pocsag_decode.py``.

    python -m csdr_tpu_torch.apps.pocsag_decode capture.cf32 -s 38400 [--baud 1200]
    python -m csdr_tpu_torch.apps.pocsag_decode disc.f32 -s 38400 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..blocks import FIRFilter
from ..core.block import chain
from ..io.sources import cf32_file_source, f32_file_source
from ..models import pocsag
from ._offline import add_device, collect

__all__ = ["main", "format_msg"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pocsag-decode",
        description="Decode POCSAG pages from an FSK IQ / discriminator capture")
    p.add_argument("filename", metavar="FILE",
                   help="input .cf32 FSK baseband or .f32 discriminator audio")
    p.add_argument("-s", "--samplerate", type=float, default=38400.0, metavar="DOUBLE",
                   help="capture sample rate (n×baud)")
    p.add_argument("--baud", type=float, default=1200.0, choices=pocsag.POCSAG_BAUDS,
                   metavar="BAUD", help="POCSAG baud rate (512/1200/2400)")
    p.add_argument("--deviation", type=float, default=4500.0, metavar="HZ",
                   help="FSK deviation for .cf32 inputs")
    p.add_argument("-o", "--output", default=None, metavar="TXT",
                   help="also write decoded messages to a text file")
    p.add_argument("--blocksize", type=int, default=1 << 18, metavar="INT")
    add_device(p)
    return p


def format_msg(m: dict) -> str:
    return f"RIC {m['ric']} fn {m['fn']} [{m['kind']}] {m['text']}"


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    try:
        graph = pocsag.pocsag_receiver(opts.samplerate, opts.baud, opts.deviation)
    except ValueError as e:
        print(e)
        return 1
    if opts.filename.endswith(".f32"):
        # discriminator audio: the integrator alone
        k = int(round(opts.samplerate / opts.baud))
        graph = chain(FIRFilter(np.ones(k) / k, complex_input=False, name=f"bit_ma({k})"))
        src = f32_file_source(opts.filename)
    else:
        src = cf32_file_source(opts.filename)
    score = collect(graph, src, opts.blocksize, opts.device)
    if score is None:
        return 1
    msgs = pocsag.decode_score(np.asarray(score), opts.samplerate, opts.baud)
    lines = [format_msg(m) for m in msgs]
    for ln in lines:
        print(ln)
    print(f"{len(msgs)} message(s)")
    if opts.output:
        with open(opts.output, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
