"""Offline APRS decoder: .f32 NBFM audio (or .cf32 through an NBFM demod)
→ AX.25 UI frames, one per line.

Counterpart of ``csdr_tpu/apps/aprs_decode.py``.

    python -m csdr_tpu_torch.apps.aprs_decode audio.f32 -s 48000 [-o out.txt]
    python -m csdr_tpu_torch.apps.aprs_decode capture.cf32 -s 48000 --kf 0.5 \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import blocks as B
from ..core.block import chain
from ..io.sources import cf32_file_source, f32_file_source
from ..models import aprs
from ._offline import add_device, collect

__all__ = ["main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="aprs-decode",
                                description="Decode AFSK1200 APRS frames from an audio/IQ capture")
    p.add_argument("filename", metavar="FILE", help="input .f32 audio or .cf32 IQ capture")
    p.add_argument("-s", "--samplerate", type=float, default=48000.0, metavar="DOUBLE",
                   help="capture sample rate (n×1200)")
    p.add_argument("--kf", type=float, default=0.5, metavar="DOUBLE",
                   help="NBFM deviation for .cf32 inputs")
    p.add_argument("-o", "--output", default=None, metavar="TXT",
                   help="also write decoded frames to a text file")
    p.add_argument("--blocksize", type=int, default=1 << 18, metavar="INT")
    add_device(p)
    return p


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    try:
        rx = aprs.afsk1200_receiver(opts.samplerate)
    except ValueError as e:
        print(e)
        return 1
    if opts.filename.endswith(".cf32"):
        graph = chain(B.fm_demodulator(opts.kf), rx)
        src = cf32_file_source(opts.filename)
    else:
        graph = rx
        src = f32_file_source(opts.filename)
    score = collect(graph, src, opts.blocksize, opts.device)
    if score is None:
        return 1
    msgs = aprs.decode_score(np.asarray(score), opts.samplerate)
    lines = [f"{m['src']}>{m['dst']}" + (("," + ",".join(m["via"])) if m["via"] else "")
             + f":{m['info']}" for m in msgs]
    for ln in lines:
        print(ln)
    print(f"{len(msgs)} frame(s)")
    if opts.output:
        with open(opts.output, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
