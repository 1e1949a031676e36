"""Offline AIS decoder: .cf32 GMSK baseband → decoded position reports.

Counterpart of ``csdr_tpu/apps/ais_decode.py``: the GMSK demod chain
(``models/ais.ais_receiver``) on the device, NRZI/HDLC/CRC on the host, one
line per valid message and an optional CSV.

    python -m csdr_tpu_torch.apps.ais_decode capture.cf32 -s 48000 [-o out.csv] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.sources import cf32_file_source
from ..models import ais
from ._offline import add_device, collect

__all__ = ["main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ais-decode",
                                description="Decode AIS position reports from a CF32 GMSK capture")
    p.add_argument("filename", metavar="FILE", help="input .cf32 capture")
    p.add_argument("-s", "--samplerate", type=float, default=48000.0, metavar="DOUBLE",
                   help="capture sample rate (n×9600)")
    p.add_argument("-o", "--output", default=None, metavar="CSV",
                   help="also write messages as CSV")
    p.add_argument("--blocksize", type=int, default=1 << 18, metavar="INT")
    add_device(p)
    return p


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    try:
        graph = ais.ais_receiver(opts.samplerate)
    except ValueError as e:
        print(e)
        return 1
    levels = collect(graph, cf32_file_source(opts.filename), opts.blocksize, opts.device)
    if levels is None:
        return 1
    msgs = ais.decode_bits(np.asarray(levels))
    for m in msgs:
        if "lat_deg" in m:
            print(f"type {m['type']} mmsi {m['mmsi']:09d} "
                  f"lat {m['lat_deg']:+.5f} lon {m['lon_deg']:+.5f} "
                  f"sog {m['sog_kn']:.1f} kn cog {m['cog_deg']:.1f}")
        else:
            print(f"type {m['type']} mmsi {m['mmsi']:09d}")
    print(f"{len(msgs)} message(s)")
    if opts.output:
        with open(opts.output, "w") as f:
            f.write("type,mmsi,lat_deg,lon_deg,sog_kn,cog_deg\n")
            for m in msgs:
                f.write(f"{m['type']},{m['mmsi']},{m.get('lat_deg', '')},"
                        f"{m.get('lon_deg', '')},{m.get('sog_kn', '')},"
                        f"{m.get('cog_deg', '')}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
