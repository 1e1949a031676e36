"""Offline ADS-B decoder: .cf32 1090 MHz capture → decoded Mode S messages.

Counterpart of ``csdr_tpu/apps/adsb_decode.py``: the envelope and preamble
matched-filter chain (``models/adsb.adsb_receiver``) on the device; PPM
slicing, CRC-24 and CPR pairing on the host; one line per valid message and
an optional CSV.

    python -m csdr_tpu_torch.apps.adsb_decode capture.cf32 -s 2e6 [-o out.csv] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from ..io.sources import cf32_file_source
from ..models import adsb
from ._offline import add_device, collect

__all__ = ["main", "format_msg"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="adsb-decode",
                                description="Decode ADS-B (Mode S DF17/18) from a CF32 capture")
    p.add_argument("filename", metavar="FILE", help="input .cf32 capture")
    p.add_argument("-s", "--samplerate", type=float, default=2e6, metavar="DOUBLE",
                   help="capture sample rate (2n×1 MHz)")
    p.add_argument("-o", "--output", default=None, metavar="CSV",
                   help="also write messages as CSV")
    p.add_argument("--blocksize", type=int, default=1 << 20, metavar="INT")
    add_device(p)
    return p


def format_msg(m: dict) -> str:
    parts = [f"DF{m['df']} {m['icao']:06X}"]
    if "callsign" in m:
        parts.append(f"ident {m['callsign']}")
    if "alt_ft" in m:
        parts.append(f"alt {m['alt_ft']} ft")
    if "lat_deg" in m:
        parts.append(f"lat {m['lat_deg']:+.5f} lon {m['lon_deg']:+.5f}")
    if "speed_kn" in m:
        parts.append(f"gs {m['speed_kn']:.1f} kn trk {m['track_deg']:.1f}")
    if "vrate_fpm" in m:
        parts.append(f"vr {m['vrate_fpm']:+d} fpm")
    return " ".join(parts)


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    try:
        graph = adsb.adsb_receiver(opts.samplerate)
    except ValueError as e:
        print(e)
        return 1
    collected = collect(graph, cf32_file_source(opts.filename), opts.blocksize, opts.device)
    if collected is None:
        return 1
    msgs = adsb.pair_positions(adsb.decode_collected(collected, opts.samplerate))
    for m in msgs:
        print(format_msg(m))
    print(f"{len(msgs)} message(s)")
    if opts.output:
        with open(opts.output, "w") as f:
            f.write("icao,df,callsign,alt_ft,lat_deg,lon_deg,speed_kn,track_deg,vrate_fpm\n")
            for m in msgs:
                f.write(f"{m['icao']:06X},{m['df']},{m.get('callsign', '')},"
                        f"{m.get('alt_ft', '')},{m.get('lat_deg', '')},"
                        f"{m.get('lon_deg', '')},{m.get('speed_kn', '')},"
                        f"{m.get('track_deg', '')},{m.get('vrate_fpm', '')}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
