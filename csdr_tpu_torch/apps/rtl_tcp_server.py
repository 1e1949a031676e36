"""Serve a capture file (or an SDR device) as an rtl_tcp server.

Counterpart of ``csdr_tpu/apps/rtl_tcp_server.py``: a recording or the
synthetic device becomes an rtl_tcp stream that any client reads (gqrx,
SDR#, rtl_fm, or ``soapy_sdr_cli --devname rtl_tcp``).

    python -m csdr_tpu_torch.apps.rtl_tcp_server --filename cap.cu8 --port 0 --clients 1

prints ``rtl_tcp server on HOST:PORT`` (with ``--port 0`` the port the
system gave), serves one client at a time and, with ``--clients N``, exits
after N clients (0 = until interrupted).  ``.cu8`` captures go on the wire
as they are; any other file is read as CF32 and quantized as a dongle
does.  ``--loop`` repeats the file within one connection.  ``-v`` prints
each client's commands, with librtlsdr's names, when it is done.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..io import sources as SRC
from ..io.rtl_tcp import RtlTcpServer

__all__ = ["main", "build_parser", "run_opts"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtl-tcp-server",
                                description="Serve a capture or an SDR device over rtl_tcp")
    p.add_argument("--filename", metavar="NAME",
                   help="Capture to serve (.cu8 raw uint8 IQ, anything else CF32)")
    p.add_argument("--devname", default=None, metavar="NAME",
                   help="SDR device to serve instead of a file (e.g. synthetic)")
    p.add_argument("-s", "--samplerate", type=float, default=2.4e6, metavar="DOUBLE",
                   help="Sample rate the device is opened at")
    p.add_argument("--port", type=int, default=1234, metavar="INT",
                   help="TCP port (0 = any free port, printed on start)")
    p.add_argument("--host", default="127.0.0.1", metavar="ADDR")
    p.add_argument("--loop", action="store_true",
                   help="Repeat the file endlessly within one connection")
    p.add_argument("--clients", type=int, default=0, metavar="INT",
                   help="Exit after serving N clients (0 = run until interrupted)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print each client's command log when it is done")
    return p


def run_opts(opts) -> int:
    if not opts.filename and not opts.devname:
        print("need --filename or --devname")
        return 1
    if opts.filename and not os.path.exists(opts.filename):
        print(f"no such capture: {opts.filename}")
        return 1

    def make_source():
        if not opts.filename:
            yield from SRC.open_sdr(opts.devname, opts.samplerate, 0.0, 0.0)
            return
        while True:
            if opts.filename.endswith(".cu8"):
                yield from SRC.cu8_file_source(opts.filename)
            else:
                yield from SRC.cf32_file_source(opts.filename)
            if not opts.loop:
                return

    srv = RtlTcpServer(make_source, host=opts.host, port=opts.port)
    print(f"rtl_tcp server on {srv.host}:{srv.port}", flush=True)
    done = logged = ncmd = 0
    try:
        while opts.clients == 0 or done < opts.clients:
            time.sleep(0.05)
            done = srv.clients_served
            if opts.verbose and done > logged:
                named = srv.commands_named()  # the log since the last line
                print(f"commands: {json.dumps(named[ncmd:])}", flush=True)
                logged, ncmd = done, len(named)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    print(f"served {srv.clients_served} client(s)", flush=True)
    return 0


def main(argv=None) -> int:
    return run_opts(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
