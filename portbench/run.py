#!/usr/bin/env python3
"""The benchmark of csdr_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs one cell of ``BENCHMARK.json`` on the
card(s) of this machine, checks what the timed path produced against the
configuration's plain reference, and prints one JSON line last on standard
output (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics from a traced window).  The numbers compared, each with
its limit, are the last lines on standard error and the result's last
key.  Without CUDA cards enough for the cell it exits 2 and prints no
result; with JAX or the JAX package loaded it exits 3.  See README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    harness.fix_caches()
    found = harness.foreign_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    man = harness.load_manifest(a.workload)
    import torch

    need = man["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"portbench: {a.workload} needs {need} CUDA card(s), this machine has {have}; "
              "no result", file=sys.stderr)
        return 2
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start=T_START)
    found = harness.foreign_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded during the run: {found}",
              file=sys.stderr)
        return 3
    line = harness.result_line(out, bool(a.trace))
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
