#!/usr/bin/env python3
"""The control of a cell's comparison: the configuration's reference put in
the program's place one precision step below the configuration's float32
(float32 throughout, the DFT on TF32 operands), on the blocks a run of the
cell compares, at the cell's own sizes, judged as a run's outputs are.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--out FILE]

prints one JSON line per seed: {"workload", "seed", "readings": {number:
worst reading}, "limits", "fails": the numbers the control fails}.  The
benchmark's own runs never run it; it sets each limit's upper reading
(PERF.md).  The cell's driver gives the inputs of the compared blocks
(``drivers/<driver>.py`` ``control_cases``); a served cell's control walks
its own state from the stream's start over the first blocks (those a run
compares from its start).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import harness


def control_cases(man: dict, seed: int, device) -> list:
    """The inputs of the blocks a run of the cell compares, from its driver."""
    driver = importlib.import_module(f"drivers.{man['traffic']['driver']}")
    return driver.control_cases(man, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    a = ap.parse_args(argv)
    harness.fix_caches()
    sys.path.insert(0, str(harness.ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    man = harness.load_manifest(a.workload)
    ref = harness.reference(man["config"])
    limits = man["config"]["limits"]
    for seed in a.seeds:
        t0 = time.perf_counter()
        cases = control_cases(man, seed, device)
        got = ref.control(cases, man["config"], man["traffic"])
        readings = ref.judge(got, man["config"], man["traffic"])
        worst = {k: max(r[k] for r in readings) for k in limits}
        line = dict(workload=a.workload, seed=seed, readings=worst, limits=limits,
                    fails=[k for k in limits if not worst[k] <= limits[k]],
                    blocks=len(cases), seconds=time.perf_counter() - t0,
                    card=torch.cuda.get_device_name(device))
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del cases, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
