"""k4_roofline (%): K4's roofline share, ``pfb_bound(demod=False)`` at the
cell's block over the device time per block of ``pfb_tile<false>`` in the
traced window.  Moves ``msps``."""

import re

from bounds import pfb_bound

K4 = re.compile(r"\bpfb_tile<\s*(false|0)\s*>")


def read(run):
    s = run["summaries"][0]
    t = sum(v["device_s"] for k, v in s["kernels"].items() if K4.search(k))
    if t <= 0:
        return None
    bound_s = pfb_bound(run["block"], run["config"]["nch"], demod=False)["bound_ms"] / 1e3
    return 100.0 * bound_s / (t / s["steps"])
