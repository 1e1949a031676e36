"""k1_roofline (%): K1's roofline share, ``flagship_bound`` at the cell's
cu8 block over K1's device time per block, the sum of its three kernels
(``dc_chunk``, ``carry_scan``, ``channel_tile``) in the traced window of
the run's first card.  Moves ``chip_msps``."""

import re

from bounds import flagship_bound

K1 = re.compile(r"\b(dc_chunk|carry_scan|channel_tile)\b")


def read(run):
    s = run["summaries"][0]
    t = sum(v["device_s"] for k, v in s["kernels"].items() if K1.search(k))
    if t <= 0:
        return None
    bound_s = flagship_bound(run["block"], run["config"]["nch"], cu8=True)["bound_ms"] / 1e3
    return 100.0 * bound_s / (t / s["steps"])
