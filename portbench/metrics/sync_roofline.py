"""sync_roofline (%): the block symbol sync's roofline share,
``sync_scan_bound`` at the cell's block (rows = nch, each row of H + n/nch
samples read once, (n/nch // k)·2 float32 outputs written once, the npfb ×
W bank once; W = 2·m·k + 1) over the sync stage's device interval per
block, as ``sync_device_ms.served`` reads it.  The same work whatever
implements it, so it reads a program that runs the sync in eager ops too.
None where that interval is missing.  Moves ``msps``."""

import harness
from bounds import sync_scan_bound


def bound_ms(config: dict, block: int) -> float:
    """``sync_scan_bound``'s least time in ms for one block of the cell."""
    k, m, nch = config["sync_k"], config["sync_m"], config["nch"]
    H = 2 * m * k + 2 * k + 2 * 5 * k     # SymSync's history: the span, k and B = 5k each side
    n = block // nch
    return sync_scan_bound(rows=nch, L=H + n, nout=(n // k) * 2, W=2 * m * k + 1,
                           npfb=config["sync_npfb"], cplx=False)["bound_ms"]


def read(run):
    dev_ms = harness.read_metric("sync_device_ms.served", run)
    if not dev_ms:
        return None
    return 100.0 * bound_ms(run["config"], run["block"]) / dev_ms
