"""device_ms_per_block.served (ms): the device time of every kernel in the
traced window ÷ the blocks it ran (copies apart).  The eager chain's and
the kernels' work per block; moves ``msps``."""


def read(run):
    s = run["summaries"][0]
    t = sum(v["device_s"] for v in s["kernels"].values())
    return 1e3 * t / s["steps"] if s["steps"] and t > 0 else None
