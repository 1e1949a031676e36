"""launches_per_block (launches): the CUDA launch calls the host made in
the traced window ÷ the blocks it ran, on the run's first card (the
profiler's runtime and driver launch calls).  The chain's launch-bound share of the
host's work; moves the cell's rate."""


def read(run):
    s = run["summaries"][0]
    return s["launch_calls"] / s["steps"] if s["steps"] else None
