"""Reading a ``torch.profiler`` trace of a traced window.

``trace_events``, ``device_kernels`` and ``launch_calls`` are frozen
copies of ``chip_smoke.py``'s (the Kineto events read once; kernels less
copies, sets and ProcessGroupNCCL's ranges; the host's launch calls),
with each event's start kept.  ``busy_union`` replaces ``chip_smoke.py``
``idle_share``'s sum of kernel times: the device is busy where any kernel
or copy runs, the union of their intervals, so overlapping work is counted
once and copies count.  ``summarize`` reduces one traced window to plain
numbers that a metric reader, another process or the result line can take.
"""

from __future__ import annotations

from contextlib import contextmanager

WINDOW = "portbench.window"


def trace_events(prof) -> list[tuple[str, bool, float, float]]:
    """(name, on the device, start µs, duration µs) of every event of a
    torch.profiler run, read once from its Kineto results.  The device's
    mirrors of host ranges (user annotations, such as the window's own
    range) are no device work and are left out."""
    if not hasattr(prof, "_portbench_events"):
        prof._portbench_events = [
            (e.name(), str(e.device_type()).endswith("CUDA"), e.start_ns() / 1e3,
             e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if not (str(e.device_type()).endswith("CUDA") and _annotation(e))]
    return prof._portbench_events


def _annotation(e) -> bool:
    try:
        return bool(e.is_user_annotation()) or e.name() == WINDOW
    except AttributeError:
        return e.name() == WINDOW


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _is_kernel(name: str) -> bool:
    return "ProfilerStep" not in name and not name.startswith(("aten::", "Memcpy", "Memset",
                                                               "nccl:"))


def device_kernels(prof) -> dict:
    """Kernel name → dict(count, device_us) of a torch.profiler run: the
    device events, less copies, sets and the ranges ProcessGroupNCCL
    records around its kernels ("nccl:broadcast", …)."""
    kern = {}
    for name, on_device, _, us in trace_events(prof):
        if on_device and _is_kernel(name):
            k = kern.setdefault(name, dict(count=0, device_us=0.0))
            k["count"] += 1
            k["device_us"] += us
    return kern


def launch_calls(prof) -> int:
    """Kernel launches the host made in a torch.profiler run: the CUDA
    runtime's and driver's launch calls in its trace."""
    return sum(1 for name, on_device, _, _ in trace_events(prof)
               if not on_device and name.startswith(("cudaLaunch", "cuLaunch")))


def busy_union(intervals: list[tuple[float, float]], lo: float, hi: float
               ) -> tuple[float, list[tuple[float, float]]]:
    """(the length of the union of [start, end) intervals inside [lo, hi],
    the gaps of [lo, hi] that no interval covers)."""
    busy, gaps, at = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        if e > at:
            busy += e - max(s, at)
            at = e
    if hi > at:
        gaps.append((at, hi))
    return busy, gaps


@contextmanager
def window_range():
    """A host range that marks the traced window in the trace."""
    from torch.profiler import record_function

    with record_function(WINDOW):
        yield


def summarize(prof, steps: int, top: int = 10) -> dict:
    """The numbers of one traced window of ``steps`` blocks: kernels by
    name, launch calls, device-busy and window seconds (the window is the
    host range ``window_range`` marked), and for the breakdown the device
    operations that took the most time and the longest idle gaps, each
    with the innermost host call at its middle (or "after" the last host
    call that ended before it)."""
    ev = trace_events(prof)
    win = [(s, s + d) for name, on_dev, s, d in ev if not on_dev and name == WINDOW]
    if not win:
        # a trace of the device alone (no host ranges): the window runs from
        # the first host call CUPTI saw to the end of the last
        win = [(min(s for _, on_dev, s, _ in ev if not on_dev),
                max(s + d for _, on_dev, s, d in ev if not on_dev))]
    lo, hi = win[0]
    dev = [(name, s, d) for name, on_dev, s, d in ev if on_dev and (_is_kernel(name)
                                                                     or _is_copy(name))]
    busy_us, gaps = busy_union([(s, s + d) for _, s, d in dev], lo, hi)
    kern = device_kernels(prof)
    ops: dict = {}
    for name, _, d in dev:
        ops[name] = ops.get(name, 0.0) + d / 1e6
    host = [(name, s, d) for name, on_dev, s, d in ev
            if not on_dev and name != WINDOW and "ProfilerStep" not in name]
    idle = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (g0 + g1) / 2
        inside = [(d, name) for name, s, d in host if s <= mid < s + d]
        before = [(s + d, name) for name, s, d in host if s + d <= mid]
        what = (min(inside)[1] if inside else f"after {max(before)[1]}" if before
                else "(no host call)")
        idle.append([what, (g1 - g0) / 1e6])
    return dict(
        steps=steps, window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
        launch_calls=launch_calls(prof),
        kernels={k: dict(count=v["count"], device_s=v["device_us"] / 1e6)
                 for k, v in kern.items()},
        copies_s=sum(d for name, _, d in dev if _is_copy(name)) / 1e6,
        device_ops=sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
        idle_gaps=idle)


def complete(summary: dict) -> bool:
    """Whether the trace holds a device kernel for every launch call (the
    tracer now and then drops kernel records)."""
    n = sum(v["count"] for v in summary["kernels"].values())
    return n >= summary["launch_calls"]
