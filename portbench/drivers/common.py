"""What the drivers share: the card's identity, the traced window with its
retries, and the warm-up."""

from __future__ import annotations

import subprocess
import time

import tracing


def card(torch, device, count: int) -> dict:
    """The result's ``device`` block, less the peak: the card's name and
    the power limit ``nvidia-smi`` reads (beside every number), or the CPU
    of a test run."""
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count)
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=count)
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                            "nounits", "-i", str(device.index or 0)], capture_output=True,
                           text=True, timeout=30)
        out["power_limit_w"] = float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        out["power_limit_w"] = None
    return out


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_reset(torch, device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(torch, device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def traced(torch, device, fn, steps: int, tries: int = 3) -> tuple[object, dict]:
    """``fn()`` (which runs ``steps`` blocks and returns what it kept) under
    torch.profiler, ended by a synchronise.  On a card the profiler traces
    the device and the CUDA runtime only: recording every PyTorch op on the
    host would slow a launch-bound host and read as device idle time.  A
    session whose trace lost kernel records is run again, up to ``tries``
    times.  Returns (fn's last result, the trace summary)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    for i in range(tries):
        sync(torch, device)
        with profile(activities=acts) as prof:
            with tracing.window_range():
                t0 = time.perf_counter()
                kept = fn()
                sync(torch, device)
                wall = time.perf_counter() - t0
        summ = tracing.summarize(prof, steps)
        summ["wall_s"], summ["sessions"] = wall, i + 1
        if tracing.complete(summ):
            break
    return kept, summ
