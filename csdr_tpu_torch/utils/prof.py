"""Profiling and observability.

Counterpart of ``csdr_tpu/utils/prof.py``: a stream-level samples/s meter,
the per-stage statistics of ``Pipeline(profile=True)`` and their table, a
``torch.profiler`` trace context that writes a Chrome trace, and a
steady-state step timer (CUDA events on a card, ``perf_counter`` on the
CPU).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

__all__ = ["Meter", "StageStat", "stage_table", "trace", "timed_steps"]


@dataclass
class Meter:
    """Streaming throughput meter: feed it (samples, t) increments."""

    name: str = "stream"
    samples: int = 0
    seconds: float = 0.0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def tick(self, n_samples: int):
        now = time.perf_counter()
        if self._t0 is not None:
            self.seconds += now - self._t0
        self._t0 = now
        self.samples += n_samples

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0

    def report(self) -> str:
        return f"{self.name}: {self.samples} samples in {self.seconds:.3f}s = {self.msps:.2f} MSPS"


@dataclass
class StageStat:
    """One stage's time in ``Pipeline(profile=True)``.

    The first call of each stage is counted apart (``compile_seconds``, the
    JAX package's name for it): on a card it also builds the CUDA kernels
    and warms the allocator.  ``samples`` counts the stage's INPUT samples
    (each stage's own rate basis), so per-stage MSPS compare with the stream
    meter at that point of the graph."""

    name: str
    seconds: float = 0.0
    samples: int = 0
    calls: int = 0
    compile_seconds: float = 0.0

    def add(self, dt: float, n_in: int):
        self.calls += 1
        if self.calls == 1:
            self.compile_seconds = dt
            return
        self.seconds += dt
        self.samples += n_in

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0


def stage_table(stats: list[StageStat]) -> str:
    """Budget table over a profiled run: which stage takes the time."""
    total = sum(s.seconds for s in stats) or 1e-12
    w = max([len(s.name) for s in stats] + [5])
    lines = [f"{'stage':<{w}}  {'calls':>5}  {'time_s':>8}  {'MSPS_in':>9}  "
             f"{'pct':>5}  {'compile_s':>9}"]
    for s in stats:
        lines.append(
            f"{s.name:<{w}}  {s.calls - 1 if s.calls else 0:>5}  "
            f"{s.seconds:>8.4f}  {s.msps:>9.2f}  {100 * s.seconds / total:>4.1f}%  "
            f"{s.compile_seconds:>9.3f}")
    lines.append(f"{'TOTAL':<{w}}  {'':>5}  {total:>8.4f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a code region (the host, and the card when
    there is one); writes ``<logdir>/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed_steps(step_fn, state, x, iters: int = 10):
    """Steady-state time of ``state, y = step_fn(state, x)``, the first
    call (kernel builds, allocator warm-up) excluded.  On a CUDA ``x`` the
    time is CUDA events around ``iters`` queued steps; on the CPU the host
    clock.  Returns (seconds_per_step, final_state)."""
    state, _ = step_fn(state, x)
    if x.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(x.device)
        start.record()
        for _ in range(iters):
            state, _ = step_fn(state, x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, state
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = step_fn(state, x)
    return (time.perf_counter() - t0) / iters, state
