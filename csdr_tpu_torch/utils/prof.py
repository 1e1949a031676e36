"""Profiling and observability: one span-and-counter recorder.

Counterpart of ``csdr_tpu/utils/prof.py``.  The recorder keeps, in memory,

  * spans: a name, a start and an end, the id of the span it nests under
    and the number of the Pipeline step it belongs to (every span of one
    step shares it; step k feeds block k and drains block k−1's output);
  * counters: the bytes the Pipeline hands the device and takes back, and
    the samples K1's channel pass stages (``ops/cuda/flagship_fused``).

Spans are stamped with the clock ``torch.profiler`` stamps its host and
CUDA-runtime events with (Kineto's approximate clock,
``torch._C._profiler._get_approximate_time``) and converted to Unix
nanoseconds at read-out the way the profiler converts its own (c10's
``ApproximateClockToUnixTimeConverter``: a line through (clock, Unix time)
pairs taken when the recorder starts and when it is first read), so a span
lines up with a device trace with no offset to fit.

The sites: ``core/runtime.Pipeline`` (``pipeline.block``, the root of a
step, over ``pipeline.stage``, ``pipeline.h2d``, ``pipeline.apply``,
``pipeline.d2h``, ``pipeline.drain_wait``, ``pipeline.trim``; then
``pipeline.sink`` and ``pipeline.checkpoint``, roots of their own) and
``core/block.Chain.apply`` (one span per stage, named by the Block, nested
under ``pipeline.apply``; ``PerChannel``'s inner chain nests under its
stage).  Below ``pipeline.apply`` on a CUDA device a stage span also records
a pair of CUDA events on the current stream around the stage; their
interval, the stage's span of the device's timeline, is read at read-out,
after the caller's own synchronise, never in the step.

When it records: while a ``torch.profiler`` session is active (into
``SESSION``, whose spans also go out as host ranges, ``record_function``'s
fast form, so a Chrome trace that records host ranges shows them above the
kernels they launched), and inside ``recording()`` (into the ``Recorder``
it yields).  Otherwise a site costs one flag test: no allocation, no clock
read, no CUDA call.  Spans are recorded from one thread.

``Pipeline(profile=True)`` records into a ``Recorder`` of its own and folds
it into ``StageStat``s; ``stage_table`` prints them.  ``trace(logdir)``
writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _profiler

try:   # Kineto's approximate clock (a TSC read where there is one)
    from torch._C._profiler import _get_approximate_time
except ImportError:   # a build without it: the Unix clock Kineto converts to
    _get_approximate_time = time.time_ns
try:   # a host range at ~1 µs, where record_function's op dispatch takes ~10
    from torch._C._profiler import _RecordFunctionFast as _host_range
except ImportError:
    _host_range = _profiler.record_function

__all__ = ["Span", "Recorder", "SESSION", "OFF", "recording", "span", "stage", "count",
           "count_bytes", "StageStat", "stage_table", "trace"]


@dataclass(frozen=True)
class Span:
    """A finished span as read out: times in Unix ns on the profiler's
    clock; ``device_ms`` the interval between the stage's CUDA events (None
    off a card and for the Pipeline's own spans)."""

    id: int
    name: str
    parent: int | None
    block: int | None
    start_ns: int
    end_ns: int
    device_ms: float | None = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Recorder:
    """Spans (in the order they opened) and counters, held until read."""

    def __init__(self):
        self.clear()

    def clear(self):
        self._raw: list[_Open] = []
        self.counters: dict[str, int] = {}
        self._clock = _UnixClock()

    def __len__(self) -> int:
        return len(self._raw)

    def read(self, upto: int | None = None, *, pop: bool = False) -> list[Span]:
        """The finished spans among the first ``upto`` opened (all by
        default); ``pop`` drops those ``upto`` from the recorder."""
        raw = self._raw[:upto]
        if pop:
            del self._raw[:len(raw)]
        return self._finished(raw)

    def last_run(self) -> list[Span]:
        """The finished spans of the latest Pipeline run: from its step 0's
        root on."""
        for i in range(len(self._raw) - 1, -1, -1):
            r = self._raw[i]
            if r.name == "pipeline.block" and r.block == 0:
                return self._finished(self._raw[i:])
        return []

    def _finished(self, raw: list) -> list[Span]:
        """Read-out: times converted to Unix ns, each stage's device interval
        read from its events (a synchronise on an event that is done costs
        nothing)."""
        out = []
        for r in raw:
            if r.t1 is None:
                continue
            dev = None
            if r.events is not None:
                r.events[1].synchronize()
                dev = r.events[0].elapsed_time(r.events[1])
            out.append(Span(r.id, r.name, r.parent, r.block, self._clock.to_unix_ns(r.t0),
                            self._clock.to_unix_ns(r.t1), dev))
        return out


class _UnixClock:
    """Approximate-clock stamps to Unix ns, as c10's
    ``ApproximateClockToUnixTimeConverter`` does it: a line through the
    tightest of a few (clock, ``time.time_ns()``) pairs taken at start and
    again at the first conversion."""

    def __init__(self):
        self._start = _pair()
        self._line = None

    def to_unix_ns(self, t: int) -> int:
        if _get_approximate_time is time.time_ns:
            return t
        if self._line is None:
            (a0, u0), (a1, u1) = self._start, _pair()
            self._line = (a0, u0, (u1 - u0) / (a1 - a0) if a1 > a0 else 1.0)
        a0, u0, slope = self._line
        return u0 + round((t - a0) * slope)


def _pair(tries: int = 9) -> tuple[int, int]:
    best = None
    for _ in range(tries):
        a0 = _get_approximate_time()
        u = time.time_ns()
        a1 = _get_approximate_time()
        if best is None or a1 - a0 < best[0]:
            best = (a1 - a0, (a0 + a1) // 2, u)
    return best[1], best[2]


SESSION = Recorder()   # what a torch.profiler session records
_targets: list[Recorder] = []   # the active recording() contexts
_stack: list["_Open"] = []      # the open spans, innermost last
_ids = itertools.count(1)
OFF = contextlib.nullcontext()  # what a site gets while nothing records


class _Open:
    """A span being recorded: its own context manager."""

    __slots__ = ("id", "name", "parent", "block", "timed", "t0", "t1", "events", "_device",
                 "_rf")

    def __init__(self, name: str, block: int | None, device, timed: bool = False):
        self.name, self.block, self._device, self.timed = name, block, device, timed
        self.t1 = self.events = self._rf = None

    def __enter__(self):
        top = _stack[-1] if _stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        if top is not None:
            self.block = top.block if self.block is None else self.block
            self.timed = self.timed or top.timed
        for rec in _recorders():
            rec._raw.append(self)
        _stack.append(self)
        self.t0 = _get_approximate_time()
        if _profiler._is_profiler_enabled:
            self._rf = _host_range(self.name)
            self._rf.__enter__()
        if self._device is not None and self.timed:
            stream = torch.cuda.current_stream(self._device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self._device))
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.t1 = _get_approximate_time()
        _stack.remove(self)
        self._device = self._rf = None
        return False


def _recorders() -> list[Recorder]:
    return _targets + [SESSION] if _profiler._is_profiler_enabled else _targets


def span(name: str, block: int | None = None, timed: bool = False):
    """A span around a ``with`` body (a shared no-op context when the
    recorder is off).  ``block`` numbers a root span's Pipeline step; a
    nested span takes its parent's.  Below a ``timed`` span (the Pipeline's
    ``pipeline.apply``) the stage spans on a card time the device."""
    if not (_targets or _profiler._is_profiler_enabled):
        return OFF
    return _Open(name, block, None, timed)


def stage(block, x):
    """A span around one Block stage of a graph, named by the Block; below a
    ``timed`` span and with ``x`` (the stage's input) on a CUDA device, also a
    pair of CUDA events on the current stream around it.  Elsewhere a stage
    records no events: two cost ~30 µs of host time under the profiler, more
    than a step of a kernel-paced loop of direct ``apply`` calls can spare."""
    if not (_targets or _profiler._is_profiler_enabled):
        return OFF
    leaf = x
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    dev = leaf.device if isinstance(leaf, torch.Tensor) and leaf.is_cuda else None
    return _Open(block.name or type(block).__name__, None, dev)


def count(name: str, n: int):
    """Add ``n`` to counter ``name`` of every recorder that records now."""
    if not (_targets or _profiler._is_profiler_enabled):
        return
    for rec in _recorders():
        rec.counters[name] = rec.counters.get(name, 0) + n


def count_bytes(name: str, tree):
    """Add the bytes of ``tree``'s leaves (arrays or tensors, in tuples) to
    counter ``name`` of every recorder that records now."""
    if _targets or _profiler._is_profiler_enabled:
        count(name, _nbytes(tree))


def _nbytes(tree) -> int:
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(t) for t in tree)
    return int(tree.nbytes)


@contextlib.contextmanager
def recording(rec: Recorder | None = None):
    """Record spans and counters into ``rec`` (a new Recorder by default,
    yielded) inside the ``with`` body, on top of any profiler session."""
    rec = Recorder() if rec is None else rec
    if any(r is rec for r in _targets):
        yield rec
        return
    _targets.append(rec)
    try:
        yield rec
    finally:
        _targets.remove(rec)


@dataclass
class StageStat:
    """One stage's time in ``Pipeline(profile=True)``.

    ``seconds`` is the stage's device interval on a card (the span of the
    device's timeline between its CUDA events, no barrier: it includes the
    device's idle time where the host queues the stage slower than the
    device runs it) and its host span on the CPU; ``host_seconds`` its host
    span.  The first call of each stage is counted apart
    (``compile_seconds``, the JAX package's name for it): on a card it also
    builds the CUDA kernels and warms the allocator.  ``samples`` counts the
    stage's INPUT samples (each stage's own rate basis), so per-stage MSPS
    compare with the stream meter at that point of the graph."""

    name: str
    seconds: float = 0.0
    samples: int = 0
    calls: int = 0
    compile_seconds: float = 0.0
    host_seconds: float = 0.0

    def add(self, dt: float, n_in: int, host: float = 0.0):
        self.calls += 1
        if self.calls == 1:
            self.compile_seconds = dt
            return
        self.seconds += dt
        self.samples += n_in
        self.host_seconds += host

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0


def stage_table(stats: list[StageStat], pipeline_ms: dict[str, float] | None = None,
                mb_per_block: dict[str, float] | None = None) -> str:
    """Budget table over a profiled run: which stage takes the time; with
    ``pipeline_ms`` the Pipeline's own spans (host ms per block) and with
    ``mb_per_block`` the MB copied per block each way."""
    total = sum(s.seconds for s in stats) or 1e-12
    w = max([len(s.name) for s in stats] + [len(k) for k in pipeline_ms or ()] + [5])
    lines = [f"{'stage':<{w}}  {'calls':>5}  {'time_s':>8}  {'MSPS_in':>9}  "
             f"{'pct':>5}  {'host_ms':>8}  {'compile_s':>9}"]
    for s in stats:
        n = s.calls - 1 if s.calls else 0
        lines.append(
            f"{s.name:<{w}}  {n:>5}  {s.seconds:>8.4f}  {s.msps:>9.2f}  "
            f"{100 * s.seconds / total:>4.1f}%  {1e3 * s.host_seconds / max(n, 1):>8.3f}  "
            f"{s.compile_seconds:>9.3f}")
    lines.append(f"{'TOTAL':<{w}}  {'':>5}  {total:>8.4f}")
    if pipeline_ms:
        lines.append(f"{'pipeline':<{w}}  host ms per block")
        lines += [f"{k:<{w}}  {v:>8.3f}" for k, v in pipeline_ms.items()]
    if mb_per_block:
        lines.append("MB copied per block: " + ", ".join(f"{k} {v:.3f}"
                                                        for k, v in mb_per_block.items()))
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a code region (the host, and the card when
    there is one); writes ``<logdir>/trace.json``, a Chrome trace that holds
    the program's spans as host ranges.  ``SESSION`` is cleared first, so
    afterwards it holds this session's spans."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    SESSION.clear()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
