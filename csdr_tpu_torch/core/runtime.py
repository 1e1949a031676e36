"""Streaming runtime: the host feed/drain loop around a Block graph.

Counterpart of ``csdr_tpu/core/runtime.py`` (``Pipeline`` with ``run`` and
``stream``, ``rechunk``, ``take_n``, ``skip_n``, ``append_flush``).  What it
keeps:

  * a static block size, a multiple of the graph's granule;
  * zero-padding of the last short block, with each output leaf trimmed to
    its exact rational-rate sample count (a Tee's branches each by their
    own rate, ``Block.rate_tree``);
  * the end-of-stream flush allowance (``Block.flush_len``);
  * draining one step late, so host I/O overlaps device compute;
  * periodic checkpoints (``core/checkpoint.py``), written only once the
    output of every input sample they cover is in the sink.

What it drops: the JAX package's complex-free jit boundary (``CEnc``,
``encode_tree``) and the jit itself — PyTorch runs eagerly, and its CUDA
transfers carry complex64 as is.

Host→device copies go with ``non_blocking=True`` from two pinned staging
buffers that take turns (``_Staging``), filled by torch's parallel copy; each
block's output leaves come back the same way into fresh pinned buffers, and
are handed to the sink one step later, after the next block was queued.

Tracing (``utils/prof``): while a ``torch.profiler`` session is active or
inside ``prof.recording()``, each step records its spans on the profiler's
clock (``pipeline.block``, the step's root, over ``pipeline.stage`` — the
pinned buffer, any wait for its last H2D copy, and the host copy into it —,
``pipeline.h2d``, ``pipeline.apply`` with a span per graph stage below it,
``pipeline.d2h``, ``pipeline.drain_wait`` — the wait for the previous
block's copies — and ``pipeline.trim``; then ``pipeline.sink`` and
``pipeline.checkpoint``) and counts the bytes handed to the device and back
(``pipeline.h2d_bytes``, ``pipeline.d2h_bytes``) and those staged into a
reused pinned buffer (``pipeline.stage_reused_bytes``); otherwise each site
costs one flag test.
``Pipeline(profile=True)`` records into a recorder of its own, with no
barrier, and folds it into a ``StageStat`` per stage (``stage_stats``,
``profile_report``); its output equals the unprofiled run's bit for bit.
"""

from __future__ import annotations

import warnings
from fractions import Fraction
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..utils import prof
from .block import Block, Chain, _map_tree

__all__ = ["Pipeline", "rechunk", "take_n", "skip_n", "append_flush", "DEFAULT_BLOCK"]

DEFAULT_BLOCK = 1 << 20


def rechunk(chunks: Iterable[np.ndarray], size: int) -> Iterator[np.ndarray]:
    """Re-block a stream of arbitrary-size arrays (along axis 0) into exact
    ``size`` arrays; the final short remainder is emitted as is."""
    buf: list[np.ndarray] = []
    have = 0
    for c in chunks:
        c = np.asarray(c)
        while True:
            if have + len(c) < size:
                if len(c):
                    buf.append(c)
                    have += len(c)
                break
            need = size - have
            buf.append(c[:need])
            yield np.concatenate(buf) if len(buf) > 1 else buf[0]
            buf, have = [], 0
            c = c[need:]
    if have:
        yield np.concatenate(buf) if len(buf) > 1 else buf[0]


def append_flush(chunks: Iterable[np.ndarray], nflush: int) -> Iterator[np.ndarray]:
    """Append the graph's end-of-stream zero fill (``Block.flush_len``)
    after the source is exhausted, matching the last chunk's dtype and row
    shape.  An empty source flushes nothing."""
    tail_shape: tuple = ()
    dtype = None
    for c in chunks:
        c = np.asarray(c)
        tail_shape, dtype = c.shape[1:], c.dtype
        yield c
    if nflush and dtype is not None:
        yield np.zeros((nflush,) + tail_shape, dtype)


def take_n(chunks: Iterable[np.ndarray], n: int) -> Iterator[np.ndarray]:
    """Trim a chunk stream to exactly n samples (rows)."""
    got = 0
    for c in chunks:
        if got + len(c) >= n:
            yield np.asarray(c)[: n - got]
            return
        got += len(c)
        yield c


def skip_n(chunks: Iterable[np.ndarray], n: int) -> Iterator[np.ndarray]:
    """Drop the first n samples (rows) of a chunk stream: the source seek of
    a resume, with n the position ``resume_pipeline`` returns."""
    dropped = 0
    it = iter(chunks)
    for c in it:
        if dropped + len(c) <= n:
            dropped += len(c)
            continue
        yield np.asarray(c)[n - dropped:]
        break
    yield from it


def _host_view(chunk: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``chunk``'s own memory, strides and all.  A
    read-only array (``np.frombuffer`` of the sources' bytes) is viewed
    too: the staging copy only reads it, so torch's warning that it is not
    writable does not apply.  Torch views no negative stride, so such an
    array is copied first."""
    if min(chunk.strides, default=0) < 0:
        chunk = chunk.copy()
    if chunk.flags.writeable:
        return torch.from_numpy(chunk)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(chunk)


class _Staging:
    """Host blocks onto one device, the staging step of ``Pipeline`` and of
    ``ShardedPipeline``'s rank 0.

    Each block is copied by ``Tensor.copy_``, which splits a large copy over
    torch's intra-op threads, into a contiguous tensor of its shape and
    dtype.  On the CPU that tensor is fresh for every block, since a graph
    may keep views of its input in its carried state.  On a card it is one
    of two pinned buffers that take turns: a buffer is refilled only after
    the event recorded behind its last H2D copy, queued two blocks earlier.
    A block of another shape or dtype gets a fresh buffer, which then takes
    its place in the ring.

    Spans and counters (``utils/prof``): ``pipeline.stage`` (the buffer, any
    wait for its event, and the copy), ``pipeline.h2d``; the bytes of every
    block (``pipeline.h2d_bytes``) and of those staged into a reused buffer
    (``pipeline.stage_reused_bytes``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ring: list = [None, None]   # (pinned buffer, its H2D copy's event) per turn
        self._turn = 0

    def __call__(self, chunk: np.ndarray) -> torch.Tensor:
        cuda = self.device.type == "cuda"
        with prof.span("pipeline.stage"):
            src = _host_view(chunk)
            slot = self._slot(src) if cuda else None
            buf = torch.empty(src.shape, dtype=src.dtype) if slot is None else slot[0]
            buf.copy_(src)
            prof.count_bytes("pipeline.h2d_bytes", chunk)
        if not cuda:
            return buf
        with prof.span("pipeline.h2d"):
            x = buf.to(self.device, non_blocking=True)
            slot[1].record(torch.cuda.current_stream(self.device))
        return x

    def _slot(self, src: torch.Tensor) -> tuple:
        """The ring's slot whose turn it is, its buffer free to refill."""
        k, self._turn = self._turn, 1 - self._turn
        slot = self.ring[k]
        if slot is not None and slot[0].shape == src.shape and slot[0].dtype == src.dtype:
            slot[1].synchronize()
            prof.count_bytes("pipeline.stage_reused_bytes", src)
            return slot
        self.ring[k] = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True),
                        torch.cuda.Event())
        return self.ring[k]


class Pipeline:
    """Streaming executor for a Block graph on one explicit device.

    ``profile=True`` records the Pipeline's spans (``utils/prof``) into a
    recorder of its own, with no barrier, and folds them into a
    ``StageStat`` per stage of a ``Chain`` (a lone block is one stage): the
    stage's device interval on a card, its host span on the CPU, its input
    samples counted at its own rate; the first call of each stage is counted
    apart."""

    def __init__(self, block: Block, block_size: int = DEFAULT_BLOCK, *,
                 device: torch.device | str, profile: bool = False):
        g = block.granule
        self.block = block
        self.block_size = max(g, (block_size // g) * g)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.state = block.init(self.device)
        self._staging = _Staging(self.device)
        self.profile = profile
        self._chain = isinstance(block, Chain)
        self._rec = prof.Recorder() if profile else None
        if profile:
            stages = list(block.blocks) if self._chain else [block]
            self._stage_in_rate, acc = [], Fraction(1)
            for b in stages:
                self._stage_in_rate.append(acc)
                acc *= b.rate
            self._stats = [prof.StageStat(b.name or type(b).__name__) for b in stages]
            self._pipe_s: dict[str, float] = {}   # span name -> host seconds, step 0 apart
            self._applied = self._applied_later = 0   # blocks applied: all; past step 0

    def _recording(self):
        """The Pipeline's own recorder while ``profile=True``."""
        return prof.recording(self._rec) if self._rec is not None else prof.OFF

    def process_block(self, x: np.ndarray):
        """One graph step on a host block; returns the output (a tensor, or a
        tuple of them) on the device."""
        with self._recording():
            x = self._staging(x)
            with prof.span("pipeline.apply", timed=True):
                if self._chain:
                    self.state, y = self.block.apply(self.state, x)
                else:   # a lone block is one stage
                    with prof.stage(self.block, x):
                        self.state, y = self.block.apply(self.state, x)
        return y

    @property
    def stage_stats(self) -> list:
        """The ``StageStat`` per stage of a ``profile=True`` Pipeline (empty
        without), read after the run."""
        if self._rec is None:
            return []
        self._fold(self._rec.read(pop=True))
        return self._stats

    def _fold(self, spans: list):
        """Fold read-out spans into the stage statistics and the Pipeline's
        own spans' totals (its first step apart)."""
        kids: dict = {}
        for s in spans:
            kids.setdefault(s.parent, []).append(s)
        for s in spans:
            if s.name == "pipeline.apply":
                self._applied += 1
                self._applied_later += s.block != 0
                for st, r, sp in zip(self._stats, self._stage_in_rate, kids.get(s.id, ())):
                    dt = sp.ms if sp.device_ms is None else sp.device_ms
                    st.add(dt / 1e3, self.block_size * r.numerator // r.denominator,
                           sp.ms / 1e3)
            if s.name.startswith("pipeline.") and s.block != 0:
                self._pipe_s[s.name] = self._pipe_s.get(s.name, 0.0) + s.ms / 1e3

    def profile_report(self) -> str:
        """The per-stage budget table of a ``profile=True`` run, with the
        Pipeline's own spans (host ms per block, step 0 apart) and the MB
        copied per block."""
        if self._rec is None:
            return "(profiling disabled: construct Pipeline(profile=True))"
        stats = self.stage_stats
        n, later = self._applied, self._applied_later
        pipe_ms = {k: 1e3 * t / later for k, t in self._pipe_s.items()} if later else None
        copied = {k.removeprefix("pipeline.").removesuffix("_bytes"): v / n / 1e6
                  for k, v in self._rec.counters.items()} if n else {}
        return prof.stage_table(stats, pipe_ms, copied or None)

    def _to_host(self, y):
        """Queue the device→host copy of every output leaf; returns (host
        tree, event that marks the copies done)."""
        prof.count_bytes("pipeline.d2h_bytes", y)
        if self.device.type != "cuda":
            return y, None

        def copy(leaf: torch.Tensor) -> torch.Tensor:
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            return host

        with prof.span("pipeline.d2h"):
            host = _map_tree(copy, y)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _steps(self, source: Iterable[np.ndarray], checkpoint_every: int = 0):
        """The feed/drain loop: yields (step, count, host output) per block,
        count being the first output leaf's trimmed sample count, one step
        late: step k feeds block k and drains block k−1.  With
        ``checkpoint_every`` (input samples) it also yields (step, None,
        position) once every output of the ``position`` input samples
        consumed so far was yielded and before the next block is queued:
        the one moment the state and the drained output agree.  Each step's
        work is the span ``pipeline.block``; what the caller does with a
        yield lies outside it."""
        n = self.block_size
        rate = self.block.rate_tree()
        pending = None  # (host output, copy-done event, valid input rows)
        total_in = last_ckpt = 0
        k = -1
        for k, chunk in enumerate(rechunk(source, n)):
            valid = len(chunk)
            if valid < n:
                chunk = np.pad(chunk, [(0, n - valid)] + [(0, 0)] * (chunk.ndim - 1))
            mark = len(self._rec) if self._rec is not None else 0
            with self._recording(), prof.span("pipeline.block", block=k):
                host, done = self._to_host(self.process_block(chunk))
                outs = [] if pending is None else [_finish(*pending, rate)]
                pending = (host, done, valid)
                total_in += valid
                ckpt = checkpoint_every and total_in - last_ckpt >= checkpoint_every
                if ckpt:
                    outs.append(_finish(*pending, rate))
                    pending = None
            if self._rec is not None:
                # every step before this one is drained: its events are done
                self._fold(self._rec.read(mark, pop=True))
            for out in outs:
                yield (k, *out)
            if ckpt:
                yield k, None, total_in
                last_ckpt = total_in
        if pending is not None:
            with self._recording(), prof.span("pipeline.block", block=k + 1):
                out = _finish(*pending, rate)
            yield (k + 1, *out)

    def stream(self, source: Iterable[np.ndarray]) -> Iterator:
        """Stream source → graph, yielding each block's host output (numpy,
        or a tuple of them) trimmed leaf by leaf to its rational-rate count,
        one step late so host I/O overlaps the next block.  The final short
        block is zero-padded to the static block size.  No flush: ``run``
        appends it, and a front-end pipeline that feeds another owes none."""
        for _, _, out in self._steps(source):
            yield out

    def run(self, source: Iterable[np.ndarray], sink: Callable, num_samples: int | None = None,
            checkpoint_path: str | None = None, checkpoint_every: int = 0) -> int:
        """Stream source (cut to ``num_samples``) → graph → sink, with the
        graph's flush allowance of zeros after the source; returns the
        output samples of the first output leaf.

        ``checkpoint_path`` with ``checkpoint_every`` (input samples): save a
        resumable checkpoint (``core/checkpoint.save_pipeline``) each time
        that many more input samples were consumed.  The pending block is
        drained into the sink first, so a checkpoint's position never runs
        ahead of the output already in the sink."""
        it: Iterable[np.ndarray] = source
        if num_samples is not None:
            it = take_n(it, num_samples)
        nflush = self.block.flush_len()
        if nflush:
            it = append_flush(it, nflush)
        every = checkpoint_every if checkpoint_path else 0
        total_out = 0
        for step, k, out in self._steps(it, every):
            if k is None:
                from . import checkpoint

                with self._recording(), prof.span("pipeline.checkpoint", block=step):
                    checkpoint.save_pipeline(checkpoint_path, self, position=out)
                continue
            with self._recording(), prof.span("pipeline.sink", block=step):
                sink(out)
            total_out += k
        return total_out


def _trim_tree(tree, rate, valid_in: int):
    """Trim every output leaf to its rational-rate sample count, along the
    last axis for channelized (nch, n) and stereo (2, n) leaves and the
    leading axis otherwise.  ``rate`` is a Fraction (shared by every leaf)
    or a tuple mirroring the output (a multi-rate Tee).  Returns (trimmed,
    the first leaf's count)."""
    if isinstance(rate, Fraction):
        k = (valid_in * rate.numerator) // rate.denominator
        return _map_tree(lambda a: a[..., :k] if a.ndim >= 2 else a[:k], tree), k
    trimmed, counts = zip(*(_trim_tree(t, r, valid_in) for t, r in zip(tree, rate)))
    return tuple(trimmed), counts[0]


def _finish(host, done, valid_in: int, rate):
    """Wait for one output's copies and trim it; returns (count, output)."""
    with prof.span("pipeline.drain_wait"):
        if done is not None:
            done.synchronize()
    with prof.span("pipeline.trim"):
        out, k = _trim_tree(_map_tree(lambda t: t.numpy(), host), rate, valid_in)
    return k, out
