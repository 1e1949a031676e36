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

Host→device copies go from pinned buffers with ``non_blocking=True``; each
block's output leaves come back the same way into fresh pinned buffers, and
are handed to the sink one step later, after the next block was queued.

``Pipeline(profile=True)`` runs each stage of a ``Chain`` as its own step
with a device barrier around it and keeps a ``StageStat`` per stage
(``stage_stats``, ``profile_report``); its output equals the unprofiled
run's bit for bit.
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

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


class Pipeline:
    """Streaming executor for a Block graph on one explicit device.

    ``profile=True`` times every stage of a ``Chain`` (a lone block is one
    stage) on its own: a device barrier before the block and after each
    stage, the host clock between them, the stage's input samples counted
    at its own rate; the first call of each stage is counted apart."""

    def __init__(self, block: Block, block_size: int = DEFAULT_BLOCK, *,
                 device: torch.device | str, profile: bool = False):
        g = block.granule
        self.block = block
        self.block_size = max(g, (block_size // g) * g)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.state = block.init(self.device)
        self.profile = profile
        self.stage_stats: list = []
        if profile:
            from ..utils.prof import StageStat

            self._stages = list(block.blocks) if isinstance(block, Chain) else [block]
            self._stage_in_rate, acc = [], Fraction(1)
            for b in self._stages:
                self._stage_in_rate.append(acc)
                acc *= b.rate
            self.stage_stats = [StageStat(b.name or type(b).__name__) for b in self._stages]

    def _to_device(self, chunk: np.ndarray) -> torch.Tensor:
        cuda = self.device.type == "cuda"
        dtype = torch.from_numpy(np.empty(0, chunk.dtype)).dtype
        stage = torch.empty(chunk.shape, dtype=dtype, pin_memory=cuda)
        stage.numpy()[...] = chunk
        # the pinned allocator keeps the buffer until the async copy is done
        return stage.to(self.device, non_blocking=True) if cuda else stage

    def process_block(self, x: np.ndarray):
        """One graph step on a host block; returns the output (a tensor, or a
        tuple of them) on the device."""
        if self.profile:
            return self._process_profiled(self._to_device(x))
        self.state, y = self.block.apply(self.state, self._to_device(x))
        return y

    def _barrier(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _process_profiled(self, x: torch.Tensor):
        """The same stages as ``Chain.apply``, in the same order, each timed
        between two device barriers."""
        split = isinstance(self.block, Chain)
        states = list(self.state) if split else [self.state]
        n_in = x.shape[0]
        self._barrier()
        y = x
        for i, b in enumerate(self._stages):
            t0 = time.perf_counter()
            states[i], y = b.apply(states[i], y)
            self._barrier()
            r = self._stage_in_rate[i]
            self.stage_stats[i].add(time.perf_counter() - t0, n_in * r.numerator // r.denominator)
        self.state = tuple(states) if split else states[0]
        return y

    def profile_report(self) -> str:
        """The per-stage budget table of a ``profile=True`` run."""
        from ..utils.prof import stage_table

        if not self.stage_stats:
            return "(profiling disabled: construct Pipeline(profile=True))"
        return stage_table(self.stage_stats)

    def _to_host(self, y):
        """Queue the device→host copy of every output leaf; returns (host
        tree, event that marks the copies done)."""
        if self.device.type != "cuda":
            return y, None

        def copy(leaf: torch.Tensor) -> torch.Tensor:
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            return host

        host = _map_tree(copy, y)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _steps(self, source: Iterable[np.ndarray], checkpoint_every: int = 0):
        """The feed/drain loop: yields (count, host output) per block, count
        being the first output leaf's trimmed sample count, one step late.
        With ``checkpoint_every`` (input samples) it also yields
        (None, position) once every output of the ``position`` input samples
        consumed so far was yielded and before the next block is queued:
        the one moment the state and the drained output agree."""
        n = self.block_size
        rate = self.block.rate_tree()
        pending = None  # (host output, copy-done event, valid input rows)
        total_in = last_ckpt = 0
        for chunk in rechunk(source, n):
            valid = len(chunk)
            if valid < n:
                chunk = np.pad(chunk, [(0, n - valid)] + [(0, 0)] * (chunk.ndim - 1))
            host, done = self._to_host(self.process_block(chunk))
            if pending is not None:
                yield _finish(*pending, rate)
            pending = (host, done, valid)
            total_in += valid
            if checkpoint_every and total_in - last_ckpt >= checkpoint_every:
                yield _finish(*pending, rate)
                pending = None
                yield None, total_in
                last_ckpt = total_in
        if pending is not None:
            yield _finish(*pending, rate)

    def stream(self, source: Iterable[np.ndarray]) -> Iterator:
        """Stream source → graph, yielding each block's host output (numpy,
        or a tuple of them) trimmed leaf by leaf to its rational-rate count,
        one step late so host I/O overlaps the next block.  The final short
        block is zero-padded to the static block size.  No flush: ``run``
        appends it, and a front-end pipeline that feeds another owes none."""
        for _, out in self._steps(source):
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
        for k, out in self._steps(it, every):
            if k is None:
                from . import checkpoint

                checkpoint.save_pipeline(checkpoint_path, self, position=out)
                continue
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
    if done is not None:
        done.synchronize()
    out, k = _trim_tree(_map_tree(lambda t: t.numpy(), host), rate, valid_in)
    return k, out
