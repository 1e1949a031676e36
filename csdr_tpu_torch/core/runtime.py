"""Streaming runtime: the host feed/drain loop around a Block graph.

Counterpart of ``csdr_tpu/core/runtime.py`` (``Pipeline`` with ``run`` and
``stream``, ``rechunk``, ``take_n``, ``append_flush``).  What it keeps:

  * a static block size, a multiple of the graph's granule;
  * zero-padding of the last short block, with the output trimmed to the
    exact rational-rate sample count;
  * the end-of-stream flush allowance (``Block.flush_len``);
  * draining one step late, so host I/O overlaps device compute.

What it drops: the JAX package's complex-free jit boundary (``CEnc``,
``encode_tree``) and the jit itself — PyTorch runs eagerly, and its CUDA
transfers carry complex64 as is.

Host→device copies go from pinned buffers with ``non_blocking=True``; each
block's output comes back the same way into a fresh pinned buffer, and is
handed to the sink one step later, after the next block was queued.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .block import Block

__all__ = ["Pipeline", "rechunk", "take_n", "append_flush", "DEFAULT_BLOCK"]

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


class Pipeline:
    """Streaming executor for a Block graph on one explicit device."""

    def __init__(self, block: Block, block_size: int = DEFAULT_BLOCK, *,
                 device: torch.device | str):
        g = block.granule
        self.block = block
        self.block_size = max(g, (block_size // g) * g)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.state = block.init(self.device)

    def _to_device(self, chunk: np.ndarray) -> torch.Tensor:
        cuda = self.device.type == "cuda"
        dtype = torch.from_numpy(np.empty(0, chunk.dtype)).dtype
        stage = torch.empty(chunk.shape, dtype=dtype, pin_memory=cuda)
        stage.numpy()[...] = chunk
        # the pinned allocator keeps the buffer until the async copy is done
        return stage.to(self.device, non_blocking=True) if cuda else stage

    def process_block(self, x: np.ndarray) -> torch.Tensor:
        """One graph step on a host block; returns the output on the device."""
        self.state, y = self.block.apply(self.state, self._to_device(x))
        return y

    def _to_host(self, y: torch.Tensor):
        """Queue the device→host copy of one output; returns (host tensor,
        event that marks the copy done)."""
        if y.device.type != "cuda":
            return y, None
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(y.device))
        return host, done

    def stream(self, source: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Stream source → graph, yielding each block's host output trimmed
        to its exact rational-rate count, one step late so host I/O overlaps
        the next block.  The final short block is zero-padded to the static
        block size.  No flush: ``run`` appends it, and a front-end pipeline
        that feeds another one owes none."""
        n = self.block_size
        rate = self.block.rate_tree()
        pending = None  # (host output, copy-done event, valid input rows)
        for chunk in rechunk(source, n):
            valid = len(chunk)
            if valid < n:
                chunk = np.pad(chunk, [(0, n - valid)] + [(0, 0)] * (chunk.ndim - 1))
            host, done = self._to_host(self.process_block(chunk))
            if pending is not None:
                yield _finish(*pending, rate)
            pending = (host, done, valid)
        if pending is not None:
            yield _finish(*pending, rate)

    def run(self, source: Iterable[np.ndarray], sink: Callable[[np.ndarray], None],
            num_samples: int | None = None) -> int:
        """Stream source (cut to ``num_samples``) → graph → sink, with the
        graph's flush allowance of zeros after the source; returns the output
        samples per stream."""
        it: Iterable[np.ndarray] = source
        if num_samples is not None:
            it = take_n(it, num_samples)
        nflush = self.block.flush_len()
        if nflush:
            it = append_flush(it, nflush)
        total_out = 0
        for out in self.stream(it):
            sink(out)
            total_out += out.shape[-1]
        return total_out


def _trim(a: np.ndarray, rate: Fraction, valid_in: int) -> np.ndarray:
    """Trim an output to its rational-rate sample count, along the last axis
    for channelized (nch, n) outputs and the leading axis otherwise."""
    k = (valid_in * rate.numerator) // rate.denominator
    return a[..., :k] if a.ndim >= 2 else a[:k]


def _finish(host: torch.Tensor, done, valid_in: int, rate: Fraction) -> np.ndarray:
    """Wait for one output's copy and trim it."""
    if done is not None:
        done.synchronize()
    return _trim(host.numpy(), rate, valid_in)
