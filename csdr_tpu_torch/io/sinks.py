"""Sample sinks: callables fed trimmed numpy arrays by the runtime;
``close()`` finalizes headers.

Copied from ``csdr_tpu/io/sinks.py`` (``RawFileSink``, ``AudioFileSink``,
``ChannelFileSinks``, ``BranchSinks``, ``CollectSink``, ``NullSink``), numpy
only: a graph emits one array per block, or a tuple of them from a ``Tee``,
which ``BranchSinks`` routes one branch per sink."""

from __future__ import annotations

import numpy as np

from . import wav as wavio

__all__ = ["RawFileSink", "AudioFileSink", "ChannelFileSinks", "BranchSinks", "NullSink",
           "CollectSink"]


class SinkBase:
    def __call__(self, data):
        raise NotImplementedError

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RawFileSink(SinkBase):
    """Raw little-endian sample writer (.cf32 complex64 / .f32 float32)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")

    def __call__(self, data):
        np.asarray(data).tofile(self.f)

    def close(self):
        self.f.close()


class AudioFileSink(SinkBase):
    """Float32 WAV writer; interleaves (n,) mono or (channels, n)
    runtime-layout blocks."""

    def __init__(self, path: str, sample_rate: int, channels: int = 1):
        if not path.endswith(".wav"):
            path += ".wav"
        self.w = wavio.WavWriter(path, sample_rate, channels)
        self.channels = int(channels)
        self.path = path

    def __call__(self, data):
        data = np.asarray(data)
        if data.ndim == 2 and data.shape[0] == self.channels > 1:
            data = data.T  # (channels, n) runtime layout → interleaved frames
        self.w.write(data)

    def close(self):
        self.w.close()


class ChannelFileSinks(SinkBase):
    """Fan a (nch, n) channelized block out to per-channel sinks (files
    name_ch1 .. name_chN)."""

    def __init__(self, make_sink, nch: int):
        self.sinks = [make_sink(i) for i in range(nch)]

    def __call__(self, data):
        arr = np.asarray(data)
        for i, s in enumerate(self.sinks):
            s(arr[i])

    def close(self):
        for s in self.sinks:
            s.close()


class BranchSinks(SinkBase):
    """Route a tuple-output graph (a ``Tee``, multi-rate ones included) to
    one sink per branch: element i of every output tuple goes to
    ``sinks[i]``, so each branch keeps its own rate and file."""

    def __init__(self, *sinks):
        self.sinks = sinks

    def __call__(self, data):
        if not isinstance(data, tuple) or len(data) != len(self.sinks):
            raise TypeError(f"BranchSinks expects a {len(self.sinks)}-tuple per block, "
                            f"got {type(data).__name__}")
        for s, d in zip(self.sinks, data):
            s(d)

    def close(self):
        for s in self.sinks:
            s.close()


class NullSink(SinkBase):
    """Count the samples per stream and drop them."""

    def __init__(self):
        self.samples = 0

    def __call__(self, data):
        self.samples += np.asarray(data).shape[-1]


class CollectSink(SinkBase):
    """Accumulate outputs in memory.  ``concat()`` joins them leaf by leaf
    along the last axis, so a ``Tee`` graph's tuple (or a dict) of outputs
    comes back as one array per leaf; a run that collected nothing returns
    a flat ``np.zeros(0)``, whatever the graph's output structure."""

    def __init__(self):
        self.parts: list = []

    def __call__(self, data):
        self.parts.append(_tree_map(_host, data))

    def concat(self):
        if not self.parts:
            return np.zeros(0)
        return _tree_map(lambda *xs: np.concatenate(xs, axis=-1), *self.parts)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is moved off its device)."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured tuple/list/dict trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)
