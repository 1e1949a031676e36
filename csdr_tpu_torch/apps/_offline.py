"""What the offline decoders share: the ``--device`` option and one
Pipeline run of a graph over a file source into a ``CollectSink``."""

from __future__ import annotations

import argparse
import sys

import torch

from ..core.runtime import Pipeline
from ..io.sinks import CollectSink

__all__ = ["add_device", "collect"]


def add_device(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="Device the graph runs on (cuda never falls back to cpu)")


def collect(graph, source, block_size: int, device: str):
    """Run ``graph`` over ``source`` on ``device``; returns the collected
    output (``CollectSink.concat()``), or None (with a message on stderr)
    when ``device`` is cuda and there is no card."""
    if device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu)", file=sys.stderr)
        return None
    sink = CollectSink()
    Pipeline(graph, block_size=block_size, device=device).run(source, sink)
    return sink.concat()
