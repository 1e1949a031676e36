"""Driver ``resident``: a ring of device-resident input blocks chained
through the graph's ``Block.apply``, the blocks dispatched ahead and the
window ended by ``torch.cuda.synchronize()``.

End to end: ``chip_msps``, the input samples of every block the window
issued over the window's length, and ``setup_s``.  Traffic keys:
``block`` (samples), ``ring`` (distinct blocks), ``warm`` (blocks run
before the window), ``keep`` (which blocks are compared, see
``harness.seeded_picks``), ``trace_steps`` (blocks in the traced window),
``signal`` and ``signal_args``.
"""

from __future__ import annotations

import time

import faults
import graphs
import harness
import signals
from drivers import common


def ring_block(tr: dict, seed: int, j: int, start: int, n: int, device):
    """Samples [start, start + n) of the ring's block ``j`` as cu8 rows on
    the device: the ring is one stream, ``ring`` blocks long, that repeats."""
    make = getattr(signals, tr["signal"])
    return signals.to_cu8(make(tr["signal_args"], seed, j * tr["block"] + start, n,
                               tr["ring"] * tr["block"], device))


def make_ring(tr: dict, seed: int, device, start: int = 0, n: int | None = None) -> list:
    """The ring's blocks: samples [start, start + n) of each."""
    n = tr["block"] if n is None else n
    return [ring_block(tr, seed, j, start, n, device) for j in range(tr["ring"])]


def chain_steps(torch, device, step, ring: list, keep: set, seconds: float | None,
                steps: int | None):
    """Steps ``state ← step(state, ring[s % R])`` from ``step``'s own
    initial state until ``steps`` blocks were issued or ``seconds`` passed,
    then a synchronise.  Returns (blocks issued, window seconds, {step:
    output} for the steps in ``keep``)."""
    state = step.init()
    kept, s, R = {}, 0, len(ring)
    common.sync(torch, device)
    t0 = time.perf_counter()
    deadline = t0 + (seconds if seconds is not None else float("inf"))
    while True:
        state, y = step(state, ring[s % R])
        if s in keep:
            kept[s] = y
        s += 1
        if (steps is not None and s >= steps) or time.perf_counter() >= deadline:
            break
    common.sync(torch, device)
    return s, time.perf_counter() - t0, kept


class GraphStep:
    """A graph's ``apply`` as a step function with its ``init``."""

    def __init__(self, graph, device):
        self.graph, self.device = graph, device

    def init(self):
        return self.graph.init(self.device)

    def __call__(self, state, x):
        return self.graph.apply(state, x)


def cases_of(kept: dict, ring: list) -> list:
    """A compared step's inputs: its block and the one before it (the
    stream's first block alone)."""
    R = len(ring)
    return [dict(step=s, inputs=([ring[(s - 1) % R]] if s else []) + [ring[s % R]], got=y)
            for s, y in sorted(kept.items())]


def control_cases(man: dict, seed: int, device) -> list:
    """The steps a run compares, their inputs without the program's
    outputs, for the control (``control.py``)."""
    tr = man["traffic"]
    R, blocks = tr["ring"], {}

    def blk(j):
        if j not in blocks:
            blocks[j] = ring_block(tr, seed, j, 0, tr["block"], device)
        return blocks[j]

    return [dict(step=s, inputs=([blk((s - 1) % R)] if s else []) + [blk(s % R)])
            for s in harness.seeded_picks(seed, tr["keep"])]


def run(man: dict, *, seed: int, seconds: float, trace: bool, device_type: str,
        fault: str | None, t_start: float) -> dict:
    import torch

    cfg, tr = man["config"], man["traffic"]
    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dev_info = common.card(torch, device, man["cell"]["chips"])
    ring = make_ring(tr, seed, device)
    step = faults.wrap(GraphStep(graphs.build(cfg["graph"]), device), fault)
    # warm-up: the cell's own shape, through the same step
    chain_steps(torch, device, step, ring, set(), None, tr["warm"])
    keep = set(harness.seeded_picks(seed, tr["keep"]))
    common.peak_reset(torch, device)
    setup_s = time.perf_counter() - t_start
    out = dict(device=dev_info)
    if trace:
        steps = tr["trace_steps"]
        kept, summ = common.traced(
            torch, device, lambda: chain_steps(torch, device, step, ring, keep, None, steps)[2],
            steps)
        out["trace"] = dict(summaries=[summ], spans={}, block=tr["block"])
        done = steps
    else:
        done, window, kept = chain_steps(torch, device, step, ring, keep, seconds, None)
        out["e2e"] = dict(chip_msps=done * tr["block"] / window / 1e6, setup_s=setup_s)
        out["window_s"] = window
    out["device"]["memory_peak_bytes"] = common.peak(torch, device)
    out["attempted"] = done
    out["cases"] = cases_of(kept, ring)
    return out
