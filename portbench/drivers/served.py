"""Driver ``served``: a capture in host memory, looped, through the
program's ``core/runtime.Pipeline.run(source, sink)``, as an operator
processes a recording.

The source hands the Pipeline one block at a time and stamps it; the sink
stamps each block's host output as it arrives and keeps only what the
comparison needs.  End to end: ``msps``, the input samples of the blocks
whose outputs reached the sink within the window, over the window;
``block_p95_ms``, the 95th percentile over those blocks of the time from
the source's hand-over to the sink; and ``setup_s``.  Traffic keys:
``block`` (samples, rounded down to the graph's granule),
``capture_blocks``, ``warm``, ``keep``, ``trace_steps``, ``signal``,
``signal_args``.  The configuration's optional ``carried`` ({name: path})
names the leaves of the graph's state its reference reads: a compared
block gets them as the program carried them into it (``carried_before``,
past the first blocks) and out of it (``carried_after``).
"""

from __future__ import annotations

import statistics
import time

import numpy as np

import faults
import graphs
import harness
import signals
from drivers import common


def _leaves(state, carried: dict) -> dict:
    """{name: the state's leaf at the configuration's path for it}."""
    return {k: graphs.state_at(state, p).detach().cpu().numpy() for k, p in carried.items()}


def capture_blocks(man: dict, seed: int, nblocks: int, granule: int, device) -> tuple[int, list]:
    """(block length, the capture's first ``nblocks`` blocks as host cu8
    rows): the block rounded down to the graph's granule."""
    n = man["traffic"]["block"] // granule * granule
    cap = getattr(signals, man["traffic"]["signal"])(man["traffic"]["signal_args"], seed,
                                                       nblocks, n, device)
    return n, [cap[j * n:(j + 1) * n] for j in range(nblocks)]


def control_cases(man: dict, seed: int, device) -> list:
    """The blocks a run compares from the stream's start, without the
    program's outputs, for the control (``control.py``): it walks its own
    state from the start over them."""
    import torch

    first = man["traffic"]["keep"]["first"]
    granule = graphs.build(man["config"]["graph"]).granule
    _, blocks = capture_blocks(man, seed, first, granule, device)
    blocks = [torch.from_numpy(b).to(device) for b in blocks]
    return [dict(block=b, start=True, inputs=blocks[max(0, b - 1):b + 1]) for b in range(first)]


def run(man: dict, *, seed: int, seconds: float, trace: bool, device_type: str,
        fault: str | None, t_start: float) -> dict:
    import torch

    from csdr_tpu_torch.core.runtime import Pipeline

    cfg, tr = man["config"], man["traffic"]
    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dev_info = common.card(torch, device, man["cell"]["chips"])
    graph = graphs.build(cfg["graph"])
    nblk = tr["capture_blocks"]
    n, blocks = capture_blocks(man, seed, nblk, graph.granule, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if fault is not None:
        bad = faults.wrap(_Apply(graph), fault)
        graph.apply = lambda state, x: bad(state, x)
    pipe = Pipeline(graph, n, device=device)
    pipe.run(iter(blocks[:tr["warm"]]), lambda out: None)      # warm-up: the cell's shapes
    pipe.state = graph.init(device)
    common.sync(torch, device)
    keep = set(harness.seeded_picks(seed, tr["keep"]))
    need = keep | {b + 1 for b in keep}
    states, handed, arrived, kept = {}, [], [], {}
    spans: list = []
    limit = tr["trace_steps"] if trace else None

    window = {}

    def source():
        j = 0
        while (limit is None and time.perf_counter() < window["end"]) or (
                limit is not None and j < limit):
            if j in need:
                states[j] = pipe.state
            handed.append(time.perf_counter())
            yield blocks[j % nblk]
            j += 1

    def sink(out):
        i = len(arrived)
        arrived.append(time.perf_counter())
        if i in keep:
            kept[i] = np.array(out, copy=True)

    def serve():
        window["start"] = time.perf_counter()
        window["end"] = window["start"] + seconds
        pipe.run(source(), sink)
        return None

    common.peak_reset(torch, device)
    setup_s = time.perf_counter() - t_start
    out = dict(device=dev_info)
    if trace:
        # the host's spans in a run of their own, before the profiler's
        process = pipe.process_block

        def timed(x):
            t = time.perf_counter()
            y = process(x)
            spans.append(time.perf_counter() - t)
            return y

        pipe.process_block = timed
        serve()
        pipe.process_block = process

        def again():
            pipe.state = graph.init(device)
            states.clear(), handed.clear(), arrived.clear(), kept.clear()
            return serve()

        _, summ = common.traced(torch, device, again, limit)
        out["trace"] = dict(summaries=[summ], spans=dict(enqueue_s=spans), block=n)
    else:
        serve()
        end = window["end"]
        lat = [a - h for h, a in zip(handed, arrived) if a <= end]
        out["e2e"] = dict(msps=len(lat) * n / seconds / 1e6,
                          block_p95_ms=statistics.quantiles(lat, n=20)[18] * 1e3
                          if len(lat) >= 2 else float("inf"),
                          setup_s=setup_s)
    out["device"]["memory_peak_bytes"] = common.peak(torch, device)
    out["attempted"] = len(handed)
    final = pipe.state
    carried = cfg.get("carried", {})     # leaves of the graph's state the reference reads
    cases = []
    first = tr["keep"]["first"]
    for b in sorted(kept):
        inputs = [torch.from_numpy(blocks[j % nblk]).to(device) for j in ((b - 1, b) if b else (b,))]
        after = states.get(b + 1, final if b == len(handed) - 1 else None)
        c = dict(block=b, start=b < first, inputs=inputs, got=kept[b],
                 carried_after=None if after is None else _leaves(after, carried))
        if b >= first:
            c["carried_before"] = _leaves(states[b], carried)
        cases.append(c)
    # the start blocks are walked in order from the stream's start; a run too
    # short to reach one compares none of those after it
    starts = [c["block"] for c in cases if c["start"]]
    if starts != list(range(len(starts))):
        cases = [c for c in cases if not c["start"] or c["block"] < len(starts)]
    out["cases"] = cases
    return out


class _Apply:
    """A graph's ``apply`` as a step, for planting a fault under the
    Pipeline."""

    def __init__(self, graph):
        self.apply = graph.apply

    def __call__(self, state, x):
        return self.apply(state, x)
