"""The per-layer metrics read from the program's own spans
(``csdr_tpu_torch/utils/prof``): on the CPU, the tiny traced
``heli64.served`` run reports the host's spans and leaves the device
interval out; on a card (``-m cuda``), the spans and the profiler's trace
share one clock: every ``cudaEventSynchronize`` of a traced served window
lies inside ``pipeline.drain_wait``, every host-to-device
``cudaMemcpyAsync`` inside ``pipeline.h2d`` and every kernel launch call
inside ``pipeline.apply``, each to within 20 µs."""

import math

import pytest
import torch

import harness
from test_portbench_runs import SEED, TINY

HOST_SPANS = ("stage_ms.served", "apply_ms.served", "drain_wait_ms.served")
SLACK_NS = 20_000


def test_traced_served_run_reports_the_programs_spans():
    harness.fix_caches()
    out = harness.run_cell("heli64.served", SEED, 0.5, True, device_type="cpu",
                           overrides=TINY["heli64.served"])
    line = harness.result_line(out, True)
    assert line["correct"], line["checks"]
    for name in HOST_SPANS:
        v = line["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
    assert "sync_device_ms.served" not in line["metrics"]   # no CUDA events on the CPU


def _inside(t0: int, t1: int, spans: list) -> bool:
    return any(s.start_ns - SLACK_NS <= t0 and t1 <= s.end_ns + SLACK_NS for s in spans)


@pytest.mark.cuda
def test_spans_hold_the_runtime_calls_on_the_profilers_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    import graphs
    from csdr_tpu_torch.core.runtime import Pipeline
    from csdr_tpu_torch.utils import prof
    from drivers import served

    harness.fix_caches()
    man = harness.apply_overrides(harness.load_manifest("heli64.served"),
                                  {"traffic": {"block": 1 << 22}})
    dev = torch.device("cuda", 0)
    graph = graphs.build(man["config"]["graph"])
    n, blocks = served.capture_blocks(man, SEED, 4, graph.granule, dev)
    pipe = Pipeline(graph, n, device=dev)
    pipe.run(iter(blocks[:2]), lambda out: None)   # warm-up: the kernels' builds
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as p:   # as the harness traces
        pipe.run(iter(blocks * 2), lambda out: None)
        torch.cuda.synchronize(dev)
    spans = prof.SESSION.last_run()
    by = {name: [s for s in spans if s.name == name]
          for name in ("pipeline.drain_wait", "pipeline.h2d", "pipeline.apply")}
    assert len(by["pipeline.apply"]) == 8

    events = list(p.profiler.kineto_results.events())
    on_dev = lambda e: str(e.device_type()).endswith("CUDA")   # noqa: E731
    h2d = {e.correlation_id() for e in events if on_dev(e) and "HtoD" in e.name()}
    host = [(e.name(), e.correlation_id(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events if not on_dev(e)]
    rules = {
        "pipeline.drain_wait": [h for h in host if h[0] == "cudaEventSynchronize"],
        "pipeline.h2d": [h for h in host if h[0].startswith("cudaMemcpy") and h[1] in h2d],
        "pipeline.apply": [h for h in host if h[0].startswith(("cudaLaunch", "cuLaunch"))],
    }
    for name, calls in rules.items():
        assert calls, name
        outside = [c for c in calls if not _inside(c[2], c[3], by[name])]
        assert not outside, (name, len(outside), len(calls), outside[:3])
