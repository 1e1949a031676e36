"""Runs of every cell on the CPU at tiny sizes, past the harness's look for
a card: the plain reference against the port's CPU path, the same run with
a fault planted under the timed path (``correct`` must come out false),
and the control (the reference one precision step down), which must fail
a limit at these sizes too."""

import math

import pytest
import torch

import control
import harness

TINY = {
    "nbfm64.resident": {"traffic": {"block": 65536, "keep": {"first": 3, "drawn": 2, "range": 10},
                                    "trace_steps": 6}},
    "heli64.served": {"traffic": {"block": 81920, "capture_blocks": 4, "warm": 1,
                                  "keep": {"first": 3, "drawn": 2, "range": 10},
                                  "trace_steps": 5}},
}
SEED = 2 ** 31 + 12345      # the driver's seeds pass 32 signed bits
CHANNEL_FAULTS = ("stale_state", "half_channels", "even_channels", "altered_answer")
FAULTS = [("nbfm64.resident", f) for f in CHANNEL_FAULTS]
FAULTS += [("heli64.served", f) for f in CHANNEL_FAULTS]


def _run(cell, trace=False, fault=None, seconds=0.5):
    harness.fix_caches()
    return harness.run_cell(cell, SEED, seconds, trace, device_type="cpu",
                            overrides=TINY[cell], fault=fault)


@pytest.mark.parametrize("cell", list(TINY))
def test_cell_is_correct_on_the_cpu_path(cell):
    out = _run(cell)
    line = harness.result_line(out, False)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    man = harness.load_manifest(cell)
    assert set(line["metrics"]) == {m["name"] for m in man["end_to_end"]}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("cell", list(TINY))
def test_traced_run_reports_its_layers(cell):
    out = _run(cell, trace=True)
    line = harness.result_line(out, True)
    assert line["correct"], line["checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # a reader that finds nothing to read (no kernels on the CPU) leaves its
    # metric out; it never reports 0 for a roofline share
    assert not any(k.endswith("_roofline") for k in line["metrics"])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = _run(cell, fault=fault)
    assert not out["correct"] and out["failed"] > 0, out["checks"]


@pytest.mark.parametrize("cell", list(TINY))
def test_the_control_fails_a_limit(cell):
    harness.fix_caches()
    man = harness.apply_overrides(harness.load_manifest(cell), TINY[cell])
    ref = harness.reference(man["config"])
    for seed in (SEED, 7):
        cases = control.control_cases(man, seed, torch.device("cpu"))
        readings = ref.judge(ref.control(cases, man["config"], man["traffic"]),
                             man["config"], man["traffic"])
        checks, bad = harness.judge(man, readings)
        assert bad > 0, checks
