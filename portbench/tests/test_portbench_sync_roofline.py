"""``sync_roofline``'s bound at ``heli64.served``'s block, against the
hand-worked figure, and its share over a stage interval."""

import json

import pytest

import harness

CONFIG = json.loads((harness.HERE / "configs" / "heli64.json").read_text())


def _metric():
    return harness.load_module(harness.HERE / "metrics" / "sync_roofline.py",
                               "portbench_metric_sync_roofline")


def test_sync_bound_at_heli64s_block():
    # 64 rows of H + n/64 = 200 + 262,080 float32 samples in (4 B), 52,416
    # outputs a row out (4 B), the 64 × 81 bank (4 B): 80,582,912 B over
    # 3.35 TB/s = 24.05 µs; 3,354,624 outputs × (81·2 + 12) FLOP = 0.584
    # GFLOP over 67 TFLOP/s = 8.7 µs, the smaller
    ms = _metric().bound_ms(CONFIG, CONFIG["block"])
    assert ms * 1e3 == pytest.approx(80582912 / 3.35e12 * 1e6, rel=1e-9)
    assert ms * 1e3 == pytest.approx(24.05, abs=0.01)


def test_share_over_the_stage_interval(monkeypatch):
    mod = _metric()
    run = dict(config=CONFIG, block=CONFIG["block"])
    monkeypatch.setattr(harness, "read_metric", lambda name, r: 2.4054600597)
    assert mod.read(run) == pytest.approx(1.0, rel=1e-6)
    monkeypatch.setattr(harness, "read_metric", lambda name, r: None)
    assert mod.read(run) is None
