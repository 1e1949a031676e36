"""BENCHMARK.json against the benchmark's contract and its own files."""

import json
import re
from pathlib import Path

import pytest

import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    texts = [c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
    texts += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    man = harness.load_manifest(cell)
    assert (harness.HERE / "traffic" / f"{cell}.json").exists()
    assert (harness.HERE / "reference" / f"{man['config']['reference']}.py").exists()
    assert (harness.HERE / "drivers" / f"{man['traffic']['driver']}.py").exists()
    conf = next(c for c in BENCH["configs"] if c["name"] == man["cell"]["config"])
    assert conf["file"].startswith("portbench/configs/")
    for k in conf["reduced"]:
        assert k in man["config"], k
    for m in man["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    man = harness.load_manifest(cell)
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert man["per_layer"]
    for m in man["per_layer"]:
        # a per-layer metric's cells each report the end-to-end metric it moves
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_config_files_are_only_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert (harness.ROOT / f).exists()


def test_layer_names_agree():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_rooflines_are_named_for_their_kernel():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_paths_hold_only_the_benchmark():
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in Path(p).parts and not p.endswith("_torch")
