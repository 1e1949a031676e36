"""The command line: no card, no result; no JAX anywhere in a run; the
reference independent of the port; and, on a card, each one-card cell's
short run."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness

RUN = [sys.executable, "portbench/run.py"]


def _cli(args, cwd=harness.ROOT, env=None):
    return subprocess.run(RUN + args, cwd=cwd, capture_output=True, text=True, timeout=600,
                          env=env)


def _no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


@pytest.mark.parametrize("cell", ["nbfm64.resident", "heli64.served"])
def test_without_a_card_it_exits_nonzero_and_prints_no_result(cell):
    r = _cli(["--workload", cell, "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
             env=_no_card_env())
    assert r.returncode == 2, r.stderr
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_in_a_directory_of_only_the_benchmark_it_exits_nonzero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(["--workload", "nbfm64.resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
             cwd=tmp_path, env=_no_card_env())
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_module_of_a_run_is_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = ['portbench', '.']\n"
        "import harness; harness.fix_caches()\n"
        "import run, control, signals, tracing, bounds, graphs, faults\n"
        "import drivers.resident, drivers.served\n"
        "import reference.nbfm64, reference.heli64\n"
        "for m in harness.load_manifest('nbfm64.resident')['bench']['per_layer']:\n"
        "    harness.load_module(harness.HERE / 'metrics' / (m['name'] + '.py'), m['name'])\n"
        "import csdr_tpu_torch, csdr_tpu_torch.parallel.flagship\n"
        "print(harness.foreign_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_foreign_names_are_compared_whole():
    sys.modules.setdefault("csdr_tpu_torch_lookalike", type(sys)("csdr_tpu_torch_lookalike"))
    try:
        assert "csdr_tpu_torch_lookalike" not in harness.foreign_modules()
    finally:
        del sys.modules["csdr_tpu_torch_lookalike"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in sorted((harness.HERE / "reference").glob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "csdr_tpu",
                                              "csdr_tpu_torch"), (path.name, name)


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in sorted(harness.HERE.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "csdr_tpu"), \
                (path, name)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nbfm64.resident", "heli64.served"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _cli(["--workload", cell, "--seed", str(2 ** 31 + 77), "--seconds", "2",
              "--trace", str(trace)])
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
    assert list(line)[-1] == "checks"
