"""The benchmark's core: the cell's files found by name, the caches fixed
inside the checkout, the import check, the drivers called, the
correctness limits applied and the result line assembled.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the configuration as it is run (its graph
  recipe, sizes, the limits of its comparison) and ``reference/<config>.py``
  beside it, its plain reference (``judge`` and ``control``);
* ``traffic/<cell>.json``: the traffic mix, read by ``signals.py`` and the
  driver it names (``drivers/<driver>.py``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FOREIGN = ("jax", "jaxlib", "flax", "csdr_tpu")   # compared as whole top-level names


def fix_caches(root: Path = ROOT):
    """Every build and kernel cache of the program at a fixed path inside
    the checkout; the autotune cache at a path in the run's TMPDIR that
    nothing writes, so every run takes the kernels' default tiles."""
    build = root / "build"
    os.environ["CSDR_TPU_TORCH_BUILD_DIR"] = str(build / "csdr_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch_kernels")
    (build / "torch_kernels").mkdir(parents=True, exist_ok=True)
    tmp = os.environ.get("TMPDIR") or str(build / "tmp")
    os.environ["CSDR_TPU_TORCH_AUTOTUNE_CACHE"] = str(Path(tmp) / "portbench-no-autotune.json")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FOREIGN})


def load_manifest(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic and metric
    entries from ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    applies = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    return dict(
        bench=bench, cell=cell,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        run_seconds=bench["run_seconds"])


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config: dict):
    """The configuration's plain reference module (``reference/<name>.py``)."""
    return importlib.import_module(f"reference.{config['reference']}")


def read_metric(name: str, run: dict):
    """``metrics/<name>.py``'s reading of a traced run, or None."""
    return load_module(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}").read(run)


def seeded_picks(seed: int, keep: dict) -> list[int]:
    """The blocks a run compares: the first ``first`` and ``drawn`` more
    drawn from the seed in [first, range)."""
    import numpy as np

    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 7])
    first, hi = keep["first"], keep["range"]
    drawn = rng.choice(np.arange(first, hi), size=min(keep["drawn"], hi - first), replace=False)
    return sorted(set(range(first)) | {int(v) for v in drawn})


def apply_overrides(man: dict, overrides: dict | None) -> dict:
    """A run at other sizes, for the tests on the CPU: ``overrides`` maps
    "config" and "traffic" to keys replaced in each."""
    for part, new in (overrides or {}).items():
        man[part] = {**man[part], **new}
    return man


def judge(man: dict, readings: list) -> tuple[dict, int]:
    """({number: (worst reading, limit)}, compared blocks over a limit) of
    the reference's readings, one dict per compared block."""
    limits = man["config"]["limits"]
    out = {k: (max((r[k] for r in readings), default=math.inf), limits[k]) for k in limits}
    bad = sum(1 for r in readings if any(not (r[k] <= limits[k]) for k in limits))
    if not readings:
        bad = 1
    return out, bad


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device_type: str = "cuda",
             overrides: dict | None = None, fault: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of a cell: the driver's window (or traced window), the
    comparison and the result's fields.  ``device_type`` "cpu" and
    ``overrides`` are for the tests only: the command line always runs on
    CUDA cards at the cell's sizes."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = apply_overrides(load_manifest(workload), overrides)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    driver = importlib.import_module(f"drivers.{man['traffic']['driver']}")
    out = driver.run(man, seed=seed, seconds=seconds, trace=trace, device_type=device_type,
                     fault=fault, t_start=t_start)
    readings = reference(man["config"]).judge(out.pop("cases"), man["config"], man["traffic"])
    checks, bad = judge(man, readings)
    out["checks"], out["failed"] = checks, bad
    out["correct"] = bad == 0 and all(v <= lim for v, lim in checks.values())
    if trace:
        run = dict(out["trace"], cell=man["cell"], config=man["config"], traffic=man["traffic"])
        metrics = {}
        for m in man["per_layer"]:
            v = read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        metrics = {m["name"]: dict(value=out["e2e"][m["name"]], unit=m["unit"])
                   for m in man["end_to_end"]}
    out["metrics"] = metrics
    return out


def result_line(out: dict, trace: bool) -> dict:
    """The JSON object the run prints last: the driver's keys, ``checks``
    last."""
    line = dict(correct=bool(out["correct"]), attempted=int(out["attempted"]),
                failed=int(out["failed"]), metrics=out["metrics"], device=out["device"])
    if trace:
        summ = out["trace"]["summaries"]
        line["device"] = dict(out["device"],
                              busy_s=sum(s["busy_s"] for s in summ) / len(summ),
                              window_s=sum(s["window_s"] for s in summ) / len(summ))
        s0 = summ[0]
        line["breakdown"] = dict(device_ops=s0["device_ops"], idle_gaps=s0["idle_gaps"])
    line["checks"] = {k: dict(value=v, limit=lim) for k, (v, lim) in out["checks"].items()}
    return line
