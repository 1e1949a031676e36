#!/usr/bin/env python3
"""Time the port's main-path steps of several checkouts on one CUDA card,
in turns, with one yardstick.

    python3 chip_compare.py ROOT [ROOT ...] [--turns 2] [--out FILE]

This is the repo's one timer of kernels and paths alone; ``portbench/``
measures the port end to end and ``chip_smoke.py`` checks it on the card.
Each ROOT is a directory holding a ``csdr_tpu_torch`` package: a checkout,
or ``git archive <commit> csdr_tpu_torch`` unpacked into a directory that
.gitignore lists.  The roots run forward, then backward (A, B, B, A for two
roots and two turns), each turn in a process of its own that imports that
root's package and builds its kernels there.  Every turn times the same
steps on the same seeded inputs with ``time_steps`` (CUDA events, the steps
queued behind a spin of the card) and ``profile_kernels`` (torch.profiler
device time); the inputs come from ``chip_smoke.py`` of this script's own
directory (its signal generators, and through it ``tests/torch_oracles.py``):

  kernels alone, one 2^23-sample block: K1/K2 (cu8, nch 64; and K1 at nch
  20 on 8,388,480 samples, and at nch 64 on 2^21, a 4-rank shard's block;
  the untraced host time the resident loop takes to enqueue a K1 step, the
  nbfm64.resident cell's graph on cu8 rows: the median of 5 means over 200
  steps queued behind a spin of the card), K3 and K4 on
  the block's panels, K5 at (64, 2^17) complex x 585 taps; the serial
  recurrences at their flows' shapes: K7 on one seeded noisy 19 kHz pilot
  row of 1,046,400 samples (the DeFMS 8 block at 200 kHz) and K8 on 64
  seeded rows of the JAX sync tests' real signal, (64, 130,981) with k = 10
  (the -c 64 DeNBFMSync 10 tracker's panel); the block sync on 64 such rows
  of 262,080 samples, the heli64.served cell's panel (K9 where the root has
  it, its eager ops where not);
  paths, one 2^23-sample block per state-chained step: the pfb_fused and
  eager DeNBFM receivers (f32, chip_smoke.py 5b's path), and the graphs the
  CLI builds, cu8 in, for -c 64 -a -48 DeNBFM (pfb_fused), -c 64 DeCW
  (eager and pfb_fused), and the USB band-pass through
  FIRFilter(strategy="pallas_fft").

Writes one JSON line per (root, turn, step) to FILE (default
build/compare/compare.jsonl) and prints, per step, each root's median step ms
and device µs over its turns, then the nvidia-smi line.  Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 20               # timed steps per measurement (after warm-up)


def time_steps(torch, step, steps: int = STEPS, warmup: int = 3) -> list[float]:
    """Per-step milliseconds from CUDA events around each of ``steps``
    state-chained calls of ``step()``, after ``warmup`` calls.  The card
    first spins for twice the host's time to enqueue the steps, so every
    step is queued before the card reaches it and the events time the card,
    not the host's launch gaps."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(0.5, 2 * steps * enqueue_s + 1e-3) * 2e9))
    evs = []
    for _ in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


def enqueue_us(torch, step, steps: int = 200, warmup: int = 3) -> float:
    """Mean host microseconds per call of ``step()`` over ``steps`` calls,
    none synchronising, queued behind a spin of the card for twice the
    host's time, so the card never drains the queue nor the host waits on
    it: the host's own step, untraced."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    one_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2.0, 2 * steps * one_s + 1e-3) * 2e9))
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host_s / steps


def profile_kernels(torch, fn, steps: int, want: int | None = None, tries: int = 5) -> dict:
    """Device kernels of ``steps`` calls of ``fn()`` (after one unprofiled
    call), from torch.profiler: kernel name → dict(count, device_us), both
    summed over the steps.  The tracer now and then loses a kernel record,
    even in a process's first session: a session that traced fewer device
    kernels than launch calls, or other than ``want`` per step, is run
    again, up to ``tries`` times."""
    fn()
    for _ in range(tries):
        prof, _ = traced(torch, lambda: [fn() for _ in range(steps)])
        kern = device_kernels(prof)
        n = sum(v["count"] for v in kern.values())
        if n == launch_calls(prof) and (want is None or n == want * steps):
            break
    return kern


def traced(torch, fn):
    """torch.profiler around one call of ``fn()``; returns (profiler, fn's
    wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def trace_events(prof) -> list[tuple[str, bool, float]]:
    """(name, on the device, duration µs) of every event of a torch.profiler
    run, read once from its Kineto results and kept on ``prof``: the events
    ``key_averages`` sums, without building the profiler's FunctionEvent
    tree."""
    if not hasattr(prof, "_csdr_events"):
        prof._csdr_events = [(e.name(), str(e.device_type()).endswith("CUDA"),
                              e.duration_ns() / 1e3)
                             for e in prof.profiler.kineto_results.events()]
    return prof._csdr_events


def device_kernels(prof) -> dict:
    """Kernel name → dict(count, device_us) of a torch.profiler run: the
    device events, less copies, sets and the ranges ProcessGroupNCCL
    records around its kernels ("nccl:broadcast", …)."""
    kern = {}
    for name, on_device, us in trace_events(prof):
        if on_device and "ProfilerStep" not in name and not name.startswith(
                ("aten::", "Memcpy", "Memset", "nccl:")):
            k = kern.setdefault(name, dict(count=0, device_us=0.0))
            k["count"] += 1
            k["device_us"] += us
    return kern


def launch_calls(prof) -> int:
    """Kernel launches the host made in a torch.profiler run: the CUDA
    runtime's and driver's launch calls in its trace."""
    return sum(1 for name, on_device, _ in trace_events(prof)
               if not on_device and name.startswith(("cudaLaunch", "cuLaunch")))


def _smoke():
    """chip_smoke.py of this directory, loaded by path (a root may hold its
    own): the steps' inputs."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli_graph(ct, argv: list[str]):
    """The main graph the CLI builds for ``argv``, behind u8 → IQ."""
    from csdr_tpu_torch.apps import soapy_sdr_cli as cli

    opts = cli.build_parser().parse_args(["--filename", "in.cu8", *argv])
    demod = cli.parse_demod(opts.demod)
    agc_t = opts.agc if opts.agc != 0.0 else None
    return ct.chain(ct.u8_to_iq(),
                    cli._graph(opts, demod, agc_t, opts.bandwidth or opts.samplerate,
                               opts.backend))


def worker(root: str, turn: int) -> None:
    """Time every step with ``root``'s package; one JSON line per step."""
    sys.path.insert(0, root)
    import torch

    import csdr_tpu_torch as ct
    from csdr_tpu_torch.ops.cuda import fir_valid as fv
    from csdr_tpu_torch.ops.cuda import flagship_fused as ff
    from csdr_tpu_torch.models import symsync
    from csdr_tpu_torch.ops.cuda import pfb_fused as pf
    from csdr_tpu_torch.ops.cuda import pll_scan as k7
    from csdr_tpu_torch.ops.cuda import symsync_scan as k8

    package = os.path.dirname(os.path.abspath(ct.__file__))
    if os.path.dirname(package) != os.path.abspath(root):
        raise SystemExit(f"imported {package}, not the package of {root}")
    sm = _smoke()
    dev = torch.device("cuda")
    B = sm.BLOCK
    x = sm.occupied_band(torch, dev, 64, B, sm.SEED + 1)
    u8 = sm.to_cu8(torch, x)
    taps, W = pf.pfb_design(64, 7, 80.0, dev)
    v3 = sm.block_panels(torch, pf, x, 64)
    v4 = v3[1:].contiguous()
    cw64 = sm.cw_taps(2.56e6 / 64)
    x5 = sm.rand_rows(torch, dev, 64, B // 64 + len(cw64) - 1, True, sm.SEED + 14)
    cw = sm.keyed_cw_capture(torch, dev, 64, B, sm.SEED + 5).view(B, 2)
    graphs = {
        "pfb_fused DeNBFM f32": (ct.channelized_fm_receiver(64, kf=sm.KF,
                                                            backend="pfb_fused"), x),
        "eager DeNBFM f32": (ct.channelized_fm_receiver(64, kf=sm.KF, backend="eager"), x),
        "-c 64 -a -48 DeNBFM pfb_fused cu8": (_cli_graph(ct, [
            "-c", "64", "-a", "-48", "--demod", "DeNBFM 0.6 F32",
            "--backend", "pfb_fused"]), u8.view(B, 2)),
        "-c 64 DeCW eager cu8": (_cli_graph(ct, [
            "-c", "64", "--demod", "DeCW 500 700 WAV", "--backend", "eager"]), cw),
        "-c 64 DeCW pfb_fused cu8": (_cli_graph(ct, [
            "-c", "64", "--demod", "DeCW 500 700 WAV", "--backend", "pfb_fused"]), cw),
        "library USB band-pass pallas_fft cu8": (ct.chain(
            ct.u8_to_iq(), ct.fir_filter(sm.usb_taps(), True, strategy="pallas_fft"),
            ct.Lambda(lambda v: v.real.contiguous(), name="re")), u8.view(B, 2)),
    }
    # K7: a noisy pilot at the DeFMS quad rate; K8: the tracker's panel shape
    rng = np.random.default_rng(sm.SEED + 1750)
    n7 = 1046400
    t7 = np.arange(n7)
    p7 = torch.from_numpy((0.1 * np.exp(1j * (2 * np.pi * 19004.0 / sm.FM_BW * t7 + 2.0))
                           + 0.02 * (rng.normal(size=n7) + 1j * rng.normal(size=n7)))
                          .astype(np.complex64).reshape(1, -1)).to(dev)
    c7 = (torch.zeros(1, device=dev), torch.zeros(1, device=dev))
    blk8 = symsync.sym_sync_r(sm.SYNC_K, 4, 0.0, 64, mode="scan")
    n8 = 130880
    x8 = torch.from_numpy(sm.sync_rows(sm.SYNC_NCH, n8, sm.SYNC_K, sm.SEED + 1751, False)).to(dev)
    x8 = torch.cat([torch.zeros(sm.SYNC_NCH, blk8.H, device=dev), x8], dim=-1).contiguous()
    bank8 = symsync._bank_on(blk8.k, blk8.m, blk8.npfb, blk8.ftype, blk8.beta, dev)
    z8 = torch.zeros(sm.SYNC_NCH, device=dev)
    carry8, loop8 = (z8, z8, z8, z8), blk8.loop(n8)
    # the block sync at the heli64 cell's panel: K9, or eager ops in a root
    # without it
    blk9 = ct.PerChannel(symsync.sym_sync_r(sm.SYNC_K, 4, 0.0, 64), sm.SYNC_NCH)
    x9 = torch.from_numpy(sm.sync_rows(sm.SYNC_NCH, 262080, sm.SYNC_K, sm.SEED + 1752,
                                       False)).to(dev)
    n20 = B - B % (20 * ff.DEFAULT_TILE_F)
    u8_20 = sm.to_cu8(torch, sm.occupied_band(torch, dev, 20, n20, sm.SEED + 2))
    u8_21 = u8[:2 << 21]
    resident = ct.channelized_fm_receiver(64, kf=sm.KF, backend="fused")
    box = {"k1": ff.flagship_fused_init(64, dev), "k9": blk9.init(dev),
           "k1_20": ff.flagship_fused_init(20, dev), "k1_21": ff.flagship_fused_init(64, dev),
           "resident": resident.init(dev)}
    box.update({name: g.init(dev) for name, (g, _) in graphs.items()})

    def k1():
        box["k1"], _ = ff.flagship_fused_step(box["k1"], u8, nch=64, kf=sm.KF)

    def k1_20():
        box["k1_20"], _ = ff.flagship_fused_step(box["k1_20"], u8_20, nch=20, kf=sm.KF)

    def k1_21():
        box["k1_21"], _ = ff.flagship_fused_step(box["k1_21"], u8_21, nch=64, kf=sm.KF)

    def resident_step():
        box["resident"], _ = resident.apply(box["resident"], u8.view(B, 2))

    def k9():
        box["k9"], _ = blk9.apply(box["k9"], x9)

    def path(name):
        g, xin = graphs[name]

        def run():
            box[name], _ = g.apply(box[name], xin)
        return run

    steps = {
        "K1 flagship_fused cu8 nch 64": k1,
        "K1 flagship_fused cu8 nch 20": k1_20,
        "K1 flagship_fused cu8 nch 64 2^21": k1_21,
        "K3 pfb_fm_fused": lambda: pf.pfb_fm_fused(v3, taps, W, nch=64, L=14, kf=sm.KF),
        "K4 pfb_channelize_fused": lambda: pf.pfb_channelize_fused(v4, taps, W, nch=64, L=14),
        "K5 fir_valid (64, 2^17) complex x 585": lambda: fv.fir_valid(x5, cw64),
        "K7 pll_scan (1, 1046400) complex64": lambda: k7.pll_scan(p7, c7, *sm.pll_constants()),
        "K8 symsync_scan (64, 130981) float32 k 10":
            lambda: k8.symsync_scan(x8, bank8, carry8, loop8),
        "K9 symsync_block (64, 262080) float32 k 10": k9,
        **{name: path(name) for name in graphs},
    }
    for name, fn in steps.items():
        ms = time_steps(torch, fn, steps=5 if name.startswith("K7") else STEPS)
        kern = profile_kernels(torch, fn, 5)
        top = sorted(kern.items(), key=lambda kv: -kv[1]["device_us"])[:5]
        print(json.dumps(dict(
            root=root, turn=turn, step=name, steps=len(ms), median_ms=statistics.median(ms),
            min_ms=min(ms), device_us=sum(v["device_us"] for v in kern.values()) / 5,
            launches=sum(v["count"] for v in kern.values()) / 5,
            top_kernels_us={k: v["device_us"] / 5 for k, v in top})), flush=True)
    host_us = [enqueue_us(torch, resident_step) for _ in range(5)]
    print(json.dumps(dict(root=root, turn=turn, step="K1 resident loop host enqueue",
                          steps=200, median_ms=statistics.median(host_us) / 1e3,
                          min_ms=min(host_us) / 1e3, device_us=None, launches=None,
                          top_kernels_us={})), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "compare", "compare.jsonl"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.turn)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA card", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in args.roots]
    if not roots or not all(os.path.isdir(os.path.join(r, "csdr_tpu_torch")) for r in roots):
        print("chip_compare: every ROOT must hold a csdr_tpu_torch package", file=sys.stderr)
        return 1
    order = [r for t in range(args.turns) for r in (roots if t % 2 == 0 else roots[::-1])]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    with open(args.out, "w") as f:
        for turn, root in enumerate(order):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                                  "--turn", str(turn)], capture_output=True, text=True,
                                 timeout=900)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                print(f"chip_compare: the turn of {root} failed ({run.returncode})",
                      file=sys.stderr)
                return 1
            for line in run.stdout.splitlines():
                if line.startswith("{"):
                    f.write(line + "\n")
                    rows.append(json.loads(line))
    for step in dict.fromkeys(r["step"] for r in rows):
        print(json.dumps({"step": step, **{
            os.path.relpath(root, HERE): dict(
                median_ms=statistics.median(r["median_ms"] for r in rows
                                            if r["step"] == step and r["root"] == root),
                device_us=statistics.median(r["device_us"] or 0.0 for r in rows
                                            if r["step"] == step and r["root"] == root),
                turns_ms=[r["median_ms"] for r in rows
                          if r["step"] == step and r["root"] == root])
            for root in roots}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
