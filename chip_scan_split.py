#!/usr/bin/env python3
"""Where K8's time goes, on one CUDA card.

    mkdir -p build/old && git archive ea37985 csdr_tpu_torch | tar -x -C build/old
    python3 chip_scan_split.py build/old

OLD (build/old above, any directory that .gitignore lists) holds the
csdr_tpu_torch package of the commit whose K8 (``csrc/symsync_scan.cu``,
one output per serial step) is split.  Its source is built as it is and
with one part of each serial step changed, each a library of its own
under build/scan_split/ (nvcc for sm_90a, all started together):

  the window read from a 4,096-sample buffer of the row's first samples in
  shared memory instead of from the row in device memory (wrong values:
  a time only);
  no loop update (τ stays where it started);
  no shuffle tree (each lane keeps its own partial sum).

A part's time is the kernel's less that variant's.  Beside them, this
checkout's K8 is built as it is and with its taps per lane taken at run
time instead of as a template constant.  Every library is timed at the
-c 64 DeNBFMSync 10 tracker's panel, (64, 130,981) float32, k = 10 (W 81,
3 taps a lane), and at complex (64, 65,569), k = 4 (W 25, 1 tap a lane),
with chip_smoke.py's ``time_steps``, in turns forward then backward.  The
libraries that compute K8 unchanged are checked bit for bit against this
checkout's wrapper at both shapes.

Prints one JSON line per result, then the nvidia-smi line; writes the
lines and the nvcc log to build/scan_split/.  Needs one card.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "build", "scan_split")
SRC = os.path.join("csdr_tpu_torch", "csrc", "symsync_scan.cu")
RING = 4096

# OLD's kernel, one part of the serial step changed in each
OLD_VARIANTS = {
    "window from shared memory": [
        ("  for (int i = threadIdx.x; i < npfb * W; i += blockDim.x) sbank[i] = bank[i];\n",
         "  for (int i = threadIdx.x; i < npfb * W; i += blockDim.x) sbank[i] = bank[i];\n"
         "  T* sbuf = reinterpret_cast<T*>(sbank + ((npfb * W + 3) & ~3)) + (threadIdx.x >> 5)"
         f" * {RING};\n"
         "  {\n"
         "    long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);\n"
         "    r = r < rows ? r : rows - 1;\n"
         f"    for (int i = threadIdx.x & 31; i < {RING}; i += 32)"
         " sbuf[i] = xfull[r * L + (i < L ? i : 0)];\n"
         "  }\n"),
        ("acc = K::madd(acc, win[t], b[t]);",
         f"acc = K::madd(acc, sbuf[(s + t) & {RING - 1}], b[t]);"),
        ("const size_t smem = sizeof(float) * (size_t)npfb * W;",
         "const size_t smem = sizeof(float) * (((size_t)npfb * W + 3) & ~(size_t)3)"
         f" + kWarps * {RING} * sizeof(T);"),
    ],
    "no loop update": [
        ("      float e = K::ted(edge, acc, prev);\n"
         "      e = -fminf(fmaxf(e, -1.0f), 1.0f);\n"
         "      eta = __fadd_rn(eta, __fmul_rn(ki, e));\n"
         "      tau = __fadd_rn(__fadd_rn(tau, __fmul_rn(kp, e)), eta);\n", ""),
    ],
    "no shuffle tree": [
        ("#pragma unroll\n"
         "    for (int off = 16; off > 0; off >>= 1) acc = K::shfl_add(acc, off);\n", ""),
    ],
}
# this checkout's kernel with the taps per lane a run-time count
NEW_VARIANTS = {"taps per lane at run time": [("  switch (nt) {", "  switch (0) {")]}


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"chip_scan_split: the source does not hold {old!r} once")
        src = src.replace(old, new)
    return src


def build(sources: dict[str, tuple[str, str]]) -> dict[str, ctypes.CDLL]:
    """nvcc each (source, its csrc directory for the headers) into a library
    of its own, all started together."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    procs = {}
    for i, (name, (src, inc)) in enumerate(sources.items()):
        cu = os.path.join(BUILD, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", inc, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, log = {}, []
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        log.append(f"== {name}\n{out}")
        if p.returncode:
            print(out[-4000:], file=sys.stderr)
            raise SystemExit(f"chip_scan_split: nvcc failed on {name!r}")
        libs[name] = ctypes.CDLL(so)
    with open(os.path.join(BUILD, "nvcc.log"), "w") as f:
        f.write("".join(log))
    return libs


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isfile(os.path.join(sys.argv[1], SRC)):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_scan_split: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as sm
    from csdr_tpu_torch.models import symsync
    from csdr_tpu_torch.ops.cuda import symsync_scan as k8

    with open(os.path.join(sys.argv[1], SRC)) as f:
        old = f.read()
    with open(os.path.join(HERE, SRC)) as f:
        new = f.read()
    old_inc, new_inc = (os.path.dirname(os.path.join(r, SRC)) for r in (sys.argv[1], HERE))
    sources = {"OLD as is": (old, old_inc),
               **{f"OLD, {k}": (patched(old, e), old_inc) for k, e in OLD_VARIANTS.items()},
               "this checkout as is": (new, new_inc),
               **{f"this checkout, {k}": (patched(new, e), new_inc)
                  for k, e in NEW_VARIANTS.items()}}
    libs = build(sources)
    exact = ("OLD as is", "this checkout as is", "this checkout, taps per lane at run time")
    dev = torch.device("cuda")
    out = open(os.path.join(BUILD, "scan_split.jsonl"), "w")

    def emit(d):
        print(json.dumps(d), flush=True)
        out.write(json.dumps(d) + "\n")

    for kind, blk, rows, n in (
            ("real", symsync.sym_sync_r(sm.SYNC_K, 4, 0.0, 64, mode="scan"), 64, 130880),
            ("complex", symsync.sym_sync_c(3, 4, mode="scan"), 64, 65536)):
        x = torch.from_numpy(sm.sync_rows(rows, n, blk.k, sm.SEED + 1760, kind == "complex"))
        xf = torch.cat([torch.zeros((rows, blk.H), dtype=x.dtype), x], dim=-1).to(dev)
        bank = symsync._bank_on(blk.k, blk.m, blk.npfb, blk.ftype, blk.beta, dev)
        z, zt = torch.zeros(rows, device=dev), torch.zeros(rows, dtype=x.dtype, device=dev)
        carry, loop = (z, z.clone(), zt, zt.clone()), blk.loop(n)
        npfb, W = bank.shape
        y = torch.empty((rows, loop.nout), dtype=xf.dtype, device=dev)
        res = tuple(torch.empty_like(c) for c in carry)

        def step(lib):
            err = lib.csdr_symsync_scan(
                int(xf.is_complex()), ctypes.c_void_p(xf.data_ptr()),
                ctypes.c_longlong(xf.shape[-1]), rows, ctypes.c_void_p(bank.data_ptr()), npfb, W,
                loop.mk, ctypes.c_longlong(loop.nout),
                *(ctypes.c_float(np.float32(v)) for v in (loop.start, loop.half, loop.kp, loop.ki)),
                *(ctypes.c_void_p(c.data_ptr()) for c in carry), ctypes.c_void_p(y.data_ptr()),
                *(ctypes.c_void_p(c.data_ptr()) for c in res),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"chip_scan_split: launch failed, CUDA error {err}")

        (tau_w, *_), y_w = k8.symsync_scan(xf, bank, carry, loop)
        for name in exact:
            step(libs[name])
            torch.cuda.synchronize()
            emit(dict(check=f"{kind}: {name} against the wrapper, bit for bit",
                      y=bool(torch.equal(y, y_w)), tau=bool(torch.equal(res[0], tau_w))))
            if not (torch.equal(y, y_w) and torch.equal(res[0], tau_w)):
                return 1
        turns = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            turns[name].append(statistics.median(
                sm.time_steps(torch, lambda: step(libs[name]), steps=10)))
        for name, ms in turns.items():
            emit(dict(shape=f"{kind} {tuple(xf.shape)} W {W}", kernel=name, turns_ms=ms,
                      ns_per_output=statistics.median(ms) * 1e6 / loop.nout))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(dict(smi=smi))
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
