"""Build the package's CUDA sources into one shared library, on first use.

``nvcc`` compiles every ``csdr_tpu_torch/csrc/*.cu`` for ``sm_90a`` — one
process per source, all started together — and links the objects into
``build/csdr_tpu_torch/libcsdr_kernels-<hash>.so`` at the root of the
checkout, keyed on a hash of the sources; the library is loaded with
``ctypes``.  The sources expose a plain C interface and include no PyTorch
header, so a build takes seconds.  Nothing here runs at import time: the
CPU-only test suite imports the package with no CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["build", "load_library", "source_ints", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "csdr_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def source_ints(source: str, *names: str) -> tuple[int, ...]:
    """The values of ``constexpr int <name> = <integer>;`` in ``csrc/<source>``,
    so a wrapper that lays out a kernel's operands reads the kernel's own
    constants (no toolchain needed); raises if one is missing."""
    text = (CSRC / source).read_text()
    out = []
    for name in names:
        m = re.search(rf"^constexpr int {name} = (\d+);", text, re.M)
        if m is None:
            raise RuntimeError(f"csrc/{source} defines no integer constant {name}")
        out.append(int(m.group(1)))
    return tuple(out)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of csdr_tpu_torch are built "
                       "with the CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def build() -> Path:
    """Compile the sources if no library for their hash (headers included)
    exists; return its path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept beside it as
    ``nvcc-<hash>.log``."""
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    key = h.hexdigest()[:16]
    out = BUILD_DIR / f"libcsdr_kernels-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a private directory and rename the library into place:
    # concurrent builds never load a half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [work / f"{p.stem}.o" for p in srcs]
        procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                                   "-Xptxas", "-v", "-c", "-o", str(o), str(p)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(p.name, proc.returncode, log) for p, proc, log in zip(srcs, procs, logs)
                  if proc.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(work / "lib.so"),
                                   *map(str, objs)], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(("the link", link.returncode, logs[-1]))
        (BUILD_DIR / f"nvcc-{key}.log").write_text("".join(logs))
        if failed:
            what, rc, log = failed[0]
            raise RuntimeError(f"nvcc failed on {what} ({rc}):\n{log[-4000:]}")
        os.replace(work / "lib.so", out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
