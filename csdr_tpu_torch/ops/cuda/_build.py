"""Build the package's CUDA sources into one shared library, on first use.

``nvcc`` compiles every ``csdr_tpu_torch/csrc/*.cu`` for ``sm_90a`` — one
process per source, all started together — and links the objects into
``libcsdr_kernels-<hash>.so``, keyed on a hash of the sources; the library
is loaded with ``ctypes``.  The sources expose a plain C interface and
include no PyTorch header, so a build takes seconds.

The sources are read as package resources (``importlib.resources``), so
they are found inside a zipapp too, and copied into the build directory
before ``nvcc`` runs.  The build directory is ``$CSDR_TPU_TORCH_BUILD_DIR``
where that is set (a bundle's launcher sets it), else
``build/csdr_tpu_torch/`` at the root of the checkout.  Nothing here runs
at import time: the CPU-only test suite imports the package with no CUDA
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.resources
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["build", "build_dir", "library_path", "load_library", "source_ints", "BUILD_ENV"]

BUILD_ENV = "CSDR_TPU_TORCH_BUILD_DIR"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def source_ints(source: str, *names: str) -> tuple[int, ...]:
    """The values of ``constexpr int <name> = <integer>;`` in ``csrc/<source>``,
    so a wrapper that lays out a kernel's operands reads the kernel's own
    constants (no toolchain needed); raises if one is missing."""
    text = (_csrc() / source).read_text()
    out = []
    for name in names:
        m = re.search(rf"^constexpr int {name} = (\d+);", text, re.M)
        if m is None:
            raise RuntimeError(f"csrc/{source} defines no integer constant {name}")
        out.append(int(m.group(1)))
    return tuple(out)


def _csrc():
    """The package's ``csrc`` directory as a resource (a directory in a
    checkout, a zip member in a bundle)."""
    return importlib.resources.files("csdr_tpu_torch") / "csrc"


def _sources() -> dict[str, bytes]:
    """Every ``*.cu`` and ``*.cuh`` of ``csrc``, name → bytes."""
    return {p.name: p.read_bytes() for p in sorted(_csrc().iterdir(), key=lambda p: p.name)
            if p.name.endswith((".cu", ".cuh"))}


def build_dir() -> Path:
    """``$CSDR_TPU_TORCH_BUILD_DIR``, else ``build/csdr_tpu_torch`` at the
    root of the checkout."""
    env = os.environ.get(BUILD_ENV)
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    if not root.is_dir():   # the package sits in a zipapp
        raise RuntimeError(f"csdr_tpu_torch runs from {root}: set {BUILD_ENV} to a writable "
                           f"directory for the CUDA kernels (a bundle's launcher does)")
    return root / "build" / "csdr_tpu_torch"


def _key(sources: dict[str, bytes]) -> str:
    h = hashlib.sha256()
    for name, data in sources.items():
        h.update(name.encode())
        h.update(data)
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources is (or would be) built."""
    return build_dir() / f"libcsdr_kernels-{_key(_sources())}.so"


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
    sources = _sources()
    key = _key(sources)
    bdir = build_dir()
    out = bdir / f"libcsdr_kernels-{key}.so"
    if out.exists():
        return out
    bdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # copy the sources and compile in a private directory, then rename the
    # library into place: concurrent builds never load a half-written one
    work = Path(tempfile.mkdtemp(dir=bdir))
    try:
        for name, data in sources.items():
            (work / name).write_bytes(data)
        srcs = [work / name for name in sources if name.endswith(".cu")]
        objs = [p.with_suffix(".o") for p in srcs]
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
        (bdir / f"nvcc-{key}.log").write_text("".join(logs))
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
