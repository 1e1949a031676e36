"""ctypes bindings to the native threaded file I/O (``native/csdr_io.cpp``).

Counterpart of ``csdr_tpu/io/native.py``: ``native_cf32_source`` reads a
CF32 file on a producer thread with a few chunks in flight, so the disk
overlaps the device; ``NativeRawFileSink`` writes on a thread of its own.

At first use ``g++`` (``$CXX``) compiles ``native/csdr_io.cpp`` into
``build/csdr_tpu_torch/libcsdr_io-<hash>.so`` at the root of the checkout,
keyed on a hash of the source; ``native/`` is not written to.
``$CSDR_NATIVE_LIB`` names a library built elsewhere instead, as for the
JAX package.  A build or load that fails raises: nothing here falls back
to the Python reader (``io/sources.cf32_file_source`` is that reader, and
the caller picks).  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

__all__ = ["build", "load_lib", "available", "native_cf32_source", "NativeRawFileSink",
           "BUILD_DIR"]

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "csdr_io.cpp"
BUILD_DIR = _ROOT / "build" / "csdr_tpu_torch"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread"]

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the source unless a library for its hash exists; the path."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join([cxx, *_FLAGS]).encode())
    out = BUILD_DIR / f"libcsdr_io-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    if shutil.which(cxx) is None:
        raise RuntimeError(f"native csdr_io: no C++ compiler {cxx!r} to build {_SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: a concurrent process never
    # loads a half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        r = subprocess.run([cxx, *_FLAGS, str(_SOURCE), "-o", str(work / "lib.so")],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"native csdr_io: {cxx} failed ({r.returncode}):\n"
                               f"{(r.stdout + r.stderr)[-4000:]}")
        os.replace(work / "lib.so", out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load_lib() -> ctypes.CDLL:
    """The library (``$CSDR_NATIVE_LIB``, else built here), typed; loaded
    once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = os.environ.get("CSDR_NATIVE_LIB")
        if so and not os.path.exists(so):
            raise RuntimeError(f"native csdr_io: CSDR_NATIVE_LIB={so} does not exist")
        lib = ctypes.CDLL(so or str(build()))
        u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        lib.reader_open.restype = ctypes.c_void_p
        lib.reader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.reader_next.restype = ctypes.c_int
        lib.reader_next.argtypes = [ctypes.c_void_p, u8pp, ctypes.POINTER(ctypes.c_size_t)]
        lib.reader_close.restype = None
        lib.reader_close.argtypes = [ctypes.c_void_p]
        lib.writer_open.restype = ctypes.c_void_p
        lib.writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.writer_write.restype = ctypes.c_int
        lib.writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.writer_close.restype = ctypes.c_int
        lib.writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library loads (building it if need be)."""
    try:
        load_lib()
    except (RuntimeError, OSError):
        return False
    return True


def native_cf32_source(path: str, chunk_samples: int = 1 << 18,
                       n_buffers: int = 4) -> Iterator[np.ndarray]:
    """complex64 chunks of ``chunk_samples`` from a CF32 file, read ahead on
    a producer thread into ``n_buffers`` buffers; a trailing partial sample
    is dropped.  FileNotFoundError where the file does not open."""
    lib = load_lib()
    h = lib.reader_open(os.fsencode(path), chunk_samples * 8, n_buffers)
    if not h:
        raise FileNotFoundError(path)
    try:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_size_t()
        while True:
            rc = lib.reader_next(h, ctypes.byref(ptr), ctypes.byref(ln))
            if rc == 0:
                return
            if rc < 0:
                raise OSError(f"native read error on {path}")
            n = ln.value - ln.value % 8
            if n:
                # copy out: the buffer goes back to the producer at the next call
                yield np.frombuffer(ctypes.string_at(ptr, n), dtype=np.complex64)
    finally:
        lib.reader_close(h)


class NativeRawFileSink:
    """Raw writer whose disk writes run on a thread of their own; each call
    copies its data, ``close()`` flushes and raises where a write failed."""

    def __init__(self, path: str, n_buffers: int = 8):
        self.lib = load_lib()
        self.h = self.lib.writer_open(os.fsencode(path), n_buffers)
        if not self.h:
            raise OSError(f"cannot open {path}")

    def __call__(self, data):
        buf = np.ascontiguousarray(data).tobytes()
        if self.lib.writer_write(self.h, buf, len(buf)) != 0:
            raise OSError("native write error")

    def close(self):
        if self.h:
            rc = self.lib.writer_close(self.h)
            self.h = None
            if rc != 0:
                raise OSError("native writer flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
