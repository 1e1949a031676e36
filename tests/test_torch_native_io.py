"""The port's native threaded file I/O (csdr_tpu_torch/io/native.py): the
reader and writer round trips of tests/test_native_io.py, the reader
against the port's Python reader and the JAX package's (bytes equal), and
the build: native/csdr_io.cpp compiled into build/, never into native/,
$CSDR_NATIVE_LIB honoured, and a failed build raising rather than falling
back.  g++ is part of this machine's toolchain, as on the card's host."""

import os

import numpy as np
import pytest

from csdr_tpu.io import sources as JSRC

from csdr_tpu_torch.io import native
from csdr_tpu_torch.io.sources import cf32_file_source


def test_native_reader_roundtrip(tmp_path):
    p = str(tmp_path / "x.cf32")
    x = (np.arange(100000) + 1j * np.arange(100000)).astype(np.complex64)
    x.tofile(p)
    got = np.concatenate(list(native.native_cf32_source(p, chunk_samples=7777)))
    assert np.array_equal(got, x)


def test_native_reader_empty(tmp_path):
    p = str(tmp_path / "e.cf32")
    open(p, "wb").close()
    assert list(native.native_cf32_source(p)) == []


def test_native_writer_roundtrip(tmp_path):
    p = str(tmp_path / "w.cf32")
    x = np.random.default_rng(0).normal(size=50000).astype(np.float32)
    with native.NativeRawFileSink(p) as sink:
        for i in range(0, 50000, 9999):
            sink(x[i:i + 9999])
    assert np.array_equal(np.fromfile(p, dtype=np.float32), x)


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        list(native.native_cf32_source("/nonexistent/file.cf32"))


def test_native_reader_equals_python_readers(tmp_path):
    """A file with a trailing partial sample: the native reader, the port's
    Python reader and the JAX package's reader give the same samples."""
    rng = np.random.default_rng(4)
    p = tmp_path / "r.cf32"
    p.write_bytes(rng.normal(size=2 * 70001).astype(np.float32).tobytes() + b"\x01\x02\x03")
    got = np.concatenate(list(native.native_cf32_source(str(p), chunk_samples=4096)))
    assert got.tobytes() == np.concatenate(list(cf32_file_source(str(p), 5000))).tobytes()
    assert got.tobytes() == np.concatenate(list(JSRC.cf32_file_source(str(p), 5000))).tobytes()
    assert len(got) == 70001


def test_library_is_built_into_build_and_env_is_honoured(tmp_path, monkeypatch):
    lib = native.load_lib()
    assert os.path.dirname(lib._name) == str(native.BUILD_DIR)
    assert os.path.basename(lib._name).startswith("libcsdr_io-")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CSDR_NATIVE_LIB", lib._name)
    assert native.load_lib()._name == lib._name
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CSDR_NATIVE_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="does not exist"):
        native.load_lib()
    assert not native.available()


def test_failed_build_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("CSDR_NATIVE_LIB", raising=False)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load_lib()
    with pytest.raises(RuntimeError):
        list(native.native_cf32_source("/nonexistent/file.cf32"))
