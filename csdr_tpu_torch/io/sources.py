"""Sample sources: plain iterators of numpy arrays feeding
``core/runtime.Pipeline``.

Copied from ``csdr_tpu/io/sources.py`` (``cf32_file_source``,
``f32_file_source`` and ``cu8_file_source``), numpy only.  One difference:
the cu8 source yields (n, 2) uint8 rows, one row per IQ sample, so that
the runtime's block size, ``take_n`` and the last block's trim count
samples, and the bytes still go to the device as uint8 (2 bytes per sample
on the wire)."""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["cf32_file_source", "f32_file_source", "cu8_file_source"]

_CHUNK = 1 << 18


def cf32_file_source(path: str, chunk_size: int = _CHUNK) -> Iterator[np.ndarray]:
    """Stream complex64 samples from a raw .cf32 file, ``chunk_size``
    samples at a time; a trailing partial sample is dropped."""
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_size * 8)
            if len(raw) < 8:
                return
            yield np.frombuffer(raw[: len(raw) & ~7], dtype=np.complex64)


def f32_file_source(path: str, chunk_size: int = _CHUNK) -> Iterator[np.ndarray]:
    """Stream float32 samples (discriminator or audio) from a raw .f32
    file; a trailing partial sample is dropped."""
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_size * 4)
            if len(raw) < 4:
                return
            yield np.frombuffer(raw[: len(raw) & ~3], dtype=np.float32)


def cu8_file_source(path: str, chunk_size: int = _CHUNK) -> Iterator[np.ndarray]:
    """Raw interleaved uint8 IQ (rtl_sdr capture format) as (n, 2) uint8
    rows; the conversion to float happens on the device."""
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_size * 2)
            if len(raw) < 2:
                return
            buf = np.frombuffer(raw, dtype=np.uint8)
            yield buf[: len(buf) & ~1].reshape(-1, 2)
