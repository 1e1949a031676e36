"""Sample sources: plain iterators of numpy arrays feeding
``core/runtime.Pipeline``.

Counterparts of the file sources of ``csdr_tpu/io/sources.py``
(``cf32_file_source``, ``f32_file_source``, ``cu8_file_source``,
``raw_bytes_source``, ``wav_iq_source``).  One difference: the cu8 source
yields (n, 2) uint8 rows, one row per IQ sample, so that the runtime's
block size, ``take_n`` and the last block's trim count samples, and the
bytes still go to the device as uint8 (2 bytes per sample on the wire).
``wav_iq_source`` runs its Hilbert front on a Pipeline of its own, on the
device the caller names; the rest is numpy."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from . import wav as wavio

__all__ = ["cf32_file_source", "f32_file_source", "cu8_file_source", "raw_bytes_source",
           "wav_iq_source"]

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


def raw_bytes_source(path: str, chunk_bytes: int = _CHUNK) -> Iterator[np.ndarray]:
    """Untyped bytes straight from the file, ``chunk_bytes`` at a time (the
    reference's ``readBytes``), for a consumer that frames them itself."""
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_bytes)
            if not raw:
                return
            yield np.frombuffer(raw, dtype=np.uint8)


def wav_iq_source(path: str, block_size: int = 1 << 20, *, device) -> Iterator[np.ndarray]:
    """Mono WAV → IQ, as the reference's audio-file source: the Hilbert
    real → complex 2:1 (``real_to_complex``), then a mix by π, run on a
    Pipeline of ``block_size`` real samples on ``device``.  Yields complex64
    host blocks of block_size / 2 samples; the last block is trimmed to
    ⌊n/2⌋ in all.  A WAV of more than one channel is refused here, before
    any sample is read, with the reference's ValueError."""
    from ..blocks import mix_up, real_to_complex
    from ..core.block import chain
    from ..core.runtime import Pipeline

    _sr, channels, _tag = wavio.probe_wav(path)
    if channels != 1:
        raise ValueError("wav_iq_source: only mono WAV supported (like the reference)")
    pipe = Pipeline(chain(real_to_complex(), mix_up(np.pi)), block_size=block_size,
                    device=device)

    def blocks():
        data, _ = wavio.read_wav(path)
        yield from pipe.stream(iter([data]))

    return blocks()
