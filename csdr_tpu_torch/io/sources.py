"""Sample sources: plain iterators of numpy arrays feeding
``core/runtime.Pipeline``.

Counterparts of the file sources of ``csdr_tpu/io/sources.py``
(``cf32_file_source``, ``f32_file_source``, ``cu8_file_source``,
``raw_bytes_source``, ``wav_iq_source``).  One difference: the cu8 source
yields (n, 2) uint8 rows, one row per IQ sample, so that the runtime's
block size, ``take_n`` and the last block's trim count samples, and the
bytes still go to the device as uint8 (2 bytes per sample on the wire).
``wav_iq_source`` runs its Hilbert front on a Pipeline of its own, on the
device the caller names; the rest is numpy.

The SDR devices (``csdr_tpu/io/sources.py``'s device half): ``SdrSource``
is the protocol of the reference's SoapySDR wrapper (open and configure,
MTU-sized complex64 reads, a read that times out ends the stream);
``SyntheticSdrSource`` is a seeded stand-in that yields the JAX one's
arrays element for element.  Drivers register by name
(``register_sdr_driver``): ``synthetic`` here, ``rtl_tcp`` in
``io/rtl_tcp.py`` (registered when ``csdr_tpu_torch.io`` is imported), and
the SoapySDR drivers of ``io/soapy.py``, loaded at the first
``enumerate_devices`` or ``open_sdr`` where the ``SoapySDR`` module
imports."""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from . import wav as wavio

__all__ = ["cf32_file_source", "f32_file_source", "cu8_file_source", "raw_bytes_source",
           "wav_iq_source", "SdrSource", "SyntheticSdrSource", "register_sdr_driver",
           "enumerate_devices", "open_sdr"]

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


class SdrSource:
    """Device-source protocol: ``read()`` returns one MTU-sized complex64
    chunk, or None where the reference's 1 s read timeout ends the stream;
    iterating yields chunks until None or an empty read, and closes the
    device when the iteration ends, also when the consumer stops early."""

    mtu: int = 1 << 17

    def read(self) -> np.ndarray | None:
        raise NotImplementedError

    def close(self):
        pass

    def __iter__(self) -> Iterator[np.ndarray]:
        try:
            while True:
                chunk = self.read()
                if chunk is None or len(chunk) == 0:
                    return
                yield chunk
        finally:
            self.close()


class SyntheticSdrSource(SdrSource):
    """Deterministic "device": four tones (amplitude 0.5/(i+1) at ``tones``
    cycles per sample) plus complex Gaussian noise of 0.01 per component
    from numpy's ``default_rng(seed)``, ``total_samples`` in all; the same
    arrays as the JAX package's, element for element."""

    def __init__(self, sample_rate: float = 2.56e6, frequency: float = 100e6,
                 gain: float = 0.0, total_samples: int = 1 << 22, seed: int = 0,
                 tones: tuple[float, ...] = (-0.3, -0.05, 0.1, 0.27)):
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.gain = gain
        self.remaining = total_samples
        self.rng = np.random.default_rng(seed)
        self.tones = tones
        self.n = 0

    def read(self):
        if self.remaining <= 0:
            return None
        m = min(self.mtu, self.remaining)
        t = np.arange(self.n, self.n + m)
        x = np.zeros(m, dtype=np.complex128)
        for i, f in enumerate(self.tones):
            x += (0.5 / (i + 1)) * np.exp(2j * np.pi * np.mod(f * t, 1.0))
        x += 0.01 * (self.rng.normal(size=m) + 1j * self.rng.normal(size=m))
        self.n += m
        self.remaining -= m
        return x.astype(np.complex64)


_DRIVERS: dict[str, Callable[..., SdrSource]] = {"synthetic": SyntheticSdrSource}


def register_sdr_driver(name: str, factory: Callable[..., SdrSource]):
    """Make ``open_sdr(name, …)`` call ``factory(sample_rate=, frequency=,
    gain=, **kw)``."""
    _DRIVERS[name] = factory


def _load_soapy_shim():
    """Register the SoapySDR drivers where the ``SoapySDR`` module imports
    now (``io/soapy.py``).  Called at use, not at import: the shim imports
    this module, and the module may appear after the first import (a late
    install, or a test's fake in ``sys.modules``)."""
    from . import soapy

    soapy.register_if_available()


def enumerate_devices() -> list[dict]:
    """One ``{"driver": name}`` per registered driver (the reference's
    ``enumerate``)."""
    _load_soapy_shim()
    return [{"driver": name} for name in _DRIVERS]


def open_sdr(devname: str, sample_rate: float, frequency: float, gain: float,
             **kw) -> SdrSource:
    """Open the driver ``devname``, tuned to ``frequency`` Hz at
    ``sample_rate`` S/s (gain 0 = the device's AGC); KeyError names the
    drivers there are."""
    if devname not in _DRIVERS:
        _load_soapy_shim()
    if devname not in _DRIVERS:
        raise KeyError(f"SDR driver {devname!r} not found; have {list(_DRIVERS)}")
    return _DRIVERS[devname](sample_rate=sample_rate, frequency=frequency, gain=gain, **kw)
