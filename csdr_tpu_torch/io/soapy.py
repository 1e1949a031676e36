"""SoapySDR-backed ``SdrSource`` driver.

Counterpart of ``csdr_tpu/io/soapy.py``, the reference's SoapySDR wrapper
(Source.chs:103-257): make a device from ``{"driver": name}`` arguments,
configure RX channel 0 (sample rate, frequency; gain 0 turns the hardware
AGC on, any other value sets the overall gain), set up a CF32 stream with
30 buffers, and read MTU-sized chunks with a 1 s timeout, where a timeout
or an error ends the stream.

``SoapySDR`` is imported when a driver is made or registered, never at
import time: importing this module opens nothing and needs no SoapySDR.
``register_if_available()`` adds ``soapy`` and one driver per enumerated
device to ``io.sources``' registry where ``import SoapySDR`` succeeds;
``io.sources.enumerate_devices`` and ``open_sdr`` call it.
"""

from __future__ import annotations

import numpy as np

from .sources import SdrSource, register_sdr_driver

__all__ = ["SoapySdrSource", "available", "enumerate_soapy_devices", "register_if_available"]

_SOAPY_SDR_RX = 1          # SoapySDR.SOAPY_SDR_RX
_TIMEOUT_US = 1_000_000    # the reference reads with a 1 s timeout


def _import_soapy():
    try:
        import SoapySDR  # type: ignore
    except ImportError:
        return None
    return SoapySDR


def available() -> bool:
    return _import_soapy() is not None


def enumerate_soapy_devices() -> list[dict]:
    """Device argument dicts, one per device; empty without SoapySDR."""
    mod = _import_soapy()
    if mod is None:
        return []
    return [dict(kw) for kw in mod.Device.enumerate()]


class SoapySdrSource(SdrSource):
    """One RX channel of a SoapySDR device as complex64 chunks."""

    def __init__(self, sample_rate: float, frequency: float, gain: float = 0.0,
                 driver: str = "rtlsdr", channel: int = 0, device_args: dict | None = None,
                 _module=None, **kw):
        mod = _module if _module is not None else _import_soapy()
        if mod is None:
            raise RuntimeError("SoapySDR is not importable; use the rtl_tcp or synthetic "
                               "driver, or install SoapySDR on a host with hardware")
        rx = getattr(mod, "SOAPY_SDR_RX", _SOAPY_SDR_RX)
        cf32 = getattr(mod, "SOAPY_SDR_CF32", "CF32")
        args = {"driver": driver, **(device_args or {})}
        self._dev = mod.Device(args)
        self._ch = channel
        self.sample_rate, self.frequency, self.gain = sample_rate, frequency, gain
        self._dev.setSampleRate(rx, channel, float(sample_rate))
        self._dev.setFrequency(rx, channel, float(frequency))
        if gain == 0.0:
            self._dev.setGainMode(rx, channel, True)  # gain 0 = hardware AGC
        else:
            self._dev.setGain(rx, channel, float(gain))
        self._stream = self._dev.setupStream(rx, cf32, [channel], {"buffers": "30"})
        self._dev.activateStream(self._stream)
        mtu = int(self._dev.getStreamMTU(self._stream))
        self.mtu = mtu if mtu > 0 else SdrSource.mtu
        self._buf = np.empty(self.mtu, np.complex64)
        self._closed = False

    def read(self) -> np.ndarray | None:
        """One chunk of at most the MTU; None on a timeout or an error."""
        if self._closed:
            return None
        sr = self._dev.readStream(self._stream, [self._buf], self.mtu, timeoutUs=_TIMEOUT_US)
        n = int(getattr(sr, "ret", sr))  # a StreamResult, or an int in some bindings
        if n <= 0:
            return None
        return self._buf[:n].copy()  # the buffer is reused by the next read

    def close(self):
        """Deactivate and close the stream once; teardown errors are ignored,
        as the reference's ``try`` ignores them (the device may be gone)."""
        if self._closed:
            return
        self._closed = True
        for op in (self._dev.deactivateStream, self._dev.closeStream):
            try:
                op(self._stream)
            except Exception:
                pass


def register_if_available() -> bool:
    """Register ``soapy`` and one driver per enumerated device; False, and
    nothing registered, without the SoapySDR module."""
    if not available():
        return False
    register_sdr_driver("soapy", SoapySdrSource)
    for kw in enumerate_soapy_devices():
        drv = kw.get("driver")
        if drv and drv != "soapy":
            register_sdr_driver(
                drv, lambda sample_rate, frequency, gain=0.0, _d=drv, **k:
                SoapySdrSource(sample_rate, frequency, gain, driver=_d, **k))
    return True
