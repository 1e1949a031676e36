"""rtl_tcp client and server: an SDR device over the network.

Counterpart of ``csdr_tpu/io/rtl_tcp.py``.  The rtl_tcp protocol (shipped
with librtlsdr, spoken by gqrx, SDR# and SoapyRemote bridges):

  * on connect the server sends a 12-byte greeting: ``RTL0``, the tuner
    type and the tuner's gain count (u32 big-endian each);
  * the client configures the dongle with 5-byte commands, ``u8 cmd`` then a
    u32 big-endian argument (0x01 frequency Hz, 0x02 sample rate, 0x03 gain
    mode 0 auto / 1 manual, 0x04 gain in tenths of dB, 0x05 ppm, …);
  * the server then streams interleaved unsigned 8-bit IQ.

``RtlTcpSource`` is the client, registered as the ``"rtl_tcp"`` driver of
``io.sources`` (``--devname rtl_tcp``): MTU-sized reads with a 1 s socket
timeout, and a timeout or a closed connection ends the stream, as the
reference's device reads do (Source.chs:226-233).  ``RtlTcpServer`` serves
any chunk iterator to rtl_tcp clients.  Importing this module opens no
socket.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
import time

import numpy as np

from .sources import SdrSource, register_sdr_driver

__all__ = ["RtlTcpSource", "RtlTcpServer", "iq_from_u8", "RTL_MAGIC", "CMD_NAMES",
           "TUNER_NAMES"]

RTL_MAGIC = b"RTL0"

_CMD_FREQUENCY = 0x01
_CMD_SAMPLE_RATE = 0x02
_CMD_GAIN_MODE = 0x03
_CMD_GAIN = 0x04
_CMD_FREQ_CORRECTION = 0x05   # ppm, signed
_CMD_DIRECT_SAMPLING = 0x09   # 0 off / 1 I-branch / 2 Q-branch
_CMD_OFFSET_TUNING = 0x0A
_CMD_GAIN_INDEX = 0x0D        # tuner gain by index into the gain table
_CMD_BIAS_TEE = 0x0E          # librtlsdr >= 0.6 bias-T GPIO

# librtlsdr's command set, for the server's command log
CMD_NAMES = {
    0x01: "set_frequency", 0x02: "set_sample_rate", 0x03: "set_gain_mode",
    0x04: "set_gain", 0x05: "set_freq_correction", 0x06: "set_if_gain",
    0x07: "set_test_mode", 0x08: "set_agc_mode", 0x09: "set_direct_sampling",
    0x0A: "set_offset_tuning", 0x0B: "set_rtl_xtal", 0x0C: "set_tuner_xtal",
    0x0D: "set_gain_by_index", 0x0E: "set_bias_tee",
}

# the greeting's tuner type → tuner chip (librtlsdr's enum)
TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}

_U8_SCALE = np.float32(1.0 / 127.5)
_SEND_TIMEOUT = 30.0  # s the server waits on a client that stops reading


def iq_from_u8(u8: np.ndarray) -> np.ndarray:
    """Interleaved uint8 IQ (even length) → complex64 ``(u8 − 127.5)·(1/127.5)``
    in float32, bit for bit the JAX client's conversion."""
    f = (u8.astype(np.float32) - np.float32(127.5)) * _U8_SCALE
    return f.view(np.complex64)


class RtlTcpSource(SdrSource):
    """Complex64 IQ over an rtl_tcp connection.

    ``host``/``port`` default to ``$CSDR_RTLTCP_ADDR`` (``host:port``, else
    127.0.0.1:1234).  ``raw_u8=True`` yields the wire's interleaved uint8
    instead, for ``blocks.u8_to_iq`` on the device (2 bytes per sample to
    the card instead of 8).  ``reconnect=N`` (default
    ``$CSDR_RTLTCP_RECONNECT``, else 0) re-dials up to N times after a
    timeout or a drop, with a linear back-off of ``reconnect_wait`` s;
    samples lost in the outage are gone.  Gain 0 is the tuner's AGC unless
    ``gain_mode="manual"``; ``ppm`` (0x05), ``bias_t`` (0x0E),
    ``direct_sampling`` (0x09), ``offset_tuning`` (0x0A) and ``gain_index``
    (0x0D, in place of the tenth-dB gain) are sent after the rate,
    frequency and gain, on every dial: a server forgets the tuning with the
    connection."""

    mtu = 1 << 17  # samples per read

    def __init__(self, sample_rate: float = 2.4e6, frequency: float = 100e6,
                 gain: float = 0.0, host: str | None = None, port: int | None = None,
                 timeout: float = 1.0, raw_u8: bool = False, reconnect: int | None = None,
                 reconnect_wait: float = 0.1, gain_mode: str | None = None, ppm: int = 0,
                 bias_t: bool = False, direct_sampling: int = 0, offset_tuning: bool = False,
                 gain_index: int | None = None):
        if host is None or port is None:
            addr = os.environ.get("CSDR_RTLTCP_ADDR", "127.0.0.1:1234")
            h, colon, p = addr.rpartition(":")
            if not colon or not p.isdigit():
                raise ValueError(f"CSDR_RTLTCP_ADDR must be host:port, got {addr!r}")
            host = host or h
            port = port or int(p)
        if gain_mode not in (None, "auto", "manual"):
            raise ValueError(f"gain_mode must be 'auto'/'manual', got {gain_mode!r}")
        if direct_sampling not in (0, 1, 2):
            raise ValueError(f"direct_sampling must be 0/1/2, got {direct_sampling}")
        self.gain_mode = gain_mode or ("manual" if gain else "auto")
        self.ppm = int(ppm)
        self.bias_t = bool(bias_t)
        self.direct_sampling = int(direct_sampling)
        self.offset_tuning = bool(offset_tuning)
        self.gain_index = gain_index
        self.raw_u8 = raw_u8
        self.sample_rate, self.frequency, self.gain = sample_rate, frequency, gain
        self.host, self.port = host, port
        self.timeout = timeout
        if reconnect is None:
            reconnect = int(os.environ.get("CSDR_RTLTCP_RECONNECT", "0"))
        self.reconnect = int(reconnect)
        self.reconnect_wait = float(reconnect_wait)
        self.reconnects = 0  # successful re-dials over the source's lifetime
        self._dial()

    def _dial(self):
        """Connect, check the greeting and send the tuning."""
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=max(self.timeout, 5.0))
        try:
            self.sock.settimeout(self.timeout)
            self._pend = b""  # the I byte of a half-received IQ pair
            hdr = self._recv_exact(12)
            if hdr is None or len(hdr) < 12 or hdr[:4] != RTL_MAGIC:
                raise ConnectionError(f"not an rtl_tcp server at {self.host}:{self.port} "
                                      f"(header {hdr!r})")
            self.tuner_type, self.gain_count = struct.unpack(">II", hdr[4:])
            self._cmd(_CMD_SAMPLE_RATE, int(self.sample_rate))
            self._cmd(_CMD_FREQUENCY, int(self.frequency))
            if self.gain_index is not None:
                self._cmd(_CMD_GAIN_MODE, 1)
                self._cmd(_CMD_GAIN_INDEX, int(self.gain_index))
            elif self.gain_mode == "manual":
                self._cmd(_CMD_GAIN_MODE, 1)
                self._cmd(_CMD_GAIN, int(round(self.gain * 10.0)))
            else:
                self._cmd(_CMD_GAIN_MODE, 0)
            if self.ppm:
                self._cmd(_CMD_FREQ_CORRECTION, self.ppm)  # two's complement on the wire
            if self.direct_sampling:
                self._cmd(_CMD_DIRECT_SAMPLING, self.direct_sampling)
            if self.offset_tuning:
                self._cmd(_CMD_OFFSET_TUNING, 1)
            if self.bias_t:
                self._cmd(_CMD_BIAS_TEE, 1)
        except BaseException:
            self.sock.close()
            raise

    def _try_reconnect(self) -> bool:
        """Re-dial up to ``reconnect`` times; False (the stream ends) when
        every dial failed."""
        self.close()
        for attempt in range(self.reconnect):
            time.sleep(self.reconnect_wait * (attempt + 1))
            try:
                self._dial()
            except OSError:  # ConnectionError is one
                continue
            self.reconnects += 1
            return True
        return False

    def _cmd(self, cmd: int, arg: int):
        self.sock.sendall(struct.pack(">BI", cmd, arg & 0xFFFFFFFF))

    def _recv_exact(self, n: int) -> bytes | None:
        """Up to n bytes: fewer where the read timed out or the server
        closed after some, None where nothing came."""
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except OSError:  # socket.timeout is one
                break
            if not chunk:
                break
            buf.extend(chunk)
        return bytes(buf) if buf else None

    def read(self):
        # a stalled server can hand over an odd byte count: the dangling I
        # byte is carried in _pend, else I and Q swap for the rest of the
        # stream; a half pair at the end of the stream is dropped
        while True:
            raw = self._recv_exact(self.mtu * 2 - len(self._pend))
            if not raw:
                if self._try_reconnect():
                    continue
                return None
            data = self._pend + raw
            keep = len(data) & ~1
            self._pend = data[keep:]
            if keep:
                break
        u8 = np.frombuffer(data, dtype=np.uint8, count=keep)
        return u8 if self.raw_u8 else iq_from_u8(u8)

    @property
    def tuner_name(self) -> str:
        """The dongle's tuner chip, from the greeting."""
        return TUNER_NAMES.get(self.tuner_type, f"type{self.tuner_type}")

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class RtlTcpServer:
    """Serve IQ to rtl_tcp clients (gqrx, SDR#, rtl_fm, ``RtlTcpSource``).

    ``make_source()`` is called once per client and returns an iterator of
    chunks: complex64 in [−1, 1] (quantized to the wire's uint8 as a dongle
    does, round(v·127.5 + 127.5) clipped to 0..255) or uint8 (sent as is,
    (n, 2) rows included).  One client at a time, until ``close()``.  Every
    5-byte command a client sends is kept in ``commands`` (named by
    ``commands_named()``); the stream does not change with them, as
    rtl_tcp serving a recording.  A client that goes away ends its stream;
    a failure of the source is kept in ``error`` and printed, not taken
    for a disconnect, and so is a client that stops reading for
    ``_SEND_TIMEOUT`` s."""

    def __init__(self, make_source, host: str = "127.0.0.1", port: int = 0,
                 tuner_type: int = 5, gain_count: int = 29):
        self.make_source = make_source
        self.tuner_type, self.gain_count = tuner_type, gain_count
        self.commands: list[tuple[int, int]] = []
        self.clients_served = 0
        self.error: Exception | None = None
        self._closing = False
        self.srv = socket.socket()
        try:
            self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.srv.bind((host, port))
            self.srv.listen(1)
        except OSError:
            self.srv.close()
            raise
        self.host, self.port = self.srv.getsockname()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    @staticmethod
    def _to_wire(chunk) -> bytes:
        a = np.asarray(chunk)
        if a.dtype == np.uint8:
            return a.tobytes()
        u8 = np.empty(2 * len(a), np.uint8)
        u8[0::2] = np.clip(np.round(a.real * 127.5 + 127.5), 0, 255)
        u8[1::2] = np.clip(np.round(a.imag * 127.5 + 127.5), 0, 255)
        return u8.tobytes()

    def _drain(self, conn):
        """Record the client's commands until it closes its side."""
        buf = b""
        try:
            while True:
                got = conn.recv(256)
                if not got:
                    return
                buf += got
                while len(buf) >= 5:
                    self.commands.append(struct.unpack(">BI", buf[:5]))
                    buf = buf[5:]
        except OSError:
            pass

    def _serve(self):
        while not self._closing:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return  # close() shut the listener down
            try:
                conn.settimeout(_SEND_TIMEOUT)
                conn.sendall(RTL_MAGIC + struct.pack(">II", self.tuner_type, self.gain_count))
            except OSError:
                # the client reset before the greeting (a port scanner): serve on
                conn.close()
                continue
            drainer = threading.Thread(target=self._drain, args=(conn,), daemon=True)
            drainer.start()
            try:
                for chunk in self.make_source():
                    if self._closing:
                        break
                    conn.sendall(self._to_wire(chunk))
            except (BrokenPipeError, ConnectionResetError, ConnectionAbortedError,
                    socket.timeout):
                pass  # the client went away mid-stream
            except Exception as e:  # the source failed: keep it, serve the next client
                self.error = e
                print(f"rtl_tcp server: source error: {type(e).__name__}: {e}",
                      file=sys.stderr)
            finally:
                # half-close and wait for the client to close: closing at once,
                # with its commands unread in our receive buffer, sends a RST
                # that drops IQ the client has not read yet
                try:
                    conn.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                drainer.join(timeout=5)
                conn.close()
                self.clients_served += 1

    def commands_named(self) -> list[tuple[str, int]]:
        """The command log with librtlsdr's names."""
        return [(CMD_NAMES.get(c, f"cmd_0x{c:02x}"), a) for c, a in self.commands]

    def close(self):
        self._closing = True
        try:
            self.srv.shutdown(socket.SHUT_RDWR)  # wakes the accept(); close() alone does not
        except OSError:
            pass
        self.srv.close()
        self.thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


register_sdr_driver("rtl_tcp", RtlTcpSource)
