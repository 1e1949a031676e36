"""The port's rtl_tcp client and server (csdr_tpu_torch/io/rtl_tcp.py,
apps/rtl_tcp_server.py) over loopback sockets, as tests/test_rtl_tcp.py
holds the JAX package's; and the wire between the two packages: either
client on either server gives the same arrays and the same command log.

Every server binds port 0 on 127.0.0.1; every socket has a timeout, every
thread is joined with one, and both are closed in a ``finally``.  The
client's complex64 against the wire: 1e-6 (tests/test_rtl_tcp.py:75, a
1-ulp difference of ·(1/127.5) against /127.5); against the JAX client:
bit for bit.  The CLI runs --device cpu."""

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from csdr_tpu.io import rtl_tcp as jax_rtl

import csdr_tpu_torch as ct
from csdr_tpu_torch.apps import rtl_tcp_server as srv_app
from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
from csdr_tpu_torch.io.rtl_tcp import RTL_MAGIC, RtlTcpServer, RtlTcpSource, iq_from_u8
from csdr_tpu_torch.io.wav import read_wav

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 10.0


def make_u8_iq(n, f=0.1, amp=0.9):
    t = np.arange(n)
    z = amp * np.exp(2j * np.pi * np.mod(f * t, 1.0))
    u8 = np.empty(2 * n, dtype=np.uint8)
    u8[0::2] = np.round(z.real * 127.5 + 127.5).astype(np.uint8)
    u8[1::2] = np.round(z.imag * 127.5 + 127.5).astype(np.uint8)
    return u8


def wire_iq(u8):
    want = ((u8.astype(np.float32) - 127.5) / 127.5).reshape(-1, 2)
    return (want[:, 0] + 1j * want[:, 1]).astype(np.complex64)


def listener():
    srv = socket.socket()
    srv.settimeout(JOIN_S)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    return srv


class ScriptedServer:
    """A raw rtl_tcp server on its own thread: ``script(srv)`` accepts and
    serves; ``commands`` holds every 5-byte command that arrived."""

    def __init__(self, script):
        self.srv = listener()
        self.port = self.srv.getsockname()[1]
        self.commands: list[tuple[int, int]] = []
        self.configs: list[dict] = []
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(script,), daemon=True)
        self.thread.start()

    def _run(self, script):
        try:
            script(self)
        except Exception as e:  # surfaced by close()
            self.error = e
        finally:
            self.srv.close()

    def accept(self, tuner_type=5, gain_count=29, header=None):
        conn, _ = self.srv.accept()
        conn.settimeout(0.5)
        conn.sendall(RTL_MAGIC + struct.pack(">II", tuner_type, gain_count)
                     if header is None else header)
        return conn

    def drain(self, conn, until: int | None = None):
        """Read commands until the client closes, a timeout, or ``until``
        distinct commands arrived; returns {cmd: arg} of this connection."""
        seen, buf = {}, b""
        try:
            while until is None or len(seen) < until:
                got = conn.recv(5)
                if not got:
                    break
                buf += got
                while len(buf) >= 5:
                    cmd, arg = struct.unpack(">BI", buf[:5])
                    self.commands.append((cmd, arg))
                    seen[cmd] = arg
                    buf = buf[5:]
        except OSError:
            pass
        return seen

    def close(self):
        self.thread.join(timeout=JOIN_S)
        assert not self.thread.is_alive(), "server thread still running"
        if self.error is not None:
            raise self.error


def stream_once(payload: bytes, tuner_type=5, gain_count=29):
    """header → commands (drained on a second thread) → payload → close."""
    def script(s):
        conn = s.accept(tuner_type, gain_count)
        try:
            drainer = threading.Thread(target=s.drain, args=(conn,), daemon=True)
            drainer.start()
            view = memoryview(payload)
            try:  # a client that has what it needs hangs up mid-stream
                for i in range(0, len(view), 65536):
                    conn.sendall(view[i:i + 65536])
                time.sleep(0.2)  # let the client read before the close
                conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            drainer.join(timeout=JOIN_S)
        finally:
            conn.close()
    return ScriptedServer(script)


def read_all(src) -> np.ndarray:
    try:
        return np.concatenate(list(src))
    finally:
        src.close()


def test_rtl_tcp_source_protocol_and_data():
    n = 300_000
    u8 = make_u8_iq(n)
    srv = stream_once(bytes(u8))
    src = RtlTcpSource(sample_rate=1.024e6, frequency=99.5e6, gain=28.0,
                       host="127.0.0.1", port=srv.port)
    assert src.tuner_type == 5 and src.gain_count == 29
    got = read_all(src)  # the server's close ends the stream
    srv.close()
    assert got.dtype == np.complex64 and len(got) == n
    assert np.max(np.abs(got - wire_iq(u8))) < 1e-6
    cmds = dict(srv.commands)
    assert cmds.get(0x02) == 1_024_000 and cmds.get(0x01) == 99_500_000
    assert cmds.get(0x03) == 1 and cmds.get(0x04) == 280


def test_rtl_tcp_raw_u8_mode_matches_device_conversion():
    """raw_u8 yields the wire's bytes; the port's u8_to_iq block on them
    equals the host's conversion, and iq_from_u8 is the JAX client's
    conversion bit for bit."""
    n = 100_000
    u8 = make_u8_iq(n, f=0.07)
    srv = stream_once(bytes(u8))
    raw = read_all(RtlTcpSource(host="127.0.0.1", port=srv.port, raw_u8=True))
    srv.close()
    assert raw.dtype == np.uint8 and np.array_equal(raw, u8)
    blk = ct.u8_to_iq()
    _, iq = blk.apply(blk.init(torch.device("cpu")), torch.from_numpy(raw.reshape(-1, 2)))
    assert np.max(np.abs(iq.numpy() - wire_iq(u8))) < 1e-6
    f = (u8.astype(np.float32) - 127.5) * np.float32(1.0 / 127.5)
    jax_conv = (f.reshape(-1, 2)[:, 0] + 1j * f.reshape(-1, 2)[:, 1]).astype(np.complex64)
    assert np.array_equal(iq_from_u8(u8).view(np.uint32), jax_conv.view(np.uint32))


def test_rtl_tcp_odd_burst_stalls_keep_iq_pairing():
    """Odd-sized bursts between stalls longer than the read timeout: the
    dangling byte is carried across reads, so I and Q never swap."""
    n = 8192
    u8 = make_u8_iq(n, f=0.05)
    buf = bytes(u8)

    def script(s):
        conn = s.accept(tuner_type=1)
        try:
            s.drain(conn, until=3)
            cuts = [0, 4097, 4097 + 1999, len(buf)]
            for a, b in zip(cuts[:-1], cuts[1:]):
                conn.sendall(buf[a:b])
                time.sleep(0.35)
        finally:
            conn.close()

    srv = ScriptedServer(script)
    rx = read_all(RtlTcpSource(host="127.0.0.1", port=srv.port, raw_u8=True, timeout=0.2,
                               reconnect=0))
    srv.close()
    assert len(rx) % 2 == 0 and len(rx) >= len(u8) - 2
    assert np.array_equal(rx, u8[:len(rx)])


@pytest.mark.parametrize("header", [RTL_MAGIC + b"\x00\x01", b"HTTP/1.1 400\r\n\r\n"],
                         ids=["truncated", "http"])
def test_rtl_tcp_bad_greeting_raises_connection_error(header):
    """A truncated RTL0 greeting, or another protocol, is a ConnectionError
    (what the CLI reports as "Failed to open device"), not struct.error."""
    def script(s):
        conn = s.accept(header=header)
        try:
            time.sleep(0.6)
        finally:
            conn.close()

    srv = ScriptedServer(script)
    with pytest.raises(ConnectionError, match="not an rtl_tcp server"):
        RtlTcpSource(host="127.0.0.1", port=srv.port, timeout=0.3)
    srv.close()


def flaky(segments: list[bytes]):
    """Drops the connection after each segment and takes a fresh one."""
    def script(s):
        for seg in segments:
            conn = s.accept()
            try:
                s.configs.append(s.drain(conn, until=3))
                conn.sendall(seg)
                time.sleep(0.25)
            finally:
                conn.close()
    return ScriptedServer(script)


def test_rtl_tcp_reconnect_resumes_stream():
    n1, n2 = 100_000, 60_000
    a, b = make_u8_iq(n1, f=0.03), make_u8_iq(n2, f=0.11)
    srv = flaky([bytes(a), bytes(b)])
    src = RtlTcpSource(sample_rate=1.024e6, frequency=99.5e6, host="127.0.0.1",
                       port=srv.port, raw_u8=True, timeout=0.3, reconnect=3,
                       reconnect_wait=0.05)
    rx = read_all(src)
    srv.close()
    assert src.reconnects == 1
    assert len(rx) == 2 * (n1 + n2)
    assert np.array_equal(rx[:2 * n1], a) and np.array_equal(rx[2 * n1:], b)
    assert len(srv.configs) == 2
    for cfg in srv.configs:  # the tuning replayed on the new connection
        assert cfg.get(0x02) == 1_024_000 and cfg.get(0x01) == 99_500_000


def test_rtl_tcp_reconnect_budget_exhaustion_is_graceful_eos():
    a = make_u8_iq(50_000)
    srv = flaky([bytes(a)])
    src = RtlTcpSource(host="127.0.0.1", port=srv.port, raw_u8=True, timeout=0.3,
                       reconnect=2, reconnect_wait=0.05)
    rx = read_all(src)
    srv.close()
    assert np.array_equal(rx, a) and src.reconnects == 0


def fm_u8(n, amp=0.95):
    t = np.arange(n)
    msg = 0.4 * np.sin(2 * np.pi * 0.002 * t)
    z = amp * np.exp(1j * 2 * np.pi * 0.6 * np.cumsum(msg))
    u8 = np.empty(2 * n, dtype=np.uint8)
    u8[0::2] = np.round(z.real * 127.5 + 127.5).astype(np.uint8)
    u8[1::2] = np.round(z.imag * 127.5 + 127.5).astype(np.uint8)
    return u8


def assert_tone(path, nsamp):
    audio, _ = read_wav(path)
    assert len(audio) == nsamp
    seg = audio[4096:65536 + 4096].astype(np.float64)
    S = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f_peak = (np.argmax(S[1:]) + 1) / len(seg)
    assert abs(f_peak - 0.002) < 2e-4, f_peak


def test_rtl_tcp_through_full_cli(tmp_path, monkeypatch):
    """--devname rtl_tcp → NBFM demod → WAV of exactly -n samples, on the
    message tone."""
    srv = stream_once(bytes(fm_u8(400_000)))
    monkeypatch.setenv("CSDR_RTLTCP_ADDR", f"127.0.0.1:{srv.port}")
    out = tmp_path / "rtltcp_out"
    rc = cli_main(["--devname", "rtl_tcp", "-s", "512000", "-f", "100000000",
                   "--demod", "DeNBFM 0.6 WAV", "-n", "262144", "--blocksize", "65536",
                   "-o", str(out), "--device", "cpu"])
    srv.close()
    assert rc == 0
    assert_tone(str(out) + ".wav", 262144)


def test_rtl_tcp_manual_zero_db_gain():
    srv = stream_once(bytes(make_u8_iq(1024)))
    read_all(RtlTcpSource(host="127.0.0.1", port=srv.port, gain=0.0, gain_mode="manual"))
    srv.close()
    cmds = dict(srv.commands)
    assert cmds.get(0x03) == 1 and cmds.get(0x04) == 0


def test_rtl_tcp_bad_addr_and_gain_mode_raise(monkeypatch):
    monkeypatch.setenv("CSDR_RTLTCP_ADDR", "justahost")
    with pytest.raises(ValueError, match="host:port"):
        RtlTcpSource()
    monkeypatch.delenv("CSDR_RTLTCP_ADDR")
    with pytest.raises(ValueError, match="gain_mode"):
        RtlTcpSource(host="127.0.0.1", port=1, gain_mode="loud")


def test_rtl_tcp_server_roundtrip_with_own_client():
    n = 200_000
    z = (0.8 * np.exp(2j * np.pi * 0.01 * np.arange(n))).astype(np.complex64)
    with RtlTcpServer(lambda: iter([z[:70_000], z[70_000:]])) as srv:
        rx = read_all(RtlTcpSource(sample_rate=1.024e6, frequency=88e6, gain=10.0,
                                   host=srv.host, port=srv.port))
        assert len(rx) == n
        assert np.max(np.abs(rx - z)) < 1.0 / 127.5  # half an LSB each way
        wait_for(lambda: srv.clients_served == 1)
        cmds = dict(srv.commands)
        assert cmds.get(0x01) == 88_000_000 and cmds.get(0x02) == 1_024_000


def wait_for(cond, secs=JOIN_S):
    end = time.monotonic() + secs
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.02)


def test_rtl_tcp_server_u8_passthrough_and_reconnect():
    """uint8 chunks, (n, 2) rows as the port's cu8 source yields them, go on
    the wire untouched; each client gets a fresh stream."""
    u8 = make_u8_iq(50_000, f=0.02)
    with RtlTcpServer(lambda: iter([u8[:20_000].reshape(-1, 2), u8[20_000:]])) as srv:
        for k in range(2):
            rx = read_all(RtlTcpSource(host=srv.host, port=srv.port, raw_u8=True))
            assert np.array_equal(rx, u8)
            wait_for(lambda: srv.clients_served == k + 1)


def test_rtl_tcp_server_survives_greeting_reset():
    u8 = make_u8_iq(20_000, f=0.02)
    with RtlTcpServer(lambda: iter([u8])) as srv:
        for _ in range(3):
            s = socket.create_connection((srv.host, srv.port), timeout=JOIN_S)
            try:  # a RST on close, so the greeting's sendall can fail
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            finally:
                s.close()
        time.sleep(0.1)
        rx = read_all(RtlTcpSource(host=srv.host, port=srv.port, raw_u8=True))
        assert np.array_equal(rx, u8)


def test_rtl_tcp_server_cli_to_demod_cli(tmp_path, monkeypatch):
    """The server app serves a CF32 capture; the CLI demodulates it over
    TCP."""
    monkeypatch.chdir(tmp_path)
    n = 400_000
    t = np.arange(n)
    msg = 0.4 * np.sin(2 * np.pi * 0.002 * t)
    z = (0.9 * np.exp(1j * 2 * np.pi * 0.6 * np.cumsum(msg))).astype(np.complex64)
    z.tofile("cap.cf32")
    opts = srv_app.build_parser().parse_args(["--filename", "cap.cf32", "--port", "0",
                                              "--clients", "1"])
    holder = {}

    def capture(*a, **kw):
        holder["srv"] = RtlTcpServer(*a, **kw)
        return holder["srv"]

    monkeypatch.setattr(srv_app, "RtlTcpServer", capture)
    result = {}
    th = threading.Thread(target=lambda: result.setdefault("rc", srv_app.run_opts(opts)),
                          daemon=True)
    th.start()
    try:
        wait_for(lambda: "srv" in holder)
        monkeypatch.setenv("CSDR_RTLTCP_ADDR", f"127.0.0.1:{holder['srv'].port}")
        rc = cli_main(["--devname", "rtl_tcp", "-s", "512000", "-f", "100000000",
                       "--demod", "DeNBFM 0.6 WAV", "-n", "262144", "--blocksize", "65536",
                       "-o", "net", "--device", "cpu"])
    finally:
        th.join(timeout=JOIN_S)
    assert not th.is_alive() and result["rc"] == 0
    assert rc == 0
    assert_tone("net.wav", 262144)


def test_rtl_tcp_server_missing_file_and_source_error():
    """A missing capture is a clean exit 1; a source failure mid-stream is
    kept on srv.error, not taken for a disconnect."""
    opts = srv_app.build_parser().parse_args(["--filename", "/nonexistent/cap.cf32"])
    assert srv_app.run_opts(opts) == 1

    def bad_source():
        yield make_u8_iq(1000)
        raise OSError("disk on fire")

    with RtlTcpServer(bad_source) as srv:
        rx = read_all(RtlTcpSource(host=srv.host, port=srv.port, raw_u8=True))
        assert len(rx) == 2000  # the good chunk was delivered
        wait_for(lambda: srv.error is not None)
        assert isinstance(srv.error, OSError) and "disk on fire" in str(srv.error)


def test_rtl_tcp_protocol_extensions_sent_on_dial():
    """ppm, bias-T, direct sampling, offset tuning and gain-by-index go out
    as librtlsdr's 0x05/0x0E/0x09/0x0A/0x0D; the tuner name comes from the
    greeting."""
    srv = stream_once(bytes(np.arange(4096, dtype=np.uint8)), tuner_type=6)
    src = RtlTcpSource(sample_rate=1.0e6, frequency=96.3e6, port=srv.port, host="127.0.0.1",
                       ppm=-12, bias_t=True, direct_sampling=2, offset_tuning=True,
                       gain_index=7)
    assert src.tuner_name == "R828D"
    read_all(src)
    srv.close()
    cmds = dict(srv.commands)
    assert cmds[0x05] == (-12) & 0xFFFFFFFF  # two's complement on the wire
    assert cmds[0x0E] == 1 and cmds[0x09] == 2 and cmds[0x0A] == 1 and cmds[0x0D] == 7
    assert cmds[0x03] == 1 and 0x04 not in cmds  # gain by index is manual, no tenth-dB gain


def test_rtl_tcp_extensions_validate_and_cli_passthrough(tmp_path, monkeypatch):
    """--ppm and --bias-t reach the wire through the CLI; the server names
    them."""
    with pytest.raises(ValueError, match="direct_sampling"):
        RtlTcpSource(port=1, host="x", direct_sampling=3)
    z = np.frombuffer(iq_from_u8(fm_u8(200_000)).tobytes(), np.complex64)
    with RtlTcpServer(lambda: iter([z])) as srv:
        monkeypatch.setenv("CSDR_RTLTCP_ADDR", f"127.0.0.1:{srv.port}")
        out = tmp_path / "ext_out"
        rc = cli_main(["--devname", "rtl_tcp", "-s", "512000", "-f", "100000000",
                       "--ppm", "-25", "--bias-t", "--demod", "DeNBFM 0.6 WAV", "-n", "65536",
                       "--blocksize", "65536", "-o", str(out), "--device", "cpu"])
        assert rc == 0
        wait_for(lambda: srv.clients_served == 1)
        named = dict(srv.commands_named())
    assert os.path.getsize(str(out) + ".wav") == 65536 * 4 + 44
    assert named["set_freq_correction"] == (-25) & 0xFFFFFFFF
    assert named["set_bias_tee"] == 1 and named["set_sample_rate"] == 512000


def test_server_app_prints_its_port_and_command_log(tmp_path):
    """``python -m csdr_tpu_torch.apps.rtl_tcp_server --port 0 --clients 1
    -v``: the port on the first line, the client's commands when it is
    done, then the count."""
    u8 = make_u8_iq(70_000, f=0.04)
    cap = tmp_path / "cap.cu8"
    u8.tofile(cap)
    proc = subprocess.Popen([sys.executable, "-m", "csdr_tpu_torch.apps.rtl_tcp_server",
                             "--filename", str(cap), "--port", "0", "--clients", "1", "-v"],
                            stdout=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO))
    try:
        first = proc.stdout.readline()
        assert first.startswith("rtl_tcp server on 127.0.0.1:"), first
        port = int(first.rsplit(":", 1)[1])
        rx = read_all(RtlTcpSource(sample_rate=2.56e6, frequency=101e6, host="127.0.0.1",
                                   port=port, raw_u8=True, ppm=3))
        out, _ = proc.communicate(timeout=30)
    finally:
        proc.kill()
        proc.wait(timeout=JOIN_S)
    assert np.array_equal(rx, u8)
    assert proc.returncode == 0
    lines = out.splitlines()
    assert lines[-1] == "served 1 client(s)"
    import json

    log = json.loads(lines[-2].removeprefix("commands: "))
    assert log == [["set_sample_rate", 2560000], ["set_frequency", 101000000],
                   ["set_gain_mode", 0], ["set_freq_correction", 3]]


# ---- the wire between the packages -------------------------------------------

def close_jax_server(srv):
    """The JAX server's close() waits out its thread's accept() (closing a
    listener does not wake it on Linux); shutting the listener down first
    does."""
    try:
        srv.srv.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.close()


@pytest.mark.parametrize("raw_u8", [False, True])
def test_clients_and_servers_of_both_packages_interoperate(raw_u8):
    """Each client on each server: the same arrays, bit for bit, and the
    same command log (the quantizer of both servers and the conversion of
    both clients agree)."""
    rng = np.random.default_rng(7)
    n = 150_001
    z = (0.7 * (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n))).astype(np.complex64)
    chunks = [z[:33_333], z[33_333:100_000], z[100_000:]]
    kw = dict(sample_rate=1.92e6, frequency=162.0e6, gain=22.9, raw_u8=raw_u8, ppm=-4,
              bias_t=True, offset_tuning=True)
    results = {}
    jsrv = jax_rtl.RtlTcpServer(lambda: iter(chunks))
    try:
        with RtlTcpServer(lambda: iter(chunks)) as psrv:
            for sname, srv in (("jax", jsrv), ("port", psrv)):
                for cname, cls in (("jax", jax_rtl.RtlTcpSource), ("port", RtlTcpSource)):
                    before = len(srv.commands)
                    src = cls(host=srv.host, port=srv.port, **kw)
                    rx = read_all(src)
                    wait_for(lambda: len(srv.commands) >= before + 7)
                    results[sname, cname] = (rx, srv.commands[before:])
    finally:
        close_jax_server(jsrv)
    ref_rx, ref_cmds = results["jax", "jax"]
    assert len(ref_rx) == (2 * n if raw_u8 else n)
    for key, (rx, cmds) in results.items():
        assert rx.dtype == ref_rx.dtype, key
        assert np.array_equal(rx.view(np.uint8), ref_rx.view(np.uint8)), key
        assert cmds == ref_cmds, key
    assert dict(ref_cmds)[0x04] == 229 and dict(ref_cmds)[0x05] == (-4) & 0xFFFFFFFF
