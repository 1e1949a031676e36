"""ADS-B receiver — Mode S extended squitter (DF17/18) from 1090 MHz IQ.

Counterpart of ``csdr_tpu/models/adsb.py``: 1 Mb/s pulse-position
modulation, an 8 µs four-pulse preamble, 56/112-bit frames under CRC-24,
DF17 carrying callsign, CPR-coded airborne position and velocity.  On the
device: the envelope magnitude, then a ``Tee`` of the magnitude and a
zero-mean preamble matched filter, same-rate and sample-aligned.  On the
host: peak picking, PPM bit slicing, CRC and field extraction, on
candidate windows only.

Wire conventions (the test encoder uses the same): 1 µs bits in two 0.5 µs
chips, a pulse in the first half encoding 1 (PPM); preamble pulses at 0,
1.0, 3.5 and 4.5 µs, data from 8 µs; CRC-24 generator 0x1FFF409, a frame
valid iff the remainder over all its bits is zero; CPR with NZ = 15, the
global decode from one even and one odd frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.block import Block, Lambda, Tee, chain

__all__ = [
    "adsb_receiver", "decode_collected", "detect_frames", "decode_frame",
    "crc24", "cpr_global", "pair_positions",
    "make_es_position", "make_es_ident", "make_es_velocity",
    "adsb_modulate", "to_iq",
]

_CRC_GEN = 0x1FFF409  # 25-bit generator polynomial (leading term explicit)
_NZ = 15              # CPR latitude zones


def _preamble_pulse_slices(k: int) -> list[slice]:
    """Sample slices of the four preamble pulses at k samples per µs."""
    h = k // 2
    return [slice(0, h), slice(k, k + h), slice(7 * h, 8 * h), slice(9 * h, 10 * h)]


def _preamble_template(k: int) -> np.ndarray:
    """Zero-mean matched filter over the 8 µs preamble: +1/n_pulse on the
    four pulses, −1/n_quiet elsewhere, so score = mean(pulse) − mean(quiet)."""
    t = np.zeros(8 * k)
    for s in _preamble_pulse_slices(k):
        t[s] = 1.0
    npulse = t.sum()
    return np.where(t > 0, 1.0 / npulse, -1.0 / (t.size - npulse))


def adsb_receiver(sample_rate: float) -> Block:
    """cf32 IQ at ``sample_rate`` (2n MS/s: an even number of samples per
    µs) → (magnitude, preamble correlation), both at the input rate and
    sample-aligned.  The correlation FIR is causal with the reversed
    template as taps, so score[n] peaks at the last sample of a preamble
    and the frame's data begins at n + 1."""
    from ..blocks import FIRFilter

    k = sample_rate / 1e6
    if abs(k - round(k)) > 1e-9 or round(k) < 2 or round(k) % 2:
        raise ValueError(f"ADS-B needs sample_rate = 2n·1e6 (an even number of samples "
                         f"per µs), got {sample_rate}")
    k = int(round(k))
    corr = FIRFilter(_preamble_template(k)[::-1].copy(), complex_input=False,
                     name=f"preamble_corr(k={k})")
    return chain(Lambda(torch.abs, name="mag"),
                 Tee(Lambda(lambda x: x, name="mag_tap"), corr, name="adsb"))


# ---- host-side frame layer --------------------------------------------------

def crc24(bits: np.ndarray) -> int:
    """Mode S CRC-24 remainder of the given bit vector (MSB first).  A frame
    whose trailing 24 bits are the parity of the leading bits has
    remainder 0 (no init/xorout in the Mode S CRC)."""
    r = 0
    for b in np.asarray(bits, dtype=np.uint8):
        r = (r << 1) | int(b)
        if r & 0x1000000:
            r ^= _CRC_GEN
    return r


def detect_frames(mag: np.ndarray, score: np.ndarray, sample_rate: float,
                  max_candidates: int = 4096) -> list[dict]:
    """Peak-pick the correlation stream, slice PPM bits at each candidate,
    keep CRC-valid frames.  Returns decoded message dicts (decode_frame)."""
    k = int(round(sample_rate / 1e6))
    mag = np.asarray(mag, dtype=np.float64)
    score = np.asarray(score, dtype=np.float64)
    noise = float(np.median(mag)) + 1e-12
    # candidate = strict local PEAK of the correlation clearing the noise
    # floor (the vectorized peak test prunes the ~8k above-threshold samples
    # each preamble produces down to a handful); the window-max test below
    # and the CRC are the real arbiters, so this stays loose
    above = score > 2.0 * noise
    peak = np.zeros_like(above)
    peak[1:-1] = above[1:-1] & (score[1:-1] >= score[:-2]) \
        & (score[1:-1] > score[2:])
    cand = np.flatnonzero(peak)
    msgs, used = [], -1
    for n in cand:
        if n <= used or n + 1 + 112 * k > len(mag):
            continue
        w0, w1 = max(0, n - 8 * k), min(len(score), n + 8 * k)
        if score[n] < score[w0:w1].max():
            continue
        pre = mag[n + 1 - 8 * k:n + 1] if n + 1 >= 8 * k else None
        if pre is not None:
            pulse = np.concatenate([pre[s] for s in _preamble_pulse_slices(k)])
            quiet_mean = (pre.sum() - pulse.sum()) / (pre.size - pulse.size)
            if pulse.mean() < 2.0 * (quiet_mean + 1e-12):
                continue
        seg = mag[n + 1:n + 1 + 112 * k].reshape(112, k)
        h = k // 2
        bits = (seg[:, :h].sum(axis=1) > seg[:, h:].sum(axis=1)).astype(np.uint8)
        msg = decode_frame(bits)
        if msg is not None:
            msg["sample"] = int(n + 1)
            msgs.append(msg)
            used = n + 112 * k  # skip candidates inside this frame
            if len(msgs) >= max_candidates:
                break
    return msgs


def decode_collected(collected, sample_rate: float) -> list[dict]:
    """CollectSink.concat() of the adsb_receiver Tee → decoded messages.
    A 0-sample run leaves the sink empty (concat() returns a flat empty
    array, not the Tee tuple) — that is simply zero messages."""
    if isinstance(collected, np.ndarray) and collected.size == 0:
        return []
    mag, score = collected
    return detect_frames(np.asarray(mag), np.asarray(score), sample_rate)


def _i(bits: np.ndarray, lo: int, n: int) -> int:
    v = 0
    for b in bits[lo:lo + n]:
        v = (v << 1) | int(b)
    return v


_CALLSIGN_CS = ["#"] * 64
for _c in range(26):
    _CALLSIGN_CS[_c + 1] = chr(65 + _c)
_CALLSIGN_CS[32] = " "
for _c in range(10):
    _CALLSIGN_CS[48 + _c] = str(_c)


def decode_frame(bits: np.ndarray) -> dict | None:
    """112-bit frame → message dict, or None if the CRC rejects it.
    DF17/18: decodes the ME field (ident / airborne position / velocity);
    DF11 (all-call, first 56 bits): ICAO address only."""
    df = _i(bits, 0, 5)
    if df in (17, 18) and len(bits) >= 112 and crc24(bits[:112]) == 0:
        msg = {"df": df, "icao": _i(bits, 8, 24)}
        me = bits[32:88]
        tc = _i(me, 0, 5)
        msg["tc"] = tc
        if 1 <= tc <= 4:
            msg["callsign"] = "".join(
                _CALLSIGN_CS[_i(me, 8 + 6 * j, 6)] for j in range(8)).rstrip()
        elif 9 <= tc <= 18:
            alt12 = _i(me, 8, 12)
            if alt12 & 0x10:  # Q-bit: 25 ft increments
                n = ((alt12 & 0xFE0) >> 1) | (alt12 & 0x0F)
                msg["alt_ft"] = n * 25 - 1000
            msg["cpr_odd"] = int(me[21])
            msg["cpr_lat"] = _i(me, 22, 17)
            msg["cpr_lon"] = _i(me, 39, 17)
        elif tc == 19 and _i(me, 5, 3) in (1, 2):
            s_ew, v_ew = int(me[13]), _i(me, 14, 10)
            s_ns, v_ns = int(me[24]), _i(me, 25, 10)
            if v_ew and v_ns:
                vx = (v_ew - 1) * (-1 if s_ew else 1)
                vy = (v_ns - 1) * (-1 if s_ns else 1)
                msg["speed_kn"] = math.hypot(vx, vy)
                msg["track_deg"] = math.degrees(math.atan2(vx, vy)) % 360.0
            s_vr, vr = int(me[36]), _i(me, 37, 9)
            if vr:
                msg["vrate_fpm"] = (vr - 1) * 64 * (-1 if s_vr else 1)
        return msg
    if df == 11 and len(bits) >= 56 and crc24(bits[:56]) == 0:
        return {"df": df, "icao": _i(bits, 8, 24)}
    return None


# ---- CPR position codec ------------------------------------------------------

def _nl(lat: float) -> int:
    """Number of longitude zones at ``lat`` (ICAO NL function)."""
    if abs(lat) >= 87.0:
        return 1 if abs(lat) > 87.0 else 2
    a = 1 - math.cos(math.pi / (2 * _NZ))
    return int(math.floor(2 * math.pi / math.acos(
        1 - a / math.cos(math.radians(lat)) ** 2)))


def cpr_global(lat_even: int, lon_even: int, lat_odd: int, lon_odd: int,
               newest_odd: bool = False) -> tuple[float, float] | None:
    """Globally unambiguous position from an even/odd CPR pair.  Returns
    (lat, lon) in degrees, or None if the pair straddles a zone boundary."""
    ye, yo = lat_even / 2 ** 17, lat_odd / 2 ** 17
    j = math.floor(59 * ye - 60 * yo + 0.5)
    lat_e = 360.0 / 60 * ((j % 60) + ye)
    lat_o = 360.0 / 59 * ((j % 59) + yo)
    if lat_e >= 270:
        lat_e -= 360
    if lat_o >= 270:
        lat_o -= 360
    if _nl(lat_e) != _nl(lat_o):
        return None
    lat = lat_o if newest_odd else lat_e
    nl = _nl(lat)
    xe, xo = lon_even / 2 ** 17, lon_odd / 2 ** 17
    m = math.floor(xe * (nl - 1) - xo * nl + 0.5)
    ni = max(nl - (1 if newest_odd else 0), 1)
    lon = 360.0 / ni * ((m % ni) + (xo if newest_odd else xe))
    if lon >= 180:
        lon -= 360
    return lat, lon


def pair_positions(msgs: list[dict]) -> list[dict]:
    """Walk decoded messages per aircraft, resolving each odd/even CPR pair
    into lat/lon (attached to the newer message as lat_deg/lon_deg)."""
    last: dict[tuple[int, int], dict] = {}
    out = []
    for m in msgs:
        if "cpr_lat" in m:
            key = (m["icao"], 1 - m["cpr_odd"])
            prev = last.get(key)
            if prev is not None:
                even, odd = (prev, m) if m["cpr_odd"] else (m, prev)
                pos = cpr_global(even["cpr_lat"], even["cpr_lon"],
                                 odd["cpr_lat"], odd["cpr_lon"],
                                 newest_odd=bool(m["cpr_odd"]))
                if pos is not None:
                    m = dict(m, lat_deg=pos[0], lon_deg=pos[1])
            last[(m["icao"], m["cpr_odd"])] = m
        out.append(m)
    return out


# ---- test-vector encoder (exact inverse of the decoder) ---------------------

def _u(v: int, n: int) -> list[int]:
    return [(v >> (n - 1 - j)) & 1 for j in range(n)]


def _frame(df: int, icao: int, me_bits: list[int]) -> np.ndarray:
    assert len(me_bits) == 56
    head = _u(df, 5) + _u(5, 3) + _u(icao, 24) + me_bits
    parity = crc24(np.array(head + [0] * 24, np.uint8))
    return np.array(head + _u(parity, 24), np.uint8)


def cpr_encode(lat: float, lon: float, odd: bool) -> tuple[int, int]:
    dlat = 360.0 / (60 - (1 if odd else 0))
    yz = int(math.floor(2 ** 17 * ((lat % dlat) / dlat) + 0.5)) % 2 ** 17
    n = max(_nl(lat) - (1 if odd else 0), 1)
    dlon = 360.0 / n
    xz = int(math.floor(2 ** 17 * ((lon % dlon) / dlon) + 0.5)) % 2 ** 17
    return yz, xz


def make_es_position(icao: int, lat: float, lon: float, alt_ft: int,
                     odd: bool, tc: int = 11) -> np.ndarray:
    n = (alt_ft + 1000) // 25
    alt12 = ((n & 0x7F0) << 1) | 0x10 | (n & 0x0F)
    yz, xz = cpr_encode(lat, lon, odd)
    me = (_u(tc, 5) + _u(0, 3) + _u(alt12, 12) + [0, int(odd)]
          + _u(yz, 17) + _u(xz, 17))
    return _frame(17, icao, me)


def make_es_ident(icao: int, callsign: str) -> np.ndarray:
    cs = f"{callsign:<8}"[:8]
    me = _u(4, 5) + _u(0, 3)
    for c in cs:
        me += _u(_CALLSIGN_CS.index(c), 6)
    return _frame(17, icao, me)


def make_es_velocity(icao: int, vx_kn: float, vy_kn: float,
                     vrate_fpm: int = 0) -> np.ndarray:
    """Subtype-1 ground-speed message; vx = east, vy = north."""
    s_ew, v_ew = (1 if vx_kn < 0 else 0), int(round(abs(vx_kn))) + 1
    s_ns, v_ns = (1 if vy_kn < 0 else 0), int(round(abs(vy_kn))) + 1
    s_vr, vr = (1 if vrate_fpm < 0 else 0), abs(vrate_fpm) // 64 + 1
    me = (_u(19, 5) + _u(1, 3) + [0] * 5 + [s_ew] + _u(v_ew, 10)
          + [s_ns] + _u(v_ns, 10) + [0] + [s_vr] + _u(vr, 9) + [0] * 10)
    return _frame(17, icao, me)


def adsb_modulate(bits: np.ndarray, sample_rate: float,
                  amplitude: float = 1.0) -> np.ndarray:
    """Frame bits → PPM envelope samples (preamble + data), float32."""
    k = int(round(sample_rate / 1e6))
    h = k // 2
    out = np.zeros((8 + len(bits)) * k, np.float32)
    for s in _preamble_pulse_slices(k):
        out[s] = amplitude
    for i, b in enumerate(np.asarray(bits, np.uint8)):
        lo = (8 + i) * k + (0 if b else h)
        out[lo:lo + h] = amplitude
    return out


def to_iq(mag: np.ndarray, phase0: float = 0.7,
          dphi: float = 0.013) -> np.ndarray:
    """Envelope → cf32 with an arbitrary (drifting) carrier phase: the
    receiver is non-coherent, |·| recovers the envelope exactly."""
    n = np.arange(len(mag))
    return (np.asarray(mag) * np.exp(1j * (phase0 + dphi * n))).astype(np.complex64)
