"""Oracles shared by the port's tests and its card scripts.

The tier-1 tests (``tests/test_torch_*.py``) and the scripts that check
and time the port on a CUDA card (``chip_smoke.py``, ``chip_compare.py``)
hold the symbol sync, its scan mode and the beacon to the same rules and
feed them the same seeded signals; this module keeps those in one place.
It is not a test file (pytest collects ``test_*.py`` only) and imports
neither JAX nor the JAX package: numpy at import, torch and
``csdr_tpu_torch`` inside the functions that need them.  pytest puts
``tests/`` on ``sys.path`` (``from torch_oracles import ...``); the card
scripts add it themselves.

  * the symbol sync in another float order: ``record_ties`` (around the
    reference run, the output of the other pick where float order picks)
    and ``other_pick``, held to SYNC_TOL;
  * its scan mode (``SymSyncScan``): ``scan_ties``, ``scan_agree``,
    ``scan_ok``;
  * test signals: ``sync_rows`` (the JAX package's own sync test rows),
    the helicopter frames (``heli_text``, ``heli_levels``, ``heli_coord``,
    ``heli_decode``) and ``beacon_set`` (the beacons the CRC refuses in
    both packages: BEACON_REFUSED).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

SEED = 20261016
# the sync against another float order: 2e-3 relative to the largest output
# (tests/test_sharding_generic.py:346) of the reference's output or, where
# float order picks (record_ties: a phase-rounding tie, or a window position
# at an integer), of its output of the other pick
SYNC_TOL, SYNC_TIE = 2e-3, 0.01
SCAN_SETTLE = 20               # symbols: SymSyncScan's loop time constant, 1/lf_bw
BEACONS, BEACON_SNR_DB = 32, -13.0   # tests/test_beacon.py:31-45
BEACON_REFUSED = [19]          # the CRC refuses this one in both packages (the mode's limit)


def other_pick(sync, bank, xfull, nout: int, tm, slope, cm, width: float):
    """Where float order picks a SymSync output, the output of the other
    pick: (codes int8, other outputs) as numpy (…, nout), for the step with
    constants ``sync`` (``BlockSync``) and ``bank`` that interpolated
    ``nout`` outputs of ``xfull`` on the line (tm, slope, cm).

      * code 1: round(frac·npfb) lies within ``width`` of a rounding tie;
        the other pick is the neighbouring bank phase;
      * code 2: the window position lies within width/npfb of an integer;
        the other pick is the window one sample over with the phase wrapped
        (0 ↔ npfb − 1).  Bank row p interpolates at ipos − p/npfb (the JAX
        package's bank), so the two picks are two samples of time apart;
      * code 0: no other pick (the output itself)."""
    import torch

    from csdr_tpu_torch.ops.cuda import symsync_block as k9

    npfb = bank.shape[0]
    ipos, ph, f = k9.positions(sync, npfb, nout, tm, slope, cm)
    ipos, ph, f = (v.expand(*xfull.shape[:-1], nout) for v in (ipos, ph, f))
    lo, hi = f < width, f > npfb - width
    tie = (torch.abs(f - torch.floor(f) - 0.5) < width) & ~lo & ~hi
    ph_tie = torch.where(ph == torch.floor(f).to(torch.int64), ph + 1, ph - 1)
    ipos_alt = ipos - lo.to(torch.int64) + hi.to(torch.int64)
    ph_alt = torch.where(lo, npfb - 1, torch.where(hi, 0, torch.where(
        tie, ph_tie.clamp(0, npfb - 1), ph)))
    code = torch.where(lo | hi, 2, tie.to(torch.int64)).to(torch.int8)
    return code.cpu().numpy(), k9.bank_sum(xfull, ipos_alt, ph_alt, bank,
                                           sync.m * sync.k).cpu().numpy()


@contextlib.contextmanager
def record_ties(width: float = SYNC_TIE):
    """For holding two implementations of the symbol sync against each
    other: inside the block every ``SymSync`` step of the port appends
    ``other_pick``'s (codes, other outputs) for its outputs to the yielded
    list, on the line the step interpolated on (K9's own on a card).  It
    wraps ``ops/cuda/symsync_block.symsync_block`` for the block's
    duration."""
    import torch

    from csdr_tpu_torch.ops.cuda import symsync_block as k9

    log: list = []
    route = k9.symsync_block

    def recording(x, bank, rot, state, sync):
        fit: list = []
        out = route(x, bank, rot, state, sync, fit)
        n = x.shape[-1]
        log.append(other_pick(sync, bank, torch.cat([state[0], x], dim=-1),
                              (n // sync.k) * sync.out_per_sym, *fit[0], width))
        return out

    k9.symsync_block = recording
    try:
        yield log
    finally:
        k9.symsync_block = route


def scan_ties(taus, loop, npfb: int, width: float = SYNC_TIE) -> np.ndarray:
    """Outputs of a ``SymSyncScan`` run (its twin's per-output τ, ``trace``)
    whose window start or bank row lies within ``width`` bank steps of a
    rounding boundary: where τ ± width/npfb samples gives another (floor of
    the position, bank row) than τ, in the kernel's float32 order.  There
    two right implementations in another float order may pick apart, and
    the pick feeds back through the loop.  An output at the initial τ = 0
    (before the loop first moves τ) is no tie: every run holds exactly 0
    there.  Bool (…, nout) as numpy."""
    import torch

    from csdr_tpu_torch.ops.cuda.symsync_scan import picks

    j = torch.arange(taus.shape[-1], dtype=torch.float32, device=taus.device)
    d = np.float32(width / npfb)
    at = picks(taus, j, loop, npfb)
    tie = torch.zeros(taus.shape, dtype=torch.bool, device=taus.device)
    for t in (taus - d, taus + d):
        other = picks(t, j, loop, npfb)
        tie |= (other[0] != at[0]) | (other[1] != at[1])
    return (tie & (taus != 0)).cpu().numpy()


def scan_agree(got: np.ndarray, want: np.ndarray, ties: np.ndarray, block: int = 0) -> dict:
    """A ``SymSyncScan`` output (…, nout) against the reference run ``want``
    with its ``scan_ties``: within SYNC_TOL of the largest output up to each
    row's first tie; after it the two runs must decode the same symbols:
    the signs of their centre samples (even outputs, real parts) equal,
    block by block (``block`` outputs each; 0: one block) under one
    whole-symbol shift per block, 0 in the block of the first tie, changing
    by at most one symbol at each later block's start: there τ's wrap by
    ±k moves one run's output grid by a symbol when the parted runs sit on
    either side of ±k/2.  The grid moves by k samples, not by the runs'
    τ difference, so after a change of shift the first SCAN_SETTLE centres
    (the loop's time constant, 1/lf_bw symbols) sample other points of the
    eye and are not compared.  Returns {"max_err": the
    worst error before the first tie, "first_tie": the earliest first tie,
    "sign_mismatches": centre samples after it whose signs differ under
    their block's best shift, "centres_after": how many were compared,
    "shifts": the nonzero shifts (row, block, symbols), "max_err_all": the
    worst error anywhere, "outputs"}."""
    got, want, ties = (np.atleast_2d(v) for v in (got, want, ties))
    n = got.shape[-1]
    block = block or n
    out = dict(max_err=0.0, first_tie=n, sign_mismatches=0, centres_after=0, shifts=[],
               max_err_all=0.0, outputs=int(got.size))
    rows = zip(got.reshape(-1, n), want.reshape(-1, n), ties.reshape(-1, n))
    for r, (g, w, t) in enumerate(rows):
        err = np.abs(g.astype(np.complex128) - w) / (np.abs(w).max() + 1e-12)
        first = int(np.argmax(t)) if t.any() else n
        out["max_err"] = max(out["max_err"], float(err[:first].max(initial=0.0)))
        out["max_err_all"] = max(out["max_err_all"], float(err.max()))
        out["first_tie"] = min(out["first_tie"], first)
        prev = None
        for b0 in range(first - first % block, n, block):
            c0 = max(b0, first + first % 2)
            sg = np.sign(g[c0:b0 + block:2].real)
            sw = np.sign(w[b0:b0 + block:2].real)
            i0 = (c0 - b0) // 2
            best = None
            # none in the block of the first tie; then ±1 at each block's end,
            # past which the first SCAN_SETTLE centres are not compared
            for shift in ([0] if prev is None else (prev - 1, prev, prev + 1)):
                skip = SCAN_SETTLE if prev is not None and shift != prev else 0
                lo, hi = max(0, i0 + shift + skip), min(len(sw), i0 + len(sg) + shift)
                if hi - lo < len(sg) - skip - 3:
                    continue
                bad = int((sg[lo - i0 - shift:hi - i0 - shift] != sw[lo:hi]).sum())
                if best is None or bad < best[0]:
                    best = (bad, shift, hi - lo)
            out["sign_mismatches"] += best[0]
            out["centres_after"] += best[2]
            prev = best[1]
            if prev:
                out["shifts"].append((r, b0 // block, prev))
    return out


def scan_ok(agree: dict) -> bool:
    return agree["max_err"] < SYNC_TOL and agree["sign_mismatches"] == 0


def sync_rows(rows: int, n: int, k: int, seed: int, cplx: bool) -> np.ndarray:
    """Rows of the JAX package's own symbol-sync test signals
    (tests/test_symsync_stereo.py:33-61), each with its own bits, timing
    phase and symbol clock within ±100 ppm (read off a k-samples/symbol
    grid by linear interpolation): real, NRZ smoothed by a 7-tap Hann
    window (float32); complex, RRC (β 0.5, m 3) BPSK (complex64)."""
    from csdr_tpu_torch.utils import firdes

    rng = np.random.default_rng(seed)
    out = np.empty((rows, n), np.complex64 if cplx else np.float32)
    for r in range(rows):
        eps, d0 = rng.uniform(-1e-4, 1e-4), rng.uniform(0, k)
        nsym = int(n * (1 + 2e-4) / k) + 8
        bits = rng.integers(0, 2, nsym) * 2.0 - 1.0
        if cplx:
            up = np.zeros(nsym * k)
            up[::k] = bits
            xs = np.convolve(up, firdes.rrc(k, 3, 0.5))[:nsym * k] * np.sqrt(k)
        else:
            xs = np.convolve(np.repeat(bits, k), np.hanning(7) / np.hanning(7).sum(), "same")
        t = (np.arange(n) + d0) * (1 + eps)
        out[r] = np.interp(t, np.arange(len(xs)), xs)
    return out


def heli_text(ch: int) -> str:
    """Channel ch's two coordinate records (two-digit degrees, mmss)."""
    return (f"AN {40 + ch % 50:02d} {10 + ch % 49:02d}{13 * ch % 100:02d}\r\n"
            f"BW {10 + ch % 80:02d} {20 + ch % 39:02d}{7 * ch % 100:02d}\r\n")


def heli_levels(text: str, nsym: int) -> np.ndarray:
    """The helicopter frame layout (tests/test_cli_apps.py:345-352), 710-bit
    frames of 71 10-bit characters between 20-bit syncs, as ±1 symbol levels
    (bit '0' → +1), repeated to at least nsym symbols."""
    payload = (b"\xff\xff" + (text * 3).encode())[:71]
    frame = "".join("".join("1" if (b >> j) & 1 else "0" for j in range(8)) + "11"
                    for b in payload)
    unit = "1100000000" + "0100000000" + frame
    bits = unit * (nsym // len(unit) + 2)
    return np.where(np.frombuffer(bits.encode(), np.uint8) == ord("0"), 1.0, -1.0)


def heli_coord(text: str) -> tuple:
    """The (lat deg, min, sec, lon deg, min, sec) helidecode parses from a
    record pair."""
    a, b = text.split("\r\n")[:2]
    _, ad, am = a.split()
    _, bd, bm = b.split()
    return (float(int(ad)), float(int(am[:2])), int(am[2:]) / 100.0 * 60.0,
            float(int(bd)), float(int(bm[:2])), int(bm[2:]) / 100.0 * 60.0)


def heli_decode(path: str) -> list:
    """helidecode's coordinates of one .f32 file, as tuples."""
    from csdr_tpu_torch.apps import helidecode

    base = path[:-4]
    cs = helidecode.decode_file(path, base + ".kml", base + ".m")
    for ext in (".kml", ".m"):
        os.unlink(base + ext)
    return [(c.lat_deg, c.lat_min, c.lat_sec, c.lon_deg, c.lon_min, c.lon_sec) for c in cs]


def beacon_set():
    """BEACONS coded beacons of random messages at BEACON_SNR_DB in the full
    baseband bandwidth (tests/test_beacon.py:31-45): [(message, IQ)]."""
    from csdr_tpu_torch.models import beacon

    rng = np.random.default_rng(SEED + 1200)
    sigma = np.sqrt(10.0 ** (-BEACON_SNR_DB / 10.0) / 2.0)
    out = []
    for _ in range(BEACONS):
        m = rng.integers(0, 2, beacon.MESSAGE_BITS)
        x = beacon.beacon_modulate(m, spsym=64)
        out.append((m, (x + sigma * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x))))
                    .astype(np.complex64)))
    return out
