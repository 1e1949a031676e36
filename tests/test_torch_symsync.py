"""The port's symbol sync on the CPU against the JAX package: ``SymSync``
real (kaiser) and complex (rnyquist, rrc; 1 and 2 outputs per symbol) over
state-chained blocks, with clock offsets and the bounded-carry slip, inside
``PerChannel``, ``fm_dem_with_sync``, ``sym_tracker``, JAX state handed over
mid-stream, the design helpers, the rounding semantics the interpolator
relies on, and ``apps/helidecode``.

Tolerances: the SymSync outputs 2e-3 relative to the largest output, the
reference's bound for the same SymSync math in another float order
(tests/test_sharding_generic.py:346), and the carried τ within 1e-3
samples.  Where float order picks the output (``torch_oracles.record_ties`` at
TIE, ~15x the largest position disagreement seen between the two
packages, 7e-4 of a phase step), two right implementations may take the
other pick: the neighbouring bank phase at a rounding other of
round(frac·npfb), or, where the window position sits at an integer, the
window one sample over with the phase wrapped (two samples of time apart:
the reference's bank interpolates at ipos − frac).  There the JAX output
is held to 2e-3 of the port's output of either pick.  Decisions, bits and
coordinates exactly equal."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.apps import helidecode as j_heli
from csdr_tpu.models import modem as j_modem
from csdr_tpu.models import symsync as j_sync
from csdr_tpu.utils import firdes as j_firdes

from csdr_tpu_torch.apps import helidecode
from csdr_tpu_torch.core.block import PerChannel
from csdr_tpu_torch.models import modem, symsync
from csdr_tpu_torch.utils.convert import from_jax_chain_state
from torch_oracles import record_ties

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 2e-3        # tests/test_sharding_generic.py:346
TAU_TOL = 1e-3    # samples
TIE = 0.01        # of a bank phase step


def assert_sync_close(got, other, want, what=""):
    """``want`` within TOL (relative to its largest output) of ``got`` or of
    ``other``, the output of the other pick where float order picks
    (``record_ties``)."""
    got, other, want = np.asarray(got), np.asarray(other), np.asarray(want)
    assert got.shape == other.shape == want.shape, (got.shape, other.shape, want.shape)
    err = np.minimum(np.abs(got - want), np.abs(other - want)) / (np.abs(want).max() + 1e-12)
    assert err.max() < TOL, (what, float(err.max()), int((err >= TOL).sum()))


def chain_blocks(jblk, pblk, x, nblocks, jstate=None, pstate=None):
    """Run both packages' blocks over ``nblocks`` state-chained blocks of
    ``x`` (…, n); returns (JAX outputs, port outputs, the port's outputs of
    the other pick (``record_ties``), JAX states, port states), one per
    block."""
    n = (x.shape[-1] // nblocks // jblk.granule) * jblk.granule
    js = jblk.init() if jstate is None else jstate
    ps = pblk.init(CPU) if pstate is None else pstate
    jys, pys, others, jss, pss = [], [], [], [], []
    for i in range(nblocks):
        seg = np.ascontiguousarray(x[..., i * n:(i + 1) * n])
        js, jy = jblk.apply(js, jnp.asarray(seg))
        with record_ties(TIE) as rec:
            ps, py = pblk.apply(ps, torch.from_numpy(seg))
        assert len(rec) == 1
        jys.append(np.asarray(jy))
        pys.append(py.numpy())
        others.append(rec[0][1])
        jss.append(jax.tree.map(np.asarray, js))
        pss.append(ps)
    return jys, pys, others, jss, pss


def offset_stream(eps, nsym, seed, k=10):
    """Bipolar NRZ at k·(1+eps) samples/symbol (tests/test_symsync_slip.py)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym) * 2 - 1
    dense = np.repeat(bits.astype(np.float64), 8 * k)
    t_rx = np.arange(int(nsym * k / (1 + eps) - 16)) * (1 + eps)
    x = np.interp(t_rx * 8, np.arange(len(dense)), dense)
    x = np.convolve(x, np.hanning(7) / np.hanning(7).sum(), mode="same")
    return x.astype(np.float32)


def fractional_delay(x, d, ntaps=61):
    """Windowed-sinc fractional delay (tests/test_symsync_stereo.py)."""
    t = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(t - (d - int(d))) * np.hamming(ntaps)
    return np.convolve(x, h)[int(d) + (ntaps - 1) // 2:][:len(x)]


def shaped(ms, k, m, beta, nsym, seed, delay=1.7, snr_db=None, gain=0.31, phase=0.3):
    """RRC-shaped symbols with gain, phase, a fractional delay and AWGN
    (tests/test_modem.py:129-153); returns (IQ complex64, tx indices)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym * j_modem.bits_per_symbol(ms))
    syms = j_modem.modulate(bits, ms).astype(np.complex128)
    h = j_firdes.rrc(k, m, beta)
    h = h / np.sqrt(np.sum(h ** 2))
    up = np.zeros(nsym * k, dtype=np.complex128)
    up[::k] = syms
    x = np.convolve(up, h)[: nsym * k] * np.sqrt(k)
    x = fractional_delay(gain * x * np.exp(1j * phase), delay)
    if snr_db is not None:
        n0 = 10 ** (-snr_db / 10.0) * np.mean(np.abs(x) ** 2)
        x = x + np.sqrt(n0 / 2) * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
    idx = np.asarray(j_modem.hard_decision(jnp.asarray(syms.astype(np.complex64)), ms)[0])
    return x.astype(np.complex64), idx


def fsk_iq(k, nsym, seed, delay=0.0):
    """2-FSK with the DeNBFMSync deviation (±0.1 cycles/sample at k = 10),
    delayed by ``delay`` samples."""
    bits = np.random.default_rng(seed).integers(0, 2, nsym)
    iq = np.exp(1j * 2 * np.pi * np.cumsum(np.repeat((bits * 2 - 1) * 0.02 * k * 0.5, k)))
    return fractional_delay(iq, delay).astype(np.complex64) if delay else iq.astype(np.complex64)


# ---- semantics the interpolator and the decisions rely on -------------------

def test_rounding_and_tie_semantics_match_jax():
    """torch.round rounds half to even like jnp.round (the bank phase pick),
    torch.remainder takes the divisor's sign like jnp.mod (the line fit's
    unwrap), and torch.argmax returns the first of tied maxima like
    jnp.argmax (the Viterbi's decisions, hard_decision)."""
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 31.5, 32.5, 0.49999997], np.float32)
    assert np.array_equal(torch.round(torch.from_numpy(v)).numpy(), np.asarray(jnp.round(v)))
    a = np.array([-7.3, -5.0, -0.1, 0.0, 0.1, 4.9, 5.0, 12.7], np.float32)
    for b in (np.float32(5.0), np.float32(-5.0), np.float32(10.0)):
        assert np.array_equal(torch.remainder(torch.from_numpy(a), float(b)).numpy(),
                              np.asarray(jnp.mod(a, b)))
    ties = np.array([[1.0, 3.0, 3.0, 2.0], [0.0, 0.0, 0.0, 0.0], [5.0, 1.0, 5.0, 5.0]],
                    np.float32)
    for axis in (0, 1):
        assert np.array_equal(torch.argmax(torch.from_numpy(ties), dim=axis).numpy(),
                              np.asarray(jnp.argmax(ties, axis=axis)))


@pytest.mark.parametrize("k,m,npfb,ftype,beta", [(10, 4, 64, "kaiser", 0.0),
                                                 (4, 3, 32, "rnyquist", 0.5),
                                                 (4, 3, 32, "rrc", 0.25)])
def test_design_helpers_equal_jax(k, m, npfb, ftype, beta):
    assert np.array_equal(symsync._interp_bank(k, m, npfb, ftype, beta),
                          j_sync._interp_bank(k, m, npfb, ftype, beta))
    assert np.array_equal(symsync._timing_rotator(k, 1000), j_sync._timing_rotator(k, 1000))
    ts = np.linspace(-3.0, 3.0, 97)
    assert np.array_equal(symsync._rrc_continuous(ts, beta or 0.35),
                          j_sync._rrc_continuous(ts, beta or 0.35))


# ---- SymSync against the JAX package ------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 2e-4, -2e-4])
def test_sym_sync_r_matches_jax(eps):
    """symSyncR over three state-chained blocks, at 0 and ±200 ppm of clock
    offset (tests/test_symsync_stereo.py:105-128)."""
    x = offset_stream(eps, 4000, 9)
    jys, pys, others, jss, pss = chain_blocks(j_sync.sym_sync_r(10, 4, 0.0, 64),
                                            symsync.sym_sync_r(10, 4, 0.0, 64), x, 3)
    for i, (jy, py, other, js, ps) in enumerate(zip(jys, pys, others, jss, pss)):
        assert_sync_close(py, other, jy, f"block {i}")
        assert abs(float(ps[1]) - float(js[1])) < TAU_TOL, (i, float(ps[1]), float(js[1]))
        assert bool(ps[2]) and bool(js[2])
        assert np.array_equal(ps[0].numpy(), js[0])


def test_sym_sync_r_bounded_carry_matches_jax():
    """500 ppm far past the slack: the carried τ slips by whole symbols at
    the same blocks in both packages (tests/test_symsync_slip.py:78-114)."""
    x = offset_stream(5e-4, 16000, 17)
    jys, pys, others, jss, pss = chain_blocks(j_sync.sym_sync_r(10, 4, 0.0, 64),
                                            symsync.sym_sync_r(10, 4, 0.0, 64), x, 8)
    taus_j = [float(s[1]) for s in jss]
    taus_p = [float(s[1]) for s in pss]
    assert max(abs(t) for t in taus_p) <= 5 * 10 + 10, taus_p
    assert np.max(np.abs(np.subtract(taus_p, taus_j))) < TAU_TOL, (taus_p, taus_j)
    assert len({round(t / 10) for t in taus_j}) > 1  # the carry did slip
    for i, (jy, py, other) in enumerate(zip(jys, pys, others)):
        assert_sync_close(py, other, jy, f"block {i}")


@pytest.mark.parametrize("ftype,beta,ops", [("rnyquist", 0.5, 2), ("rrc", 0.25, 1),
                                            ("rrc", 0.25, 2)])
def test_sym_sync_c_matches_jax(ftype, beta, ops):
    """Complex SymSync (symSyncC's rnyquist bank at 2 outputs/symbol, the
    tracker's RRC at 1 and 2) on RRC-shaped QPSK with a fractional delay,
    three state-chained blocks."""
    x, _ = shaped("qpsk", 4, 3, 0.5, 3000, 1, snr_db=30.0)
    mk = lambda mod: mod.SymSync(4, 3, beta, 32, complex_input=True, ftype=ftype,  # noqa: E731
                                 out_per_sym=ops)
    jys, pys, others, jss, pss = chain_blocks(mk(j_sync), mk(symsync), x, 3)
    for i, (jy, py, other, js, ps) in enumerate(zip(jys, pys, others, jss, pss)):
        assert py.dtype == np.complex64
        assert_sync_close(py, other, jy, f"block {i}")
        assert abs(float(ps[1]) - float(js[1])) < TAU_TOL


def test_per_channel_sym_sync_matches_jax_vmap():
    """PerChannel over 4 channels, each with its own timing phase and clock
    offset: the port's one (4, n) panel with a line fit per row against the
    JAX package's vmap."""
    rows = [offset_stream(eps, 3000, 20 + c)[:28000] for c, eps in
            enumerate([0.0, 1e-4, -1e-4, 2e-4])]
    x = np.stack([fractional_delay(r, d).astype(np.float32)
                  for r, d in zip(rows, [0.0, 2.3, 4.9, 7.4])])
    jys, pys, others, jss, pss = chain_blocks(
        cs.PerChannel(j_sync.sym_sync_r(10, 4, 0.0, 64), 4),
        PerChannel(symsync.sym_sync_r(10, 4, 0.0, 64), 4), x, 3)
    for i, (jy, py, other, js, ps) in enumerate(zip(jys, pys, others, jss, pss)):
        assert py.shape == (4, x.shape[1] // 3 // 10 * 2)
        for c in range(4):
            assert_sync_close(py[c], other[c], jy[c], f"block {i} channel {c}")
        assert np.max(np.abs(ps[1].numpy() - js[1])) < TAU_TOL
        assert len(set(np.round(ps[1].numpy(), 2))) == 4  # a timing line per row


def test_fm_dem_with_sync_matches_jax():
    """The DeNBFMSync graph (tests/test_symsync_stereo.py:78-102) on a
    delayed 2-FSK capture, three blocks, and its decisions."""
    iq = fsk_iq(10, 3000, 2, delay=3.3)
    jys, pys, others, _, pss = chain_blocks(j_sync.fm_dem_with_sync(10),
                                          symsync.fm_dem_with_sync(10), iq, 3)
    for i, (jy, py, other) in enumerate(zip(jys, pys, others)):
        assert_sync_close(py, other, jy, f"block {i}")
        assert np.array_equal(np.sign(py[0::2]), np.sign(jy[0::2]))
    assert isinstance(pss[-1][0], torch.Tensor) and pss[-1][0].dtype == torch.complex64


@pytest.mark.parametrize("ms,snr_db", [("bpsk", 20.0), ("qpsk", 20.0), ("qam16", 26.0)])
def test_sym_tracker_matches_jax(ms, snr_db):
    """AGC → RRC sync → power normalize → carrier → LMS equalizer
    (tests/test_modem.py:129-153): decisions equal, symbols within 2e-3."""
    x, _ = shaped(ms, 4, 3, 0.25, 3072, 3, snr_db=snr_db)
    jys, pys, _, _, _ = chain_blocks(j_sync.sym_tracker(3, 4, ms=ms),
                                     symsync.sym_tracker(3, 4, ms=ms), x, 2)
    jy, py = np.concatenate(jys), np.concatenate(pys)
    err = np.abs(py - jy).max() / np.abs(jy).max()
    assert err < TOL, err
    jd = np.asarray(j_modem.hard_decision(jnp.asarray(jy), ms)[0])
    pd = modem.hard_decision(torch.from_numpy(py), ms)[0].numpy()
    assert np.array_equal(pd, jd)


def test_jax_state_hands_over_mid_stream():
    """Two blocks in JAX, then the third in the port from the JAX state
    (``from_jax_chain_state``): PerChannel(fm_dem_with_sync) with its
    (hist, tau, valid bool) leaves stacked per channel, and the tracker's
    AGC, sync, power, phase and (w, hist) states."""
    rows = np.stack([fsk_iq(10, 2000, 40 + c, delay=1.5 * c) for c in range(4)])
    jg = cs.PerChannel(j_sync.fm_dem_with_sync(10), 4)
    pg = PerChannel(symsync.fm_dem_with_sync(10), 4)
    jys, _, _, jss, _ = chain_blocks(jg, pg, rows, 3)
    st = from_jax_chain_state(jax.tree.map(np.asarray, jss[1]), CPU)
    assert st[1][2].dtype == torch.bool and st[1][1].shape == (4,)
    n = rows.shape[1] // 3 // 10 * 10
    with record_ties(TIE) as rec:
        _, py = pg.apply(st, torch.from_numpy(np.ascontiguousarray(rows[:, 2 * n:3 * n])))
    for c in range(4):
        assert_sync_close(py.numpy()[c], rec[0][1][c], jys[2][c], f"channel {c}")

    x, _ = shaped("qpsk", 4, 3, 0.25, 3000, 5, snr_db=25.0)
    jt, pt = j_sync.sym_tracker(3, 4, ms="qpsk"), symsync.sym_tracker(3, 4, ms="qpsk")
    jys, _, _, jss, _ = chain_blocks(jt, pt, x, 3)
    n = len(x) // 3 // 4 * 4
    _, py = pt.apply(from_jax_chain_state(jss[1], CPU), torch.from_numpy(x[2 * n:3 * n]))
    assert np.abs(py.numpy() - jys[2]).max() / np.abs(jys[2]).max() < TOL


@pytest.mark.parametrize("make", [lambda mode: symsync.sym_sync_r(10, mode=mode),
                                  lambda mode: symsync.sym_sync_c(3, 4, mode=mode)])
def test_scan_mode_is_not_ported(make):
    """mode="scan" builds the ported ``SymSyncScan`` (tests/test_torch_scan.py
    holds it to the JAX package); a mode other than "block" or "scan"
    raises, where the JAX package takes it as "block"."""
    assert isinstance(make("scan"), symsync.SymSyncScan)
    with pytest.raises(ValueError, match="use one of"):
        make("closed_loop")


# ---- the K9 wrapper's routes and refusals ------------------------------------

def test_cpu_tensor_takes_the_plain_route_without_a_launch():
    """A CPU block goes through ``symsync_block_ref`` (the eager ops): no
    kernel launch, the output's shape, and the route's output equal to the
    plain version's called directly."""
    from csdr_tpu_torch.ops.cuda import symsync_block as k9

    blk = PerChannel(symsync.sym_sync_r(10, 4, 0.0, 64), 4)
    x = torch.from_numpy(np.stack([offset_stream(0.0, 700, s) for s in range(4)])[:, :6400])
    before = k9.launches
    st, y = blk.apply(blk.init(CPU), x)
    st, y = blk.apply(st, x)
    assert k9.launches == before
    assert y.shape == (4, 6400 // 10 * 2)
    sync = blk.inner
    _, y_ref = k9.symsync_block_ref(x, sync._bank(CPU), symsync._rotator_on(10, 6400, CPU), st,
                                    sync.constants)
    _, y_route = blk.apply(st, x)
    assert torch.equal(y_ref, y_route)


@pytest.mark.parametrize("case,match", [
    ("dtype", "must be float32 or complex64"),
    ("history_dtype", "must be float32 or complex64"),
    ("taps", "at most 1024 taps"),
    ("short_row", r"rows of 12 samples are shorter than the 81-tap window"),
    ("rows", "must have the same rows"),
    ("rotator", r"the rotator must be complex64 \(640,\)"),
    ("bank", r"the bank must be float32 \(npfb, W\)"),
])
def test_symsync_block_refuses_what_the_kernel_does_not_take(case, match):
    """The wrapper's checks, on either device: x of another dtype than
    float32 / complex64 or than its history, a window above MAX_TAPS, rows
    [hist | x] shorter than the window, history rows that do not match, a
    rotator that is not x's length (both routes rotate by the caller's
    tensor) and a bank that is not float32."""
    from csdr_tpu_torch.ops.cuda import symsync_block as k9

    sync = symsync.sym_sync_r(10, 4, 0.0, 64)
    hist, tau, valid = sync.init(CPU)
    x = torch.zeros(640)
    if case == "dtype":
        x = x.double()
    elif case == "history_dtype":
        hist = hist.to(torch.complex64)
    elif case == "taps":
        sync = symsync.sym_sync_r(128, 4, 0.0, 64)          # W = 1,025
        hist, tau, valid = sync.init(CPU)
        x = torch.zeros(1280)
    elif case == "short_row":
        hist, x = hist[:2], torch.zeros(10)
    elif case == "rows":
        x = torch.zeros(3, 640)
    else:
        bank, rot = sync._bank(CPU), symsync._rotator_on(10, 640, CPU)
        if case == "rotator":
            rot = rot[:-10]
        else:
            bank = bank.double()
        with pytest.raises(ValueError, match=match):
            k9.symsync_block(x, bank, rot, (hist, tau, valid), sync.constants)
        return
    with pytest.raises(ValueError, match=match):
        sync.apply((hist, tau, valid), x)


# ---- helidecode -------------------------------------------------------------

def heli_levels(k=10, reps=10, seed=None):
    """The helicopter frame layout of tests/test_cli_apps.py:345-352 as ±1
    symbol levels (bit '0' → +1)."""
    text = "AN 52 3045\r\nBW 21 0030\r\n"
    payload = (b"\xff\xff" + (text * 3).encode())[:71]
    frame = "".join("".join("1" if (b >> j) & 1 else "0" for j in range(8)) + "11"
                    for b in payload)
    sync = "1100000000" + "0100000000"
    bits = (sync + frame) * reps + sync
    return np.array([+1.0 if c == "0" else -1.0 for c in bits])


def coords_tuple(cs_):
    return [(c.lat_deg, c.lat_min, c.lat_sec, c.lon_deg, c.lon_min, c.lon_sec) for c in cs_]


def test_helidecode_functions_match_jax(tmp_path):
    """bits_from_samples, frames_from_bits, decode_frame, parse_coords,
    clean_coords, to_kml, to_octave and decode_file on the same samples,
    with a glitched coordinate and noise between frames."""
    lv = heli_levels(reps=6)
    rng = np.random.default_rng(7)
    samples = np.repeat(lv, 2).astype(np.float32) * np.float32(0.5)
    samples = np.concatenate([rng.normal(size=300).astype(np.float32), samples])
    bits = helidecode.bits_from_samples(samples)
    assert bits == j_heli.bits_from_samples(samples)
    frames = helidecode.frames_from_bits(bits)
    assert frames == j_heli.frames_from_bits(bits) and len(frames) == 6
    for fr in frames:
        assert helidecode.decode_frame(fr) == j_heli.decode_frame(fr)
    text = ("AN 52 3045\r\nBW 21 0030\r\nAN 52 3046\r\nBW 21 0030\r\n"
            "AN 53 3046\r\nBW 21 0030\r\nAN -1 0512\r\nBW 0 0000\r\nAN 52 3046\r\n")
    assert coords_tuple(helidecode.parse_coords(text)) == coords_tuple(j_heli.parse_coords(text))
    assert coords_tuple(helidecode.clean_coords(helidecode.parse_coords(text))) == \
        coords_tuple(j_heli.clean_coords(j_heli.parse_coords(text)))
    path = str(tmp_path / "s.f32")
    samples.tofile(path)
    out = {}
    for name, mod in (("p", helidecode), ("j", j_heli)):
        kml, m = str(tmp_path / f"{name}.kml"), str(tmp_path / f"{name}.m")
        out[name] = coords_tuple(mod.decode_file(path, kml, m))
        out[name + "_files"] = (open(kml).read(), open(m).read().replace(f"{name}.png", ""))
    assert out["p"] == out["j"] and len(out["p"]) >= 10
    assert out["p_files"] == out["j_files"]


def test_helidecode_main_writes_kml(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    np.repeat(heli_levels(reps=4), 2).astype(np.float32).tofile("h.f32")
    assert helidecode.main([]) == 1
    assert helidecode.main(["h.f32"]) == 0
    assert "coordinates -> output.kml" in capsys.readouterr().out
    assert os.path.getsize("output.kml") > 0 and os.path.getsize("output.m") > 0
