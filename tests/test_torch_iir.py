"""The port's IIR family against the JAX package and scipy: the prototype
designs and their one-pole decomposition (exactly equal), the streaming
cascade (real and complex, three blocks), the cascade against
``scipy.signal.sosfilt``/``lfilter``, ``PerChannel`` panels and the WBFM
demodulator and receiver.

Tolerances: 1e-4 relative to the largest output against the JAX cascade
(both run the same float32 blocked recurrence; the matmul summation order
differs); 5e-3 against scipy's float64 filters (tests/test_iir_ops.py:32);
2e-5 for the WBFM chain, the golden tolerance (tests/test_golden.py)."""

import numpy as np
import pytest
import scipy.signal as sig
import torch

import jax.numpy as jnp

import csdr_tpu as cs
from csdr_tpu.ops import iir as jiir
from csdr_tpu.utils import iirdes as jdes
from csdr_tpu.models import receivers as jrx

import csdr_tpu_torch as ct
from csdr_tpu_torch import blocks as TB
from csdr_tpu_torch.ops import iir as tiir
from csdr_tpu_torch.utils import iirdes as tdes
from csdr_tpu_torch.utils.convert import from_jax_chain_state

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _rel(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


@pytest.mark.parametrize("ftype", tdes.IIR_PROTOTYPES)
@pytest.mark.parametrize("f0", [0.0, 0.15])
def test_designs_equal_jax(ftype, f0):
    """prototype_sos and sos_to_onepole, low-pass and band-pass, orders 1–5:
    the same float64 arrays as the JAX package's."""
    assert tdes.IIR_PROTOTYPES == jdes.IIR_PROTOTYPES
    for order in range(1, 6):
        args = (ftype, order, 0.05, f0, 1.0, 40.0)
        sos = tdes.prototype_sos(*args)
        assert np.array_equal(sos, jdes.prototype_sos(*args))
        for real_io in (True, False):
            got, want = tdes.sos_to_onepole(sos, real_io), jdes.sos_to_onepole(sos, real_io)
            for field in ("poles", "residues", "fir"):
                assert np.array_equal(getattr(got, field), getattr(want, field)), field
            assert got.real_io == want.real_io
    assert np.array_equal(tdes.butter_sos(2, 0.025), jdes.butter_sos(2, 0.025))


def test_design_errors():
    with pytest.raises(ValueError, match="unknown IIR prototype"):
        tdes.prototype_sos("elliptic", 4, 0.1)
    with pytest.raises(ValueError, match="bandpass edges"):
        tdes.prototype_sos("butter", 4, 0.2, f0=0.4)
    with pytest.raises(ValueError):
        tdes.butter_sos(2, 0.7)


def _signal(n, cplx, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0)
    return x.astype(np.complex64 if cplx else np.float32)


# (ftype, order, fc, f0): the WBFM de-emphasis, an odd-order band-pass (a
# section of two distinct real poles on real input), a first-order section
# (one real pole), an elliptic low-pass (conjugate pairs)
CASCADES = [("butter", 2, 0.025, 0.0), ("butter", 3, 0.03, 0.12), ("butter", 1, 0.1, 0.0),
            ("ellip", 4, 0.1, 0.0), ("cheby2", 3, 0.03, 0.12)]


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("ftype,order,fc,f0", CASCADES)
def test_cascade_matches_jax_over_three_blocks(ftype, order, fc, f0, cplx):
    sos = jdes.prototype_sos(ftype, order, fc, f0, 1.0, 40.0)
    jc, tc = jdes.sos_to_onepole(sos, not cplx), tdes.sos_to_onepole(sos, not cplx)
    js, ts = jiir.onepole_cascade_init(jc, cplx), tiir.onepole_cascade_init(tc, cplx, CPU)
    for blk in np.split(_signal(3 * 2048, cplx, 1), 3):
        js, jy = jiir.onepole_cascade_stream(jc, js, jnp.asarray(blk))
        ts, ty = tiir.onepole_cascade_stream(tc, ts, torch.from_numpy(blk))
        assert ty.dtype == (torch.complex64 if cplx else torch.float32)
        assert _rel(ty, jy) < 1e-4
    for (jh, jcar), (th, tcar) in zip(js, ts):
        assert _rel(th, jh) < 1e-4 and _rel(tcar, jcar) < 1e-4


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("ftype,order,fc,f0", CASCADES)
def test_cascade_matches_scipy(ftype, order, fc, f0, cplx):
    sos = tdes.prototype_sos(ftype, order, fc, f0, 1.0, 40.0)
    casc = tdes.sos_to_onepole(sos, not cplx)
    x = _signal(8192, cplx, 2)
    st = tiir.onepole_cascade_init(casc, cplx, CPU)
    outs = []
    for blk in np.split(x, 4):
        st, y = tiir.onepole_cascade_stream(casc, st, torch.from_numpy(blk))
        outs.append(y.numpy())
    b, a = sig.sos2tf(sos)
    want = sig.lfilter(b, a, x.astype(np.complex128 if cplx else np.float64))
    assert _rel(np.concatenate(outs), want) < 5e-3
    assert _rel(np.concatenate(outs), sig.sosfilt(sos, x.astype(want.dtype))) < 5e-3


def test_complex_typed_real_pole_bandpass():
    """tests/test_iir_prototypes.py:108-124: a wide first-order band-pass
    gives a section of two distinct real poles, handed over as complex
    scalars with zero imaginary part, on complex input."""
    blk = ct.iir_cfilter(1, 0.1, f0=0.15)
    x = _signal(8192, True, 0)
    _, y = blk.apply(blk.init(CPU), torch.from_numpy(x))
    ref = sig.sosfilt(tdes.prototype_sos("butter", 1, 0.1, f0=0.15), x.astype(np.complex128))
    assert _rel(y, ref) < 1e-3
    jb = cs.iir_cfilter(1, 0.1, f0=0.15)
    _, jy = jb.apply(jb.init(), jnp.asarray(x))
    assert _rel(y, jy) < 1e-4


@pytest.mark.parametrize("cplx", [False, True])
def test_per_channel_panel_equals_single_rows(cplx):
    """PerChannel(iir_filter) on a (4, n) panel equals four single-row
    runs, over two blocks with the state carried."""
    make = (lambda: ct.iir_cfilter(3, 0.05, f0=0.2, ftype="cheby1", ap=1.0)) if cplx else (
        lambda: ct.iir_filter(2, 0.02))
    x = np.stack([_signal(2 * 1024, cplx, 10 + r) for r in range(4)])
    g = ct.PerChannel(make(), 4)
    st = g.init(CPU)
    rows = [make() for _ in range(4)]
    rs = [b.init(CPU) for b in rows]
    for blk in np.split(x, 2, axis=1):
        st, y = g.apply(st, torch.from_numpy(np.ascontiguousarray(blk)))
        assert y.shape == blk.shape
        for r in range(4):
            rs[r], yr = rows[r].apply(rs[r], torch.from_numpy(np.ascontiguousarray(blk[r])))
            assert _rel(y[r], yr) < 1e-6


def test_wbfm_demodulator_state_from_jax_mid_stream():
    """wbfm_demodulator: JAX runs two blocks, hands its state (FM demod's
    sample, the de-emphasis cascade, the decimator's hist) to the port,
    which continues as JAX does; the first blocks agree too."""
    t = np.arange(4 * 4096)
    x = np.exp(1j * 2 * np.pi * np.cumsum(0.05 * np.sin(2 * np.pi * 0.002 * t))).astype(
        np.complex64)
    jg, tg = cs.wbfm_demodulator(200000.0, 4), ct.wbfm_demodulator(200000.0, 4)
    js, ts = jg.init(), tg.init(CPU)
    blocks = np.split(x, 4)
    for blk in blocks[:2]:
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        assert _rel(ty, jy) < 2e-5
    import jax
    ts = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
    for blk in blocks[2:]:
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        assert ty.shape == (1024,) and _rel(ty, jy) < 2e-5


def test_wbfm_receiver_matches_jax():
    """The DeWBFM flow's graph with a front end (-b 200000 from 400 kHz)
    and the AGC, against the JAX receiver over three blocks."""
    t = np.arange(3 * 8000)
    x = (0.5 * np.exp(1j * 2 * np.pi * np.cumsum(0.04 * np.sin(2 * np.pi * 0.001 * t)))
         ).astype(np.complex64)
    jg = jrx.wbfm_receiver(400000.0, 200000.0, 4, agc_threshold_db=-60.0)
    tg = ct.wbfm_receiver(400000.0, 200000.0, 4, agc_threshold_db=-60.0)
    js, ts = jg.init(), tg.init(CPU)
    for blk in np.split(x, 3):
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        assert ty.shape == (1000,) and _rel(ty, jy) < 2e-5


def test_iir_block_names_and_rates():
    b = TB.IIRFilter(3, 0.05, complex_input=False, ftype="ellip", f0=0.2)
    assert b.name == cs.blocks.IIRFilter(3, 0.05, complex_input=False, ftype="ellip",
                                         f0=0.2).name
    assert b.rate == 1 and b.granule == 1
    assert ct.wbfm_demodulator(200000.0, 8).rate == cs.wbfm_demodulator(200000.0, 8).rate
