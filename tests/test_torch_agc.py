"""The port's AGC with squelch, its batched linear recurrence and the
channelized AGC flow against the JAX package, on numpy-seeded inputs.

Tolerances, each with its source:
  * linrec vs its sequential float64 oracle: 2e-5 max-rel
    (tests/test_golden.py, as tests/test_torch_ops.py);
  * AGC output vs JAX: rtol 1e-4, atol 1e-5 (tests/test_nco_demod_agc.py:131),
    and squelched samples exactly zero in both (:118);
  * the channelized AGC + squelch receiver vs the JAX single-device graph
    and the JAX sharded fused flow: 5e-3 relative to the largest output
    (tests/test_sharding.py:208-210).

Squelch is a hard decision: the test signals keep every channel far from
the threshold (occupied channels ~−30 dB, empty ones ~−100 dB against
−60 dB, reckoned at the channelizer's output, where rssi ≈ 20·log10|d|
once the gain loop has settled)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import csdr_tpu as cs
from csdr_tpu.ops import agc as jagc
from csdr_tpu.parallel.channelized import ShardedChannelizedFM

import csdr_tpu_torch as ct
from csdr_tpu_torch.ops import agc as tagc
from csdr_tpu_torch.ops.linrec import linrec, linrec_ref
from csdr_tpu_torch.utils.convert import from_jax_chain_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
THR = -60.0


def _rel(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


@pytest.mark.parametrize("a,cplx,batch", [(0.9, False, (3,)), (0.9995, True, (2, 2)),
                                          (0.5 + 0.3j, True, (4,))])
def test_batched_linrec_matches_oracle_row_by_row(a, cplx, batch):
    n = 700  # not a multiple of the 128-sample block
    rng = np.random.default_rng(11)
    shape = batch + (n,)
    b = rng.normal(size=shape) + (1j * rng.normal(size=shape) if cplx else 0)
    b = b.astype(np.complex64 if cplx else np.float32)
    y0 = rng.normal(size=batch) + (1j * rng.normal(size=batch) if cplx else 0)
    y0 = y0.astype(np.complex64 if cplx else np.float32)
    got = linrec(torch.from_numpy(b), a, torch.from_numpy(y0)).numpy()
    assert got.shape == shape
    for idx in np.ndindex(*batch):
        want = linrec_ref(b[idx].astype(np.complex128 if cplx else np.float64), a, y0[idx])
        assert _rel(got[idx], want) < 2e-5


def level_steps(shape, seed):
    """Complex noise whose level steps between −100 dB and −20 dB every 2048
    samples, a different order in every row."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    seg = (np.arange(n) // 2048)[None, :] + np.arange(int(np.prod(shape[:-1])))[:, None]
    amp = np.where(seg % 2 == 0, 1e-5, 0.1).reshape(shape)
    return (amp * x / np.sqrt(2)).astype(np.complex64)


@pytest.mark.parametrize("thr", [None, THR])
@pytest.mark.parametrize("shape", [(8192,), (4, 8192)])
def test_agc_stream_matches_jax(shape, thr):
    x = level_steps(shape, seed=len(shape))
    js = jagc.agc_init()
    jstep = lambda s, xb: jagc.agc_stream(s, xb, squelch_threshold_db=thr)
    if len(shape) == 2:
        js = jax.tree.map(lambda v: jnp.broadcast_to(v, shape[:1]), js)
        jstep = jax.vmap(jstep)
        ts = tuple(v.expand(shape[:1]).clone() for v in tagc.agc_init(CPU))
    else:
        ts = tagc.agc_init(CPU)
    for blk in np.split(x, 2, axis=-1):
        js, jy = jstep(js, jnp.asarray(blk))
        ts, ty = tagc.agc_stream(ts, torch.from_numpy(blk), squelch_threshold_db=thr)
        jy = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(ty.numpy() == 0, jy == 0)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-5)
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
    if thr is not None:
        assert (ty.numpy() == 0).any() and (ty.numpy() != 0).any()


def test_agc_block_state():
    st = ct.automatic_gain_control(THR).init(CPU)
    want = jagc.agc_init()
    assert st[0].dtype == torch.float32 and st[1].dtype == torch.bool
    assert st[0].item() == float(np.asarray(want[0])) and not st[1].item()


def half_band(nch, n, seed):
    """FM carriers on the even channel centres at −30 dB, the odd channels
    empty but for −100 dB of noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 1e-5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for k in range(0, nch, 2):
        fc = (k - (nch - 1) / 2) / nch
        ph = 2 * np.pi * np.mod(fc * t, 1.0) + 2.0 * np.sin(2 * np.pi * 0.002 * (1 + k % 5) * t)
        x += 0.03 * np.exp(1j * (ph + rng.uniform(0, 2 * np.pi)))
    return x.astype(np.complex64)


NCH, BLOCK = 8, 8 * 512


def jax_agc_graph():
    return cs.chain(cs.dc_blocker(), cs.firpfbch_channelizer(NCH),
                    cs.PerChannel(cs.chain(cs.automatic_gain_control(THR),
                                           cs.fm_demodulator(0.6)), NCH))


def run_jax(graph, blocks):
    st, outs = graph.init(), []
    for b in blocks:
        st, y = graph.apply(st, jnp.asarray(b))
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("backend", ["eager", "pfb_fused"])
def test_channelized_agc_receiver_matches_jax(backend):
    """dc_blocker >> {PFBChannelizer | K4} >> PerChannel(AGC >> FMDemod)
    against the JAX single-device graph and the JAX sharded flow on a 1×1
    mesh with the fused channelize-only kernel (interpret mode)."""
    blocks = np.split(half_band(NCH, 2 * BLOCK, seed=12), 2)
    want = run_jax(jax_agc_graph(), blocks)

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("time", "ch"))
    sh = ShardedChannelizedFM(mesh=mesh, nch=NCH, block_size=BLOCK, agc_threshold_db=THR,
                              use_fused=True, tileF=64, interpret=True)
    st, outs = sh.init(), []
    for b in blocks:
        st, y = sh.step(st, jax.device_put(jnp.asarray(b), sh.input_sharding()))
        outs.append(np.asarray(y))
    want_sharded = np.concatenate(outs, axis=1)

    g = ct.channelized_receiver(NCH, ct.fm_demodulator(0.6), agc_threshold_db=THR,
                                backend=backend)
    sink = ct.CollectSink()
    assert ct.Pipeline(g, BLOCK, device=CPU).run(iter(blocks), sink) == 2 * BLOCK // NCH
    got = sink.concat()

    assert got.shape == want.shape == want_sharded.shape
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 5e-3
    assert np.max(np.abs(got - want_sharded)) / scale < 5e-3
    # the squelch closes the empty channels and opens the occupied ones
    assert not got[1::2].any() and not want[1::2].any()
    assert np.all(np.abs(got[0::2, BLOCK // NCH:]).max(axis=1) > 0.01)


def test_agc_chain_state_handoff_from_jax():
    """JAX runs block 1 of the AGC graph; its state converts; the port's
    eager graph runs block 2 and gives JAX's block 2."""
    b1, b2 = np.split(half_band(NCH, 2 * BLOCK, seed=13), 2)
    jg = jax_agc_graph()
    js, _ = jg.apply(jg.init(), jnp.asarray(b1))
    _, want = jg.apply(js, jnp.asarray(b2))
    tg = ct.channelized_receiver(NCH, ct.fm_demodulator(0.6), agc_threshold_db=THR)
    ts = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
    assert ts[2][0][1].dtype == torch.bool and ts[2][0][1].shape == (NCH,)
    _, got = tg.apply(ts, torch.from_numpy(b2))
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < 5e-3
