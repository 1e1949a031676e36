"""The port's channelized mesh on torch.distributed against the JAX package:
ShardedChannelizedFM (eager, K3, K4, AGC, audio decimator) against the JAX
ShardedChannelizedFM on the virtual 8-device CPU mesh (its Pallas kernels
in interpret mode), ShardCtx's collectives against serial numpy, the decay
tables and the mesh factor rule against the JAX ones, the JAX state handed
over mid-stream, and ``spawn``'s failure and timeout handling.

The port runs in gloo ranks started by ``parallel.spawn`` (one set per mesh
shape, module-scoped, each set computing every case of its shape, in a
thread while this process computes the JAX side).  The ranks import this
module, so the JAX side is imported inside the fixtures only.  Bounds,
relative to the largest output, are tests/test_sharding.py's: 2e-3 (:74),
5e-3 with the AGC (:130) and 5e-3 for the fused kernels, K3 from frame 1
(:162-166)."""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

from csdr_tpu_torch.core import sharding as port_sharding
from csdr_tpu_torch.parallel import (ShardedChannelizedFM, ShardedPipeline, build_mesh,
                                     mesh_shape, spawn)
from csdr_tpu_torch.utils.convert import from_jax_sharded_channelized_state

NCH, THR = 8, -60.0

# name → (mesh, keyword arguments, frames per time rank, input seed, input scale)
CASES = {
    "plain_2x2": ((2, 2), {}, 256, 0, 1.0),
    "plain_4x1": ((4, 1), {}, 256, 0, 1.0),
    "plain_1x2": ((1, 2), {}, 256, 0, 1.0),
    "decim2_2x2": ((2, 2), {"audio_decim": 2}, 512, 0, 1.0),
    "agc_2x2": ((2, 2), {"agc_threshold_db": THR}, 512, 11, 0.05),
    "agc_4x1": ((4, 1), {"agc_threshold_db": THR}, 512, 11, 0.05),
    "fused_2x2": ((2, 2), {"use_fused": True}, 256, 7, 1.0),
    "fused_agc_2x2": ((2, 2), {"use_fused": True, "agc_threshold_db": THR}, 512, 13, 0.05),
}
BLOCKS = 2


def make_input(n, seed=0):
    """tests/test_sharding.py:36-42."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for f in (-0.31, -0.07, 0.11, 0.33):
        x += 0.4 * np.exp(2j * np.pi * np.mod(f * t, 1.0))
    return x.astype(np.complex64)


def _case_input(name):
    (dt, _), _, frames, seed, scale = CASES[name]
    block = dt * NCH * frames
    return block, (make_input(BLOCKS * block, seed) * scale).astype(np.complex64)


def _ctx_checks(ctx, device):
    """ShardCtx's collectives on this rank's segment of seeded global data."""
    rng = np.random.default_rng(21)
    n = ctx.dt * 96
    seg = slice(ctx.ti * 96, (ctx.ti + 1) * 96)
    f = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
    carry = np.array([0.5 - 0.2j, -0.3 + 0.1j], np.complex64)
    out = {"seg": (seg.start, seg.stop)}
    for name, a in (("real", 0.95), ("complex", complex(0.9 * np.exp(0.3j)))):
        y, y_in, end = ctx.linrec(torch.from_numpy(f[:, seg]), a, torch.from_numpy(carry))
        out[f"linrec_{name}"] = (y.numpy(), y_in.numpy(), end.numpy())
    taps = rng.normal(size=9)
    hist = rng.normal(size=(2, 8)).astype(np.float32)
    x = rng.normal(size=(2, n)).astype(np.float32)
    h2, y = ctx.fir(taps, torch.from_numpy(hist), torch.from_numpy(x[:, seg]))
    out["fir"] = (h2.numpy(), y.numpy())
    ramp = torch.arange(n, dtype=torch.float32)[seg]
    out["left_halo"] = ctx.left_halo(ramp, torch.tensor([-3.0, -2.0, -1.0]), 3).numpy()
    out["right_halo"] = ctx.right_halo(ramp, 2).numpy()
    out["all_gather_ch"] = ctx.all_gather_ch(torch.tensor([float(ctx.ci)])).numpy()
    out["from_last_time"] = ctx.from_last_time(torch.tensor([float(ctx.ti)])).numpy()
    return out


def _rank(device, shape, names, handover):
    """One gloo rank: every case of this mesh shape through ShardedPipeline
    (rank 0 keeps the audio), the ShardCtx checks on every rank, and where
    ``handover`` holds a JAX state, one block from that state."""
    torch.set_num_threads(1)
    mesh = build_mesh(*shape, "cpu")
    out = {}
    for name in names:
        _, kw, _, _, _ = CASES[name]
        block, iq = _case_input(name)
        sh = ShardedChannelizedFM(mesh=mesh, nch=NCH, block_size=block, **kw)
        parts = []
        ShardedPipeline(sh).run(iter([iq]), parts.append)
        if parts:
            out[name] = np.concatenate(parts, axis=1)
    out["ctx"] = _ctx_checks(port_sharding.ShardCtx(mesh), device)
    if handover is not None:
        block, iq = _case_input("plain_2x2")
        sh = ShardedChannelizedFM(mesh=mesh, nch=NCH, block_size=block)
        pipe = ShardedPipeline(sh)
        pipe.state = from_jax_sharded_channelized_state(handover, device)
        parts = []
        pipe.run(iter([iq[block:]]), parts.append)
        if parts:
            out["handover"] = parts[0]
    return out


def _port_runs(handover):
    res = {}
    for shape in ((2, 2), (4, 1), (1, 2)):
        names = [k for k, c in CASES.items() if c[0] == shape]
        ranks = spawn(_rank, shape[0] * shape[1], "cpu",
                      args=(shape, names, handover if shape == (1, 2) else None),
                      timeout=240.0)
        res.update(ranks[0])
        res[shape] = [r["ctx"] for r in ranks]
    return res


def _jax_run(name, keep_first=False):
    """The JAX ShardedChannelizedFM over a case's blocks: (audio, the
    encoded state after the first block as numpy, CEnc leaves as 1-tuples)."""
    import jax
    from jax.sharding import Mesh

    from csdr_tpu.parallel.channelized import ShardedChannelizedFM as JaxFM

    (dt, dc), kw, _, _, _ = CASES[name]
    block, iq = _case_input(name)
    mesh = Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc), ("time", "ch"))
    fused = {"tileF": 64, "interpret": True} if kw.get("use_fused") else {}
    sh = JaxFM(mesh=mesh, nch=NCH, block_size=block, **kw, **fused)
    state, outs, first = sh.init(), [], None
    for b in range(BLOCKS):
        xb = jax.device_put(iq[b * block:(b + 1) * block], sh.input_sharding())
        state, y = sh.step(state, xb)
        outs.append(np.asarray(y))
        if b == 0 and keep_first:
            first = {k: (np.asarray(v.ri),) if hasattr(v, "ri") else np.asarray(v)
                     for k, v in state.items()}
    return np.concatenate(outs, axis=1), first


@pytest.fixture(scope="module")
def runs():
    """(port results, JAX audio per case): the JAX run of plain_2x2 first
    (its first-block state is handed over), then the port's ranks in a
    thread while the other JAX cases run here."""
    jax_audio = {}
    jax_audio["plain_2x2"], first = _jax_run("plain_2x2", keep_first=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, first)
        for name in CASES:
            if name not in jax_audio:
                jax_audio[name] = _jax_run(name)[0]
        return port.result(), jax_audio


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax(runs, name):
    port, jax_audio = runs
    got, want = port[name], jax_audio[name]
    assert got.shape == want.shape
    kw = CASES[name][1]
    f0 = 1 if kw.get("use_fused") and "agc_threshold_db" not in kw else 0  # K3's demod seed
    bound = 2e-3 if not kw.get("use_fused") and "agc_threshold_db" not in kw else 5e-3
    err = np.max(np.abs(got[:, f0:] - want[:, f0:])) / (np.max(np.abs(want)) + 1e-12)
    assert err < bound, (name, err)


def test_jax_state_hands_over_mid_stream(runs):
    """JAX's encoded state after block 0 (mesh 2x2), converted, runs block 1
    on a 1x2 mesh of the port against JAX's block 1."""
    port, jax_audio = runs
    block, _ = _case_input("plain_2x2")
    want = jax_audio["plain_2x2"][:, block // NCH:]
    got = port["handover"]
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-3


def _serial_linrec(f, a, carry):
    y = np.empty(f.shape, np.complex128)
    for r in range(f.shape[0]):
        acc = complex(carry[r])
        for i, v in enumerate(f[r]):
            acc = a * acc + v
            y[r, i] = acc
    return y


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_shard_ctx_collectives(runs, shape):
    """linrec (real and complex poles, one recurrence per row), fir, the
    halos, all_gather_ch and from_last_time against serial numpy."""
    ranks = runs[0][shape]
    dt, dc = shape
    rng = np.random.default_rng(21)
    n = dt * 96
    f = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
    carry = np.array([0.5 - 0.2j, -0.3 + 0.1j], np.complex64)
    taps = rng.normal(size=9)
    hist = rng.normal(size=(2, 8)).astype(np.float32)
    x = rng.normal(size=(2, n)).astype(np.float32)
    xfull = np.concatenate([hist, x], axis=1).astype(np.float64)
    fir_want = np.stack([np.convolve(r, taps, "valid") for r in xfull])
    for rank, got in enumerate(ranks):
        ti, ci = divmod(rank, dc)
        a0, a1 = got["seg"]
        for name, a in (("real", 0.95), ("complex", complex(0.9 * np.exp(0.3j)))):
            want = _serial_linrec(f, a, carry)
            y, y_in, end = got[f"linrec_{name}"]
            scale = np.max(np.abs(want))
            assert np.max(np.abs(y - want[:, a0:a1])) / scale < 1e-5, (rank, name)
            w_in = carry if ti == 0 else want[:, a0 - 1]
            assert np.max(np.abs(y_in - w_in)) / scale < 1e-5, (rank, name)
            assert np.max(np.abs(end - want[:, -1])) / scale < 1e-5, (rank, name)
        h2, y = got["fir"]
        assert np.max(np.abs(y - fir_want[:, a0:a1])) < 1e-5, rank
        assert np.array_equal(h2, x[:, -8:]), rank
        lh = np.array([-3.0, -2.0, -1.0]) if ti == 0 else np.arange(a0 - 3, a0)
        assert np.array_equal(got["left_halo"], lh), rank
        rh = np.full(2, a1 - 1.0) if ti == dt - 1 else np.arange(a1, a1 + 2)
        assert np.array_equal(got["right_halo"], rh), rank
        assert np.array_equal(got["all_gather_ch"], np.arange(dc, dtype=np.float32)), rank
        assert np.array_equal(got["from_last_time"], [dt - 1.0]), rank


@pytest.mark.parametrize("a,nloc,dt,cplx", [(0.9995, 4096, 4, False), (0.9, 512, 2, False),
                                            (0.9995, 1 << 21, 4, False),
                                            (complex(0.97 * np.exp(0.2j)), 256, 4, True)])
def test_decay_tables_equal_jax(a, nloc, dt, cplx):
    """The host float64 tables, copied: equal to the JAX package's bit for
    bit, exact zeros included (production nloc underflows them)."""
    from csdr_tpu.core import sharding as jax_sharding

    for fn, args in (("_apow_vec", (a, nloc, cplx)), ("_astep_table", (a, nloc, dt, cplx)),
                     ("_carry_coef_table", (a, nloc, dt, cplx))):
        got = getattr(port_sharding, fn)(*args)
        want = getattr(jax_sharding, fn)(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_matches_jax_make_mesh(n):
    from csdr_tpu.parallel.channelized import make_mesh

    m = make_mesh(n)
    assert mesh_shape(n) == (m.shape["time"], m.shape["ch"])


def _raising_rank(device):
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()   # rank 0 would wait here for good


def _sleeping_rank(device):
    time.sleep(600)


def test_spawn_brings_down_the_group_when_a_rank_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank 1 gives up"):
        spawn(_raising_rank, 2, "cpu", timeout=120.0)
    assert time.monotonic() - t0 < 60


def test_spawn_kills_its_ranks_at_the_timeout():
    with pytest.raises(TimeoutError):
        spawn(_sleeping_rank, 2, "cpu", timeout=8.0)
