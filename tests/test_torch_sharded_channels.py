"""The port's generic sharded chain in the channel layout
(parallel/generic.ShardedChain behind a PFBChannelizer: the column-shard
DFT, PerChannel with its stacked state placed "ch", MixChannels) on
torch.distributed, against the port's serial Pipeline and the JAX
ShardedChain on the virtual 8-device CPU mesh: the channel-layout cases of
tests/test_sharding_generic.py (the 20-channel split :96, PerChannel(AGC >>
FM >> decim) :114, MixChannels :137, the runner's pad/trim :202, the
``divisible`` refusal :231), tests/test_halo_fusion.py:159 (a fused run
inside PerChannel), tests/test_perchannel_local_state.py (the state stays
on its channel rank) and tests/test_multihost.py:87-110 (the (2, 2)
channelizer across processes started as torchrun starts them).  Nothing of
ShardedChain is a Pallas kernel, so the JAX side needs no interpret mode.

The port runs in gloo ranks started by ``parallel.spawn``: one set per mesh
shape, module-scoped, each rank computing every case of its shape, in a
thread while this process computes the JAX side.  Every mesh but (2, 1)
has a channel axis (dc = 2), where a state leaf left whole on every rank
would show.  Blocks are sized so that every rank's segment holds more than
the PFB's and the inner blocks' halos.  Bound: 2e-3 relative to the
largest output (tests/test_sharding_generic.py:60); the fused run against
serial 1e-5 (tests/test_halo_fusion.py:159)."""

import concurrent.futures
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import csdr_tpu_torch as ct
from csdr_tpu_torch.core.block import _leaves
from csdr_tpu_torch.core.sharding import CH, TIME, ShardCtx
from csdr_tpu_torch.parallel import ShardedChain, ShardedPipeline, build_mesh, spawn
from csdr_tpu_torch.utils.convert import from_jax_sharded_chain_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 1), (1, 2), (2, 2)]
BLOCKS = 3
TOL = 2e-3
HANDOVER = (2, 2)


def make_iq(n, seed=0):
    """tests/test_sharding_generic.py:24-30: four tones over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for f in (-0.29, -0.11, 0.07, 0.31):
        x += 0.35 * np.exp(2j * np.pi * np.mod(f * t, 1.0))
    return x.astype(np.complex64)


def graph_of(name, pkg):
    """The case's graph built from ``pkg`` (csdr_tpu_torch or csdr_tpu)."""
    c = pkg.chain
    if name == "split20":
        return c(pkg.dc_blocker(), pkg.firpfbch_channelizer(20))
    if name == "perchannel_agc":
        return c(pkg.dc_blocker(), pkg.firpfbch_channelizer(8),
                 pkg.PerChannel(c(pkg.automatic_gain_control(-40.0), pkg.fm_demodulator(0.6),
                                  pkg.fir_decimator(2)), 8))
    if name == "mix":
        return c(pkg.firpfbch_channelizer(4), pkg.PerChannel(pkg.fm_demodulator(0.6), 4),
                 pkg.MixChannels(), pkg.fir_decimator(2))
    if name == "fused_perchannel":
        return c(pkg.firpfbch_channelizer(8),
                 pkg.PerChannel(c(pkg.fir_filter_c_kaiser(17, 0.3),
                                  pkg.fir_filter_c_kaiser(9, 0.4)), 8))
    if name == "runner":
        return c(pkg.dc_blocker(), pkg.firpfbch_channelizer(8),
                 pkg.PerChannel(pkg.fm_demodulator(0.6), 8))
    if name == "tee":
        return c(pkg.dc_blocker(), pkg.firpfbch_channelizer(4),
                 pkg.Tee(pkg.PerChannel(c(pkg.fm_demodulator(0.6), pkg.fir_decimator(2)), 4),
                         pkg.MixChannels()))
    raise KeyError(name)


STEP_CASES = ["split20", "perchannel_agc", "mix", "fused_perchannel"]
RUN_CASES = ["runner", "tee"]
_PER_TIME_RANK = {"split20": 20 * 128, "perchannel_agc": 8 * 2 * 128, "mix": 4 * 2 * 128,
                  "fused_perchannel": 8 * 256, "runner": 8 * 256, "tee": 4 * 2 * 256}


def block_of(name, dt):
    return dt * _PER_TIME_RANK[name]


def case_input(name, block):
    return make_iq(BLOCKS * block, seed=(STEP_CASES + RUN_CASES).index(name))


def run_input(name, block):
    """(stream, samples to take): two and a half blocks, so the runner pads
    and trims the last one."""
    n = block * 2 + block // 2
    return make_iq(n + 4096, seed=7 + RUN_CASES.index(name)), n


def _to_np(y):
    return tuple(_to_np(t) for t in y) if isinstance(y, tuple) else y.numpy()


def _shapes(tree):
    if isinstance(tree, tuple):
        return tuple(_shapes(t) for t in tree)
    return tuple(tree.shape)


def _counted(ctx, counts):
    """Count ``ctx``'s halo exchanges, last-rank broadcasts and channel
    collectives."""
    for name in ("send_right", "from_last_time", "all_gather_ch", "sum_ch"):
        fn = getattr(ctx, name)

        def wrapped(*a, _fn=fn, _name=name):
            counts[_name] += 1
            return _fn(*a)

        setattr(ctx, name, wrapped)


def _panel_halos(ctx):
    """left_halo and right_halo of a (3, 8) panel whose entries are row·1000
    + the global sample index."""
    nloc, rows = 8, 3
    base = torch.arange(rows, dtype=torch.float32)[:, None] * 1000.0
    x = base + torch.arange(ctx.ti * nloc, (ctx.ti + 1) * nloc, dtype=torch.float32)
    carried = base - torch.arange(3, 0, -1, dtype=torch.float32)
    return dict(left=ctx.left_halo(x, carried, 3).numpy(), right=ctx.right_halo(x, 2).numpy())


def _rank(device, shape, handover):
    """One gloo rank: every step case of this mesh shape, BLOCKS blocks each
    (every rank returns its own outputs and its state's leaf shapes); the
    collective counts of one step; the runner cases; the panel halos; and
    on the handover mesh, block 1 from the converted JAX state."""
    torch.set_num_threads(1)
    dt, dc = shape
    mesh = build_mesh(dt, dc, "cpu")
    ti = torch.distributed.get_rank() // dc
    ci = torch.distributed.get_rank() % dc
    out = {}
    for name in STEP_CASES:
        g = graph_of(name, ct)
        block = block_of(name, dt)
        x = case_input(name, block)
        nloc = block // dt
        sh = ShardedChain(g, mesh, block)
        st, ys = sh.init(), []
        shapes = [_shapes(st)]
        for b in range(BLOCKS):
            st, y = sh.step(st, torch.from_numpy(x[b * block + ti * nloc:][:nloc].copy()))
            ys.append(_to_np(y))
            shapes.append(_shapes(st))
        out[name] = ys
        out[name + ":state"] = shapes

    # one step each: the fused run inside PerChannel, and the same FIRs each
    # behind a Mixer (which ends a run, so each FIR runs solo)
    counts = {}
    for label, g in (("fused", graph_of("fused_perchannel", ct)),
                     ("solo", ct.chain(ct.firpfbch_channelizer(8), ct.PerChannel(ct.chain(
                         ct.fir_filter_c_kaiser(17, 0.3), ct.mix_up(0.1),
                         ct.fir_filter_c_kaiser(9, 0.4)), 8)))):
        block = block_of("fused_perchannel", dt)
        sh = ShardedChain(g, mesh, block)
        counts[label] = dict(send_right=0, from_last_time=0, all_gather_ch=0, sum_ch=0)
        _counted(sh.ctx, counts[label])
        sh.step(sh.init(), torch.from_numpy(make_iq(block // dt)))
    out["counts"] = counts

    for name in RUN_CASES:
        g, block = graph_of(name, ct), block_of(name, dt)
        x, n = run_input(name, block)
        parts = []
        total = ShardedPipeline(ShardedChain(g, mesh, block)).run(iter([x]), parts.append,
                                                                  num_samples=n)
        out[name] = (total, parts)

    out["halos"] = _panel_halos(ShardCtx(mesh))

    if handover is not None:
        name = "perchannel_agc"
        block = block_of(name, dt)
        nloc = block // dt
        x = case_input(name, block)
        sh = ShardedChain(graph_of(name, ct), mesh, block)
        _, y = sh.step(handover[ci], torch.from_numpy(x[block + ti * nloc:][:nloc].copy()))
        out["handover"] = y.numpy()
    return out


def _port_runs(handover):
    return {shape: spawn(_rank, shape[0] * shape[1], "cpu",
                         args=(shape, handover if shape == HANDOVER else None), timeout=300.0)
            for shape in SHAPES}


def _jax_mesh(dt, dc):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc), ("time", "ch"))


def _jax_steps(name, shape, keep_first=False):
    """The JAX ShardedChain over a step case's blocks: the outputs per
    block as numpy arrays, and (``keep_first``) the state after block 0."""
    import jax
    import csdr_tpu as cs
    from csdr_tpu.core.runtime import decode_tree_host
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain

    block = block_of(name, shape[0])
    x = case_input(name, block)
    sh = JaxChain(graph_of(name, cs), _jax_mesh(*shape), block)
    st, ys, first = sh.init(), [], None
    for b in range(BLOCKS):
        st, y = sh.step(st, x[b * block:(b + 1) * block])
        ys.append(np.asarray(decode_tree_host(y)))
        if b == 0 and keep_first:
            first = jax.tree.map(np.asarray, st)
    return ys, first


def _jax_run(name, shape):
    """The JAX ShardedPipeline.run of a runner case: the sink's parts."""
    import csdr_tpu as cs
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain
    from csdr_tpu.parallel.runner import ShardedPipeline as JaxPipeline

    block = block_of(name, shape[0])
    x, n = run_input(name, block)
    parts = []
    total = JaxPipeline(JaxChain(graph_of(name, cs), _jax_mesh(*shape), block)).run(
        iter([x]), parts.append, num_samples=n)
    return total, parts


@pytest.fixture(scope="module")
def runs():
    """(port ranks per shape, JAX outputs per (case, shape)): the JAX AGC
    case on the handover mesh first (its state after block 0 is converted
    for each channel rank), then the port's ranks in a thread while the
    other JAX cases run here."""
    jax_out = {}
    jax_out[("perchannel_agc", HANDOVER)], first = _jax_steps("perchannel_agc", HANDOVER,
                                                              keep_first=True)
    dt, dc = HANDOVER
    tags = graph_of("perchannel_agc", ct).shard_state_spec(ShardCtx.static(dt, dc))
    handover = [from_jax_sharded_chain_state(first, torch.device("cpu"), tags, ci, dc)
                for ci in range(dc)]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, handover)
        for shape in SHAPES:
            for name in STEP_CASES:
                if (name, shape) not in jax_out:
                    jax_out[(name, shape)] = _jax_steps(name, shape)[0]
            for name in RUN_CASES:
                jax_out[(name, shape)] = _jax_run(name, shape)
        return port.result(), jax_out


def _joined(ranks, shape, name, layout):
    """The ranks' outputs of a step case as whole blocks: a CH panel from
    its (ch, time) ranks' panels, a TIME stream from the ci = 0 ranks in
    time order after checking that every ch replica equals it.  Every rank
    must have produced samples."""
    dt, dc = shape
    out = []
    for b in range(BLOCKS):
        for r in ranks:
            assert np.abs(r[name][b]).max() > 0, (name, b)
        if layout == CH:
            rows = [np.concatenate([ranks[ti * dc + ci][name][b] for ti in range(dt)], axis=-1)
                    for ci in range(dc)]
            out.append(np.concatenate(rows, axis=0))
            continue
        for r, res in enumerate(ranks):
            assert np.array_equal(res[name][b], ranks[(r // dc) * dc][name][b]), (name, r)
        out.append(np.concatenate([ranks[ti * dc][name][b] for ti in range(dt)], axis=-1))
    return out


def _rel(got, want):
    return float(np.max(np.abs(got.astype(np.complex128) - want))
                 / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", STEP_CASES)
def test_channel_layout_matches_serial_and_jax(runs, name, shape):
    """Three blocks through the port's ShardedChain against the port's
    serial Pipeline and the JAX ShardedChain on the same mesh shape."""
    port, jax_out = runs
    g = graph_of(name, ct)
    block = block_of(name, shape[0])
    layout = ShardedChain.validate(g, *shape, block)[1]
    assert layout == (TIME if name == "mix" else CH)
    got = _joined(port[shape], shape, name, layout)
    x = case_input(name, block)
    pipe = ct.Pipeline(g, block_size=block, device="cpu")
    errs = []
    for b in range(BLOCKS):
        want = pipe.process_block(x[b * block:(b + 1) * block]).numpy()
        j = jax_out[(name, shape)][b]
        assert got[b].shape == want.shape == j.shape, (got[b].shape, want.shape, j.shape)
        errs.append((_rel(got[b], want), _rel(got[b], j)))
    worst = tuple(max(e[i] for e in errs) for i in range(2))
    print(f"{name} {shape}: vs serial {worst[0]:.3g}, vs JAX {worst[1]:.3g}")
    tol = 1e-5 if name == "fused_perchannel" else TOL
    assert worst[0] < tol and worst[1] < TOL, (name, shape, worst)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ch_state_leaves_hold_this_ranks_rows(runs, shape):
    """PerChannel's stacked state on a rank: nch/dc rows per leaf on a
    channel axis (from init, and after every step), every row where dc = 1;
    the channelizer's and DC blocker's leaves stay whole."""
    dt, dc = shape
    tags = graph_of("perchannel_agc", ct).shard_state_spec(ShardCtx.static(dt, dc))
    assert set(_leaves(tags[2])) == {"ch" if dc > 1 else "rep"}
    assert set(_leaves(tags[:2])) == {"rep"}
    # (dc_blocker, channelizer, PerChannel(AGC, FM demod, decimator))
    want_rows = 8 // dc
    for rank in runs[0][shape]:
        for st in rank["perchannel_agc:state"]:
            assert st[0] == ((1,), (1,)) and st[1] == ((), ((7,), (13, 8)))
            agc, fm, dec = st[2]
            assert agc == ((want_rows,), (want_rows,)) and fm == (want_rows, 1)
            assert dec[0] == want_rows and len(dec) == 2


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_run_inside_perchannel_exchanges_once(runs, shape):
    """tests/test_halo_fusion.py:159 counted on ShardCtx: the channelizer's
    halo and broadcast plus the fused run's one of each per step (two
    FIRs, one context), against one of each per FIR where a Mixer breaks
    the run; PerChannel adds no channel collective
    (tests/test_perchannel_local_state.py:43)."""
    for rank in runs[0][shape]:
        assert rank["counts"]["fused"] == dict(send_right=2, from_last_time=2, all_gather_ch=0,
                                               sum_ch=0), rank["counts"]
        assert rank["counts"]["solo"] == dict(send_right=3, from_last_time=3, all_gather_ch=0,
                                              sum_ch=0), rank["counts"]


def _parts_leaves(parts):
    return [np.concatenate([_leaves(p)[i] for p in parts], axis=-1)
            for i in range(len(_leaves(parts[0])))]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", RUN_CASES)
def test_runner_pads_and_trims_each_leaf(runs, name, shape):
    """ShardedPipeline.run over a stream that ends mid-block against the
    serial Pipeline.run and the JAX ShardedPipeline (test_sharding_generic
    :202): the channel panel, and a Tee of a PerChannel panel at rate 1/8
    and a MixChannels stream at 1/4, each leaf gathered by its own layout
    and trimmed to its own rational count."""
    total, parts = runs[0][shape][0][name]
    jtotal, jparts = runs[1][(name, shape)]
    g, block = graph_of(name, ct), block_of(name, shape[0])
    x, n = run_input(name, block)
    want = []
    want_total = ct.Pipeline(g, block, device="cpu").run(iter([x]), want.append, num_samples=n)
    assert total == want_total == jtotal
    got, serial, jgot = _parts_leaves(parts), _parts_leaves(want), _parts_leaves(jparts)
    for a, w, j in zip(got, serial, jgot):
        assert a.shape == w.shape == j.shape, (a.shape, w.shape, j.shape)
        assert _rel(a, w) < 1e-5 and _rel(a, j) < TOL
    if name == "tee":
        assert got[0].shape == (4, n // 8) and got[1].shape == (n // 4,)
        assert got[1].dtype == np.complex64
    else:
        assert got[0].shape == (8, n // 8)


def test_jax_state_hands_over_mid_stream(runs):
    """The JAX ShardedChain's state after block 0 of PerChannel(AGC >> FM
    >> decim) on (2, 2), converted for each channel rank (its "ch" leaves
    as that rank's rows), steps block 1 on the port's (2, 2) mesh against
    the JAX block 1."""
    port, jax_out = runs
    dt, dc = HANDOVER
    ranks = port[HANDOVER]
    rows = [np.concatenate([ranks[ti * dc + ci]["handover"] for ti in range(dt)], axis=-1)
            for ci in range(dc)]
    got = np.concatenate(rows, axis=0)
    want = jax_out[("perchannel_agc", HANDOVER)][1]
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_halos_take_the_last_axis_of_a_panel(runs, shape):
    """left_halo and right_halo on a (3, 8) panel per rank against numpy:
    each row's last 3 samples of the left neighbour (the carried tail on
    the first time rank) and first 2 of the right neighbour (the last
    sample repeated on the last time rank)."""
    dt, dc = shape
    full = np.arange(3)[:, None] * 1000.0 + np.arange(8 * dt)[None, :]
    for r, got in enumerate(runs[0][shape]):
        ti = r // dc
        lo, hi = ti * 8, (ti + 1) * 8
        left = (np.arange(3)[:, None] * 1000.0 - np.arange(3, 0, -1) if ti == 0
                else full[:, lo - 3:lo])
        right = full[:, [hi - 1] * 2] if ti == dt - 1 else full[:, hi:hi + 2]
        assert np.array_equal(got["halos"]["left"], left), r
        assert np.array_equal(got["halos"]["right"], right), r


# ---- static refusals, with the JAX messages -----------------------------------

REFUSALS = {
    # tests/test_sharding_generic.py:237
    "channelizer_divisible": (lambda p: p.chain(p.firpfbch_channelizer(6)), 2, 4, 2 * 6 * 256),
    "channelizer_divisible_ch2": (lambda p: p.chain(p.dc_blocker(), p.firpfbch_channelizer(5)),
                                  1, 2, 5 * 256),
    "perchannel_divisible": (lambda p: p.chain(p.firpfbch_channelizer(8),
                                               p.PerChannel(p.fm_demodulator(0.6), 6)),
                             2, 4, 2 * 8 * 256),
    "channelizer_halo": (lambda p: p.chain(p.firpfbch_channelizer(8)), 2, 2, 2 * 8 * 8),
    "channelizer_layout": (lambda p: p.chain(p.firpfbch_channelizer(4),
                                             p.firpfbch_channelizer(4)), 2, 2, 2 * 16 * 256),
    "perchannel_layout": (lambda p: p.chain(p.PerChannel(p.fm_demodulator(0.6), 4)),
                          2, 2, 2 * 256),
    "mix_layout": (lambda p: p.chain(p.fm_demodulator(0.6), p.MixChannels()), 2, 2, 2 * 256),
    "perchannel_inner_halo": (lambda p: p.chain(p.firpfbch_channelizer(8), p.PerChannel(
        p.fir_filter_c_kaiser(129, 0.2), 8)), 2, 2, 2 * 8 * 64),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_channel_layout_refusals_equal_jax(name):
    """Refused before any collective (ShardedChain.validate, no process
    group) with the JAX shard_validate's message, on the same mesh shape
    (the port's halo message joins its advice with a colon, the JAX one
    with a dash)."""
    import csdr_tpu as cs
    from csdr_tpu.core.sharding import ShardCtx as JaxCtx

    build, dt, dc, block = REFUSALS[name]
    with pytest.raises(ValueError) as port:
        ShardedChain.validate(build(ct), dt, dc, block)
    with pytest.raises(ValueError) as jax_err:
        build(cs).shard_validate(block // dt, JaxCtx(dt, dc))
    assert str(port.value) == str(jax_err.value).replace(" — ", ": ")
    if "divisible" in name:
        assert "not divisible by the" in str(port.value)


def test_validation_matches_jax_local_lengths():
    """The static walk's local output length and layout equal the JAX
    ShardedChain's for every case of this file on (2, 2)."""
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain
    import csdr_tpu as cs

    for name in STEP_CASES + RUN_CASES:
        block = block_of(name, 2)
        js = JaxChain(graph_of(name, cs), _jax_mesh(2, 2), block)
        assert ShardedChain.validate(graph_of(name, ct), 2, 2, block) == (js.nloc_out,
                                                                         js.out_layout)


# ---- the (2, 2) channelizer across processes started as torchrun starts them --

_WORKER = textwrap.dedent(r"""
    import os, sys
    sys.path.insert(0, os.environ["CSDR_REPO"])
    import numpy as np, torch
    import csdr_tpu_torch as ct
    from csdr_tpu_torch.parallel import (ShardedChain, ShardedPipeline, build_mesh,
                                         init_distributed)

    torch.set_num_threads(1)
    device = init_distributed(device_type="cpu")   # RANK, WORLD_SIZE, MASTER_* from env
    rank = torch.distributed.get_rank()
    graph = ct.chain(ct.dc_blocker(), ct.firpfbch_channelizer(8))
    block, nblocks = 1 << 13, 2
    rng = np.random.default_rng(7)
    n = block * nblocks
    t = np.arange(n)
    iq = (0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
          + sum(0.35 * np.exp(2j * np.pi * np.mod(f * t, 1.0)) for f in (-0.29, 0.07, 0.31)))
    iq = iq.astype(np.complex64)
    sh = ShardedChain(graph, build_mesh(2, 2, "cpu"), block)
    parts = []
    ShardedPipeline(sh).run(iter([iq]) if rank == 0 else None,
                            parts.append if rank == 0 else None)
    if rank == 0:
        want = []
        ct.Pipeline(graph, block, device="cpu").run(iter([iq]), want.append)
        assert len(parts) == len(want) == nblocks
        err = max(float(np.abs(a - b).max()) for a, b in zip(parts, want))
        assert err < 1e-5, err
    torch.distributed.destroy_process_group()
    print(f"[{rank}] OK: {nblocks} channelized blocks equal to serial", flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_channelizer_across_torchrun_processes(tmp_path):
    """tests/test_multihost.py:87-110's second scenario: the (2, 2)
    channelizer, its column-shard DFT and the runner's panel gather across
    process boundaries.  The port runs one process per device, so the four
    ranks of (2, 2) are four processes, each finding its rank, the world
    size and the rendezvous in the environment torchrun sets; 2 blocks
    equal the serial Pipeline within the JAX test's 1e-5."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = str(_free_port())
    procs = []
    for r in range(4):
        env = dict(os.environ, CSDR_REPO=REPO, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"[{r}] OK" in out, out[-3000:]
