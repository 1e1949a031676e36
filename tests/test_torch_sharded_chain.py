"""The port's generic sharded chain (parallel/generic.ShardedChain, the Block
shard protocol of core/block.py, the time layout) on torch.distributed,
against the port's serial Pipeline and the JAX ShardedChain on the virtual
8-device CPU mesh: the time-layout cases of tests/test_sharding_generic.py
(the WBFM receiver :76, mixer + IIR + AGC :159, Tee + Delay :178, the
runner's pad/trim :202, the rejections :231, the multi-rate Tee :362-:393),
tests/test_halo_fusion.py (the fused-run plan, its one exchange and one
broadcast per step, stream equivalence) and tests/test_multihost.py (two
processes started as torchrun starts them).  Nothing of ShardedChain is a
Pallas kernel, so the JAX side needs no interpret mode.

The port runs in gloo ranks started by ``parallel.spawn``: one set per mesh
shape, module-scoped, each rank computing every case of its shape, in a
thread while this process computes the JAX side.  The ranks import this
module, so the JAX package is imported inside the fixtures and tests only.
Bound: 2e-3 relative to the largest output (tests/test_sharding_generic.py:60);
the fused runs against serial 1e-5 (tests/test_halo_fusion.py:135)."""

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
from csdr_tpu_torch.parallel import ShardedChain, ShardedPipeline, build_mesh, spawn
from csdr_tpu_torch.utils.convert import from_jax_sharded_chain_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 1), (4, 1), (2, 2)]
BLOCKS = 3
TOL = 2e-3


def make_iq(n, seed=0):
    """tests/test_sharding_generic.py:24-30."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for f in (-0.29, -0.11, 0.07, 0.31):
        x += 0.35 * np.exp(2j * np.pi * np.mod(f * t, 1.0))
    return x.astype(np.complex64)


def graph_of(name, pkg, dtype=None):
    """The case's graph built from ``pkg`` (csdr_tpu_torch or csdr_tpu);
    ``dtype`` is the package's float32 (Delay's)."""
    c = pkg.chain
    if name == "wbfm":
        return c(pkg.resampler(0.4), pkg.dc_blocker(), pkg.wbfm_demodulator(128_000.0, 4))
    if name == "mixer_iir_agc":
        return c(pkg.mix_down(2.0 * np.pi * 0.123), pkg.iir_cfilter(4, 0.2),
                 pkg.automatic_gain_control(-35.0), pkg.mix_up(2.0 * np.pi * 0.05))
    if name == "tee":
        return pkg.Tee(c(pkg.fir_filter_c_kaiser(33, 0.2), pkg.fm_demodulator(0.6)),
                       c(pkg.dc_blocker(), pkg.am_demodulator()))
    if name == "delay":
        return pkg.Delay(37, dtype=dtype)
    if name == "multirate_tee":
        return c(pkg.dc_blocker(),
                 pkg.Tee(c(pkg.fir_filter_c_kaiser(33, 0.2), pkg.fir_decimator(4)),
                         c(pkg.fir_filter_c_kaiser(17, 0.45))))
    if name == "fused_resampler":
        return c(pkg.resampler(0.1), pkg.fir_filter_c_kaiser(65, 0.2),
                 pkg.fir_filter_c_kaiser(33, 0.3))
    raise KeyError(name)


GRAPHS = ["wbfm", "mixer_iir_agc", "tee", "delay", "multirate_tee", "fused_resampler"]


def block_of(name, granule, dt):
    if name == "delay":
        return dt * 512
    if name == "multirate_tee":
        return dt * 4 * 512
    return dt * granule * max(1, 4096 // granule)


def case_input(name, block):
    if name == "delay":   # tests/test_sharding_generic.py:191
        return np.random.default_rng(3).normal(size=BLOCKS * block).astype(np.float32)
    return make_iq(BLOCKS * block, seed=GRAPHS.index(name))


def _port_graph(name):
    return graph_of(name, ct, torch.float32)


def _to_np(y):
    return tuple(_to_np(t) for t in y) if isinstance(y, tuple) else y.numpy()


def _counted(ctx, counts):
    """Count ``ctx``'s halo exchanges and last-rank broadcasts."""
    send, last = ctx.send_right, ctx.from_last_time

    def send_right(t):
        counts["send_right"] += 1
        return send(t)

    def from_last_time(v):
        counts["from_last_time"] += 1
        return last(v)

    ctx.send_right, ctx.from_last_time = send_right, from_last_time


# the fused run of tests/test_halo_fusion.py:112
FUSED_COUNT = "fused_resampler"
RUNNER = ["runner_delay", "runner_multirate"]


def runner_case(name, dt):
    """(graph, block) of a runner case: Delay's 37-sample flush behind a FIR,
    and a multi-rate Tee (tests/test_sharding_generic.py:393)."""
    if name == "runner_delay":
        return ct.chain(ct.dc_blocker(), ct.fir_filter_c_kaiser(33, 0.2),
                        ct.Delay(37, dtype=torch.complex64)), dt * 1024
    return ct.chain(ct.Tee(ct.fir_decimator(4), ct.fir_filter_c_kaiser(9, 0.3))), dt * 4 * 256


def _rank(device, shape, handover):
    """One gloo rank: every case of this mesh shape, BLOCKS blocks each,
    stepped on this rank's time segment (every rank returns its own
    outputs); the collective counts of one step; the runner's pad, trim and
    flush; and where ``handover`` holds a converted JAX state, block 1 from
    it."""
    torch.set_num_threads(1)
    dt, dc = shape
    mesh = build_mesh(dt, dc, "cpu")
    ti = torch.distributed.get_rank() // dc
    out = {}
    for name in GRAPHS:
        g = _port_graph(name)
        block = block_of(name, g.granule, dt)
        x = case_input(name, block)
        nloc = block // dt
        sh = ShardedChain(g, mesh, block)
        st, ys = sh.init(), []
        for b in range(BLOCKS):
            seg = torch.from_numpy(x[b * block + ti * nloc:][:nloc].copy())
            st, y = sh.step(st, seg)
            ys.append(_to_np(y))
        out[name] = ys

    # one step of the fused run, and of three FIRs each behind a Mixer (which
    # ends a run, so each FIR runs solo)
    counts = {}
    for label, g in (("fused", _port_graph(FUSED_COUNT)),
                     ("solo", ct.chain(ct.fir_filter_c_kaiser(65, 0.2), ct.mix_up(0.1),
                                       ct.fir_filter_c_kaiser(33, 0.3), ct.mix_up(0.1),
                                       ct.fir_filter_c_kaiser(17, 0.3)))):
        block = dt * g.granule * max(1, 4096 // g.granule)
        sh = ShardedChain(g, mesh, block)
        counts[label] = dict(send_right=0, from_last_time=0)
        _counted(sh.ctx, counts[label])
        sh.step(sh.init(), torch.from_numpy(make_iq(block // dt)))
    out["counts"] = counts

    # the runner: a short last block, per-leaf trims, Delay's flush
    for name in RUNNER:
        g, block = runner_case(name, dt)
        n = block * 2 + block // 2
        parts = []
        total = ShardedPipeline(ShardedChain(g, mesh, block)).run(
            iter([make_iq(n + 4096, 5)]), parts.append, num_samples=n)
        out[name] = (total, parts)

    if handover is not None:
        g = _port_graph("wbfm")
        block = block_of("wbfm", g.granule, dt)
        nloc = block // dt
        sh = ShardedChain(g, mesh, block)
        x = case_input("wbfm", block)
        _, y = sh.step(handover, torch.from_numpy(x[block + ti * nloc:][:nloc].copy()))
        out["handover"] = y.numpy()
    return out


def _port_runs(handover):
    res = {}
    for shape in SHAPES:
        ranks = spawn(_rank, shape[0] * shape[1], "cpu",
                      args=(shape, handover if shape == (2, 1) else None), timeout=300.0)
        res[shape] = ranks
    return res


def _jax_mesh(dt, dc):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc), ("time", "ch"))


def _jax_run(name, shape, keep_first=False):
    """The JAX ShardedChain over a case's blocks: the outputs per block as
    numpy trees, and (``keep_first``) the state after block 0."""
    import jax.numpy as jnp
    import csdr_tpu as cs
    from csdr_tpu.core.runtime import decode_tree_host
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain

    g = graph_of(name, cs, jnp.float32)
    block = block_of(name, g.granule, shape[0])
    x = case_input(name, block)
    sh = JaxChain(g, _jax_mesh(*shape), block)
    st, ys, first = sh.init(), [], None
    for b in range(BLOCKS):
        st, y = sh.step(st, x[b * block:(b + 1) * block])
        ys.append(decode_tree_host(y))
        if b == 0 and keep_first:
            import jax

            first = jax.tree.map(np.asarray, st)
    return ys, first


@pytest.fixture(scope="module")
def runs():
    """(port ranks per shape, JAX outputs per (case, shape)): the JAX WBFM
    run on (2, 1) first (its state after block 0 is handed over), then the
    port's ranks in a thread while the other JAX cases run here."""
    jax_out = {}
    jax_out[("wbfm", (2, 1))], first = _jax_run("wbfm", (2, 1), keep_first=True)
    handover = from_jax_sharded_chain_state(first, torch.device("cpu"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, handover)
        for name in GRAPHS:
            for shape in SHAPES:
                if (name, shape) not in jax_out:
                    jax_out[(name, shape)] = _jax_run(name, shape)[0]
        return port.result(), jax_out


def _joined(ranks, shape, name):
    """The ranks' outputs of a case joined along time (ci = 0 ranks, in
    time order), after checking that every ch replica equals its ci = 0
    rank."""
    dt, dc = shape
    for r, res in enumerate(ranks):
        ti, ci = divmod(r, dc)
        if ci:
            for got, want in zip(res[name], ranks[ti * dc][name]):
                for a, b in zip(_leaves(got), _leaves(want)):
                    assert np.array_equal(a, b), (name, r)
    out = []
    for b in range(BLOCKS):
        per_rank = [_leaves(ranks[ti * dc][name][b]) for ti in range(dt)]
        out.append([np.concatenate(leaf, axis=-1) for leaf in zip(*per_rank)])
    return out


def _rel(got, want):
    return float(np.max(np.abs(got.astype(np.complex128) - want))
                 / (np.max(np.abs(want)) + 1e-12))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", GRAPHS)
def test_sharded_chain_matches_serial_and_jax(runs, name, shape):
    """Three blocks through the port's ShardedChain against the port's
    serial Pipeline and the JAX ShardedChain on the same mesh shape; every
    leaf's largest error relative to its largest output is reported."""
    port, jax_out = runs
    got = _joined(port[shape], shape, name)
    g = _port_graph(name)
    block = block_of(name, g.granule, shape[0])
    x = case_input(name, block)
    pipe = ct.Pipeline(g, block_size=block, device="cpu")
    errs = []
    for b in range(BLOCKS):
        want = [t.numpy() for t in _leaves(pipe.process_block(x[b * block:(b + 1) * block]))]
        jax_leaves = [np.asarray(t) for t in _leaves(jax_out[(name, shape)][b])]
        assert len(got[b]) == len(want) == len(jax_leaves), name
        for a, w, j in zip(got[b], want, jax_leaves):
            assert a.shape == w.shape == j.shape, (name, a.shape, w.shape, j.shape)
            errs.append((_rel(a, w), _rel(a, j)))
    worst = tuple(max(e[i] for e in errs) for i in range(2))
    print(f"{name} {shape}: vs serial {worst[0]:.3g}, vs JAX {worst[1]:.3g}")
    tol = 1e-5 if name == "fused_resampler" else TOL
    assert worst[0] < tol and worst[1] < TOL, (name, shape, worst)
    if name == "multirate_tee":
        assert all(blk[0].shape[-1] * 4 == blk[1].shape[-1] for blk in got)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_run_exchanges_once_per_step(runs, shape):
    """tests/test_halo_fusion.py:112-127 counted on ShardCtx: the 6-block
    run makes one left-halo exchange and one last-rank broadcast per step;
    the same kind of run broken by Mixers pays one of each per FIR."""
    g = _port_graph(FUSED_COUNT)
    assert len(g.blocks) == 6 and g._shard_segments()[0][0] == "fused"
    for rank in runs[0][shape]:
        assert rank["counts"]["fused"] == dict(send_right=1, from_last_time=1), rank["counts"]
        assert rank["counts"]["solo"] == dict(send_right=3, from_last_time=3), rank["counts"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", RUNNER)
def test_runner_pads_trims_and_flushes_like_serial(runs, name, shape):
    """ShardedPipeline.run over a stream that ends mid-block (padded, then
    trimmed leaf by leaf by its own rate) with Delay's 37-sample flush,
    against the serial Pipeline.run of the same graph."""
    total, parts = runs[0][shape][0][name]
    g, block = runner_case(name, shape[0])
    n = block * 2 + block // 2
    want = []
    want_total = ct.Pipeline(g, block, device="cpu").run(iter([make_iq(n + 4096, 5)]),
                                                         want.append, num_samples=n)
    assert total == want_total
    for leaf in range(2):
        a = np.concatenate([_leaves(p)[leaf] for p in parts])
        w = np.concatenate([_leaves(p)[leaf] for p in want])
        assert a.shape == w.shape, (a.shape, w.shape)
        assert _rel(a, w) < 1e-5
    if name == "runner_delay":
        assert total == n + 37 and parts[-1][1].shape == (37 + n % block,)
    else:
        assert (sum(p[0].shape[0] for p in parts), sum(p[1].shape[0] for p in parts)) \
            == (n // 4, n)


def test_jax_state_hands_over_mid_stream(runs):
    """The JAX ShardedChain's state after block 0 of the WBFM receiver (its
    resampler a fused run: one raw-input tail), converted, steps block 1 on
    the port's (2, 1) mesh against the JAX block 1."""
    port, jax_out = runs
    got = np.concatenate([r["handover"] for r in port[(2, 1)]])
    want = np.asarray(jax_out[("wbfm", (2, 1))][1])
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


# ---- the fused-run plan, pure Python --------------------------------------------

PLAN_GRAPHS = ["resampler_firs", "fm_dc_solo", "interior_lambda", "single_tail",
               "halfband_rational", "interp_decim", "long_firs", "resampler_fm", "wbfm", "cw",
               "usb_front"]


def plan_graphs(pkg):
    """The graphs of tests/test_halo_fusion.py, and the -c 1 CLI chains."""
    blocks_mod = pkg.blocks
    return {
        "resampler_firs": pkg.chain(pkg.resampler(0.1), pkg.fir_filter_c_kaiser(65, 0.2),
                                    pkg.fir_filter_c_kaiser(33, 0.3)),
        "fm_dc_solo": pkg.chain(pkg.fir_filter_c_kaiser(33, 0.2), pkg.fm_demodulator(0.6),
                                pkg.dc_blocker(complex_input=False)),
        "interior_lambda": pkg.chain(pkg.fir_filter_c_kaiser(33, 0.2),
                                     pkg.Lambda(lambda x: x.real, name="re"),
                                     pkg.fir_filter(np.hanning(17) / 8.0, complex_input=False)),
        "single_tail": pkg.chain(pkg.fir_filter_c_kaiser(33, 0.2), pkg.fm_demodulator(0.6)),
        "halfband_rational": pkg.resampler(0.4),
        "interp_decim": pkg.chain(pkg.fir_interpolator(3), pkg.fir_filter_c_kaiser(33, 0.2),
                                  blocks_mod.FIRDecim(4, complex_input=True),
                                  blocks_mod.HalfbandDecim(complex_input=True)),
        "long_firs": pkg.chain(pkg.fir_filter_c_kaiser(513, 0.1),
                               pkg.fir_filter_c_kaiser(513, 0.12)),
        "resampler_fm": pkg.chain(pkg.resampler(0.4), pkg.fm_demodulator(0.6)),
        "wbfm": graph_of("wbfm", pkg),
        "cw": pkg.chain(pkg.dc_blocker(), pkg.cw_demodulator(500 / 48000, 700 / 48000)),
        "usb_front": pkg.chain(pkg.resampler(0.0375), pkg.dc_blocker(),
                               pkg.ssb_demodulator("usb", 0.0625)),
    }


@pytest.mark.parametrize("name", PLAN_GRAPHS)
def test_segments_and_plan_equal_jax(name):
    """Chain._shard_segments (runs, solo blocks) and _plan_fused's A_1 on
    tests/test_halo_fusion.py's graphs equal the JAX package's."""
    import csdr_tpu as cs

    port = plan_graphs(ct)[name]
    want = plan_graphs(cs)[name]
    assert port._shard_segments() == want._shard_segments()
    fused = [s for s in want._shard_segments() if s[0] == "fused"]
    for _, i0, j, A1 in fused:
        assert type(port)._plan_fused(port.blocks[i0:j + 1]) == A1


TAIL_BLOCKS = {
    "fir": lambda pkg: pkg.fir_filter_c_kaiser(65, 0.2),
    "fir_decim": lambda pkg: pkg.blocks.FIRDecim(4),
    "fir_interp": lambda pkg: pkg.fir_interpolator(3),
    "halfband": lambda pkg: pkg.blocks.HalfbandDecim(),
    "rational": lambda pkg: pkg.blocks.RationalResampler(4, 5),
    "real_to_complex": lambda pkg: pkg.real_to_complex(),
    "complex_to_real": lambda pkg: pkg.complex_to_real(),
    "fm_demod": lambda pkg: pkg.fm_demodulator(0.6),
    "delay": lambda pkg: pkg.Delay(37),
}


@pytest.mark.parametrize("name", list(TAIL_BLOCKS))
def test_tail_state_blocks_equal_jax(name):
    """Every tail-state block's halo (``tail_len``), zero-context flag and
    granule equal the JAX block's: the halo exchanges and fused-run plans
    rest on them."""
    import csdr_tpu as cs

    port, want = TAIL_BLOCKS[name](ct), TAIL_BLOCKS[name](cs)
    assert (port.tail_len, port.fuse_zero_tail, port.granule) == \
        (want.tail_len, want.fuse_zero_tail, want.granule)
    assert tuple(port.init(torch.device("cpu")).shape) == (port.tail_len,)


def test_shard_init_structure():
    """tests/test_halo_fusion.py:178-188: the fused run's raw-input tail
    (A1,) complex64 at its first block, () at the rest; a solo FMDemod keeps
    its unit-sample init."""
    g = ct.chain(ct.resampler(0.4), ct.fm_demodulator(0.6))
    (kind, i0, j, A1) = g._shard_segments()[0]
    assert kind == "fused"
    st = g.shard_init(torch.device("cpu"))
    assert st[i0].shape == (A1,) and st[i0].dtype == torch.complex64 and not st[i0].any()
    assert st[i0 + 1] == ()
    assert torch.equal(st[j + 1], torch.ones(1, dtype=torch.complex64))
    assert g.shard_state_spec(None) == ("rep", (), "rep")


@pytest.mark.parametrize("graph,dt,block,exc,match", [
    (lambda: ct.chain(ct.dc_blocker(), ct.resampler(0.4)), 4, 4 * 1000 + 4, ValueError,
     "must be a multiple of time_shards·granule"),
    (lambda: ct.fir_filter_c_kaiser(4097, 0.1), 4, 4 * 1024, ValueError,
     "shorter than its 4096-sample halo"),
    (lambda: ct.chain(ct.fir_filter_c_kaiser(513, 0.1), ct.fir_filter_c_kaiser(513, 0.12)),
     8, 8 * 512, ValueError, "fused run's 1024-sample context"),
    (lambda: ct.chain(ct.Tee(ct.fir_decimator(4), ct.fir_decimator(2)),
                      ct.Lambda(lambda xy: xy[0] + xy[1][::2], name="combine")),
     2, 2 * 8 * 512, NotImplementedError, "combine: cannot consume a multi-rate tuple"),
    (lambda: ct.chain(ct.dc_blocker(), ct.firpfbch_channelizer(8)), 2, 2 * 8 * 8,
     ValueError, "local segment 64 shorter than the 111-sample polyphase halo"),
    (lambda: ct.chain(ct.PerChannel(ct.fm_demodulator(0.6), 8)), 2, 2 * 256,
     ValueError, r"sharded PerChannel requires channelized \(nch, n\) input layout"),
    (lambda: ct.chain(ct.fm_demodulator(0.6), ct.MixChannels()), 2, 2 * 256,
     ValueError, "mix: mix requires channelized input"),
    (lambda: ct.chain(ct.stereo_fm_decoder(192000.0, 4)), 8, 8 * 64,
     ValueError, "local segment 64 shorter than the largest halo 141"),
], ids=["block_size", "halo", "fused_context", "multirate_combine", "channelizer",
        "perchannel", "mix", "stereo"])
def test_validation_refuses_statically(graph, dt, block, exc, match):
    """tests/test_sharding_generic.py:231-249, :380-390 and
    tests/test_halo_fusion.py:166-175: refused before any collective, with
    the JAX messages' substance: the channelizer's halo, PerChannel and
    MixChannels on a time-layout input, the stereo decoder's largest halo."""
    with pytest.raises(exc, match=match):
        ShardedChain.validate(graph(), dt, 1, block)


def test_validation_matches_jax_local_lengths():
    """The static walk's local output length and layout equal the JAX
    ShardedChain's for the WBFM receiver and the multi-rate Tee."""
    import jax.numpy as jnp
    import csdr_tpu as cs
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain

    for name, shape in (("wbfm", (4, 1)), ("multirate_tee", (2, 2)), ("delay", (2, 1))):
        pg, jg = graph_of(name, ct, torch.float32), graph_of(name, cs, jnp.float32)
        block = block_of(name, pg.granule, shape[0])
        js = JaxChain(jg, _jax_mesh(*shape), block)
        assert ShardedChain.validate(pg, *shape, block) == (js.nloc_out, js.out_layout)


# ---- two processes started as torchrun starts them ----------------------------

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
    graph = ct.chain(ct.dc_blocker(), ct.fm_demodulator(0.6), ct.fir_decimator(4))
    block, nblocks = 1 << 14, 3
    rng = np.random.default_rng(7)
    n = block * nblocks
    msg = np.cumsum(0.3 * np.sin(2 * np.pi * 0.002 * np.arange(n)))
    iq = (np.exp(1j * 2 * np.pi * 0.2 * msg)
          + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    sh = ShardedChain(graph, build_mesh(2, 1, "cpu"), block)
    parts = []
    ShardedPipeline(sh).run(iter([iq]) if rank == 0 else None,
                            parts.append if rank == 0 else None)
    if rank == 0:
        want = []
        ct.Pipeline(graph, block, device="cpu").run(iter([iq]), want.append)
        assert len(parts) == len(want) == nblocks
        err = max(float(np.abs(a - b).max()) for a, b in zip(parts, want))
        assert err < 1e-6, err
    torch.distributed.destroy_process_group()
    print(f"[{rank}] OK: {nblocks} blocks equal to serial", flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_chain_across_two_torchrun_processes(tmp_path):
    """tests/test_multihost.py's scenario: two processes that find their
    rank, world size and rendezvous in the environment torchrun sets
    (``init_distributed()``), 3 blocks of DC blocker → FM → decimator equal
    to the serial Pipeline within 1e-6."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, CSDR_REPO=REPO, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
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
