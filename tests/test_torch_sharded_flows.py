"""The shard methods of the stereo, RDS, GMSK, AFSK and symbol-sync blocks
(parallel/generic.ShardedChain) on torch.distributed, against the port's
serial graph and the JAX ShardedChain on the virtual 8-device CPU mesh: the
cases of tests/test_sharding_generic.py:248-358 (stereo over time, its
rejections, GMSK bit for bit, fm_dem_with_sync, the tiny sync block),
tests/test_rds.py:115 (the RDS receiver bit for bit, and its bit slicer on a
bit phase that moves within the block), tests/test_aprs.py:59
and tests/test_rtty.py:43 (the AFSK discriminator), the stereo + RDS Tee of
the CLI's DeFMS --rds with its decoded fields, PerChannel(fm_dem_with_sync)
in the channel layout on (2, 2), a JAX state handed over mid-stream, and
``ShardCtx.sum_time`` against numpy.

The port runs in gloo ranks started by ``parallel.spawn``: one set per mesh
shape, module-scoped, rank 0 collecting every case of its shape through
``ShardedPipeline`` (the runner's gather per leaf layout), in a thread while
this process computes the JAX side.  The ranks import this module, so the
JAX package is imported inside the fixtures and tests only.  Bounds: stereo
and AFSK 2e-3 relative to the largest output (tests/test_sharding_generic.py:60,
:274); the sync 2e-3 of either pick (``torch_oracles.record_ties``,
tests/test_sharding_generic.py:346); GMSK and RDS bits equal."""

import concurrent.futures

import numpy as np
import pytest
import torch

import csdr_tpu_torch as ct
from csdr_tpu_torch.blocks.gmsk import gmsk_demodulator, gmsk_mod
from csdr_tpu_torch.models import aprs, rds, rtty
from csdr_tpu_torch.parallel import ShardedChain, ShardedPipeline, build_mesh, spawn
from csdr_tpu_torch.utils.convert import from_jax_sharded_chain_state

torch.set_num_threads(1)

QUAD, DECIM = 192000.0, 4
RDS_PI, RDS_PS = 0x52D4, "CSDR-TPU"
TOL = 2e-3
SYNC_K, SYNC_NCH, SYNC_CH_K = 10, 4, 4
APRS_FS, RTTY_FS = 48000.0, 8000.0


def mpx(n, phi=0.7, with_rds=False):
    """The stereo composite of tests/test_sharding_generic.py:264 (L 800 Hz,
    R 2500 Hz, pilot, L−R on 38 kHz) and, ``with_rds``, the RDS biphase of
    tests/test_rds.py:43 on 57 kHz carrying groups 0A of RDS_PI/RDS_PS."""
    t = np.arange(n) / QUAD
    left = 0.8 * np.sin(2 * np.pi * 800.0 * t)
    right = 0.8 * np.sin(2 * np.pi * 2500.0 * t)
    pil = 2 * np.pi * 19000.0 * t + phi
    x = 0.45 * (left + right) + 0.1 * np.cos(pil) + 0.45 * (left - right) * np.cos(2 * pil)
    if with_rds:
        groups = [rds.make_group_0a(RDS_PI, s, RDS_PS[2 * s:2 * s + 2]) for s in range(4)]
        tx = rds.bits_from_groups(groups)
        bit = np.floor(t * rds.RDS_BAUD).astype(np.int64) % len(tx)
        half = np.floor(t * 2 * rds.RDS_BAUD).astype(np.int64) % 2
        x = x + 0.12 * (tx[bit] * 2.0 - 1.0) * np.where(half == 0, 1.0, -1.0) * np.cos(3 * pil)
    return x.astype(np.float32)


def fsk(k, nsym, seed):
    """2-FSK at the DeNBFMSync deviation (tests/test_sharding_generic.py:327)."""
    bits = np.random.default_rng(seed).integers(0, 2, nsym)
    return np.exp(1j * 2 * np.pi * np.cumsum(np.repeat((bits * 2 - 1) * 0.02 * k * 0.5, k))
                  ).astype(np.complex64)


def fsk_channels(nch, k, n, seed):
    """nch channels of 2-FSK, one per channel centre of an nch-way split
    (each with its own start and symbol phase), over light noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for c in range(nch):
        bits = rng.integers(0, 2, n // (k * nch) + 2)
        d = int(rng.integers(0, k * nch))
        lv = np.repeat(bits * 2.0 - 1.0, k * nch)[d:d + n]
        fc = (c - (nch - 1) / 2) / nch
        cyc = np.cumsum(lv * 0.02 * k * 0.5 / nch) + fc * t + rng.uniform()
        x = x + 0.3 * np.exp(2j * np.pi * np.mod(cyc, 1.0))
    return x.astype(np.complex64)


def rds_phase_split(n, block=8192, seed=3):
    """An RDS biphase baseband at 19 kHz whose bit phase moves within every
    block: phase 3 at full level in each block's first half, phase 11 at
    half level in its second half.  The block's one phase is 3; a time rank
    holding only a second half would pick 11 from its own energies, so the
    bits equal serial's only where the energies are summed over the ranks."""
    k = rds.SAMPLES_PER_BIT
    bits = np.random.default_rng(seed).integers(0, 2, n // k + 2) * 2.0 - 1.0
    wave = np.repeat(bits, k) * np.tile(np.repeat([1.0, -1.0], k // 2), len(bits))
    t = np.arange(n)
    first = (t % block) < block // 2
    x = np.where(first, np.roll(wave, 3)[:n], 0.5 * np.roll(wave, 11)[:n])
    return (x + 0.05 * np.random.default_rng(seed + 1).normal(size=n)).astype(np.float32)


def afsk_audio():
    frame = aprs.make_ax25_ui("N0CALL", "APRS", "sharded")
    levels = np.concatenate([np.ones(96, np.uint8), aprs.aprs_burst_bits(frame),
                             np.ones(96, np.uint8)])
    return aprs.afsk_modulate(levels, APRS_FS).astype(np.float32)


def _models(pkg):
    import importlib

    return {m: importlib.import_module(f"{pkg.__name__}.models.{m}")
            for m in ("stereo", "rds", "aprs", "rtty", "symsync")}


def graph_of(name, pkg):
    """The case's graph built from ``pkg`` (csdr_tpu_torch or csdr_tpu)."""
    import importlib

    m = _models(pkg)
    gmsk = importlib.import_module(f"{pkg.__name__}.blocks.gmsk")
    if name == "stereo":
        return pkg.chain(m["stereo"].stereo_fm_decoder(QUAD, DECIM))
    if name == "stereo_rds":
        return pkg.chain(pkg.Tee(m["stereo"].stereo_fm_decoder(QUAD, DECIM),
                                 m["rds"].rds_receiver(QUAD)))
    if name == "rds_slicer":
        return pkg.chain(m["rds"].RDSBitSlicer())
    if name == "gmsk":
        return pkg.chain(gmsk.gmsk_demodulator(3, 4))
    if name == "afsk":
        return m["aprs"].afsk1200_receiver(APRS_FS)
    if name == "rtty":
        return m["rtty"].rtty_receiver(RTTY_FS)
    if name == "sync":
        return pkg.chain(m["symsync"].fm_dem_with_sync(SYNC_K))
    if name == "perchannel_sync":
        return pkg.chain(pkg.firpfbch_channelizer(SYNC_NCH),
                         pkg.PerChannel(m["symsync"].fm_dem_with_sync(SYNC_CH_K), SYNC_NCH))
    raise KeyError(name)


# case → (mesh shapes, block at the largest dt, blocks, input maker)
CASES = {
    "stereo": ([(2, 1), (4, 1)], 1 << 14, 2, lambda n: mpx(n)),
    "stereo_rds": ([(2, 1)], 10 * 3072, 8, lambda n: mpx(n, with_rds=True)),
    "rds_slicer": ([(2, 1)], 8192, 2, lambda n: rds_phase_split(n)),
    "gmsk": ([(2, 1), (4, 1)], 8192, 2,
             lambda n: gmsk_mod(np.random.default_rng(5).integers(0, 2, n // 4), 4, 3)),
    "afsk": ([(2, 1)], 8192, 2, lambda n: np.resize(afsk_audio(), n)),
    "rtty": ([(2, 1)], 176 * 2 * 16, 2,
             lambda n: np.resize(rtty.rtty_modulate("MESH 1", RTTY_FS), n).astype(np.float32)),
    "sync": ([(2, 1), (4, 1)], 20480, 2, lambda n: fsk(SYNC_K, n // SYNC_K, 4)),
    "perchannel_sync": ([(2, 2)], SYNC_NCH * 4096, 2,
                        lambda n: fsk_channels(SYNC_NCH, SYNC_CH_K, n, 6)),
}
SHAPES = [(2, 1), (4, 1), (2, 2)]
SYNC_CASES = ("sync", "perchannel_sync")
HANDOVER = "stereo_rds"     # the JAX state after its block 0, on (2, 1)


def case_input(name):
    _, block, nblocks, make = CASES[name]
    return make(block * nblocks)


def _to_np(y):
    return tuple(_to_np(t) for t in y) if isinstance(y, tuple) else np.asarray(y)


def _rank(device, shape, inputs, handover):
    """One gloo rank: every case of this mesh shape through ShardedPipeline
    (rank 0 returns the gathered outputs per block); ``sum_time`` of a
    rank-dependent vector; and where ``handover`` holds a converted JAX
    state, the Tee's block 1 stepped from it (every rank returns its own
    output)."""
    torch.set_num_threads(1)
    dt, dc = shape
    mesh = build_mesh(dt, dc, "cpu")
    rank = torch.distributed.get_rank()
    out = {}
    for name, x in inputs.items():
        block = CASES[name][1]
        runner = ShardedPipeline(ShardedChain(graph_of(name, ct), mesh, block))
        out[name] = [y for y in runner.stream(iter([x]) if rank == 0 else None)]
    sh = ShardedChain(graph_of("gmsk", ct), mesh, 8192)
    v = torch.arange(16, dtype=torch.float32) * (rank + 1) + 0.25 * rank
    out["sum_time"] = (v.numpy(), sh.ctx.sum_time(v).numpy())
    if handover is not None:
        block = CASES[HANDOVER][1]
        nloc = block // dt
        sh = ShardedChain(graph_of(HANDOVER, ct), mesh, block)
        x = inputs[HANDOVER]
        _, y = sh.step(handover, torch.from_numpy(x[block + (rank // dc) * nloc:][:nloc].copy()))
        out["handover"] = _to_np(y)
    return out


def _port_runs(inputs, handover):
    res = {}
    for shape in SHAPES:
        names = [n for n in CASES if shape in CASES[n][0]]
        res[shape] = spawn(_rank, shape[0] * shape[1], "cpu",
                           args=(shape, {n: inputs[n] for n in names},
                                 handover if shape == (2, 1) else None), timeout=300.0)
    return res


def _jax_run(name, shape, keep_first=False):
    """The JAX ShardedChain over the case's blocks: numpy outputs per block,
    and (``keep_first``) the state after block 0."""
    import jax
    from jax.sharding import Mesh

    import csdr_tpu as cs
    from csdr_tpu.core.runtime import decode_tree_host
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain

    dt, dc = shape
    mesh = Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc), ("time", "ch"))
    _, block, nblocks, _ = CASES[name]
    x = case_input(name)
    sh = JaxChain(graph_of(name, cs), mesh, block)
    st, ys, first = sh.init(), [], None
    for b in range(nblocks):
        st, y = sh.step(st, x[b * block:(b + 1) * block])
        ys.append(_to_np(decode_tree_host(y)))
        if b == 0 and keep_first:
            first = jax.tree.map(np.asarray, st)
    return ys, first


def _serial(name):
    """The port's serial graph over the case's blocks: (outputs, and for the
    sync cases the outputs of the other pick, ``record_ties``)."""
    from torch_oracles import record_ties

    _, block, nblocks, _ = CASES[name]
    g = graph_of(name, ct)
    x = case_input(name)
    st, ys, others = g.init(torch.device("cpu")), [], []
    for b in range(nblocks):
        with record_ties() as rec:
            st, y = g.apply(st, torch.from_numpy(x[b * block:(b + 1) * block].copy()))
        ys.append(_to_np(y))
        if rec:
            others.append(rec[0][1])
    return ys, others


@pytest.fixture(scope="module")
def runs():
    """(port rank outputs per shape, JAX outputs per (case, shape), serial
    port outputs per case): the JAX Tee on (2, 1) first (its state after
    block 0 is handed over), then the port's ranks in a thread while the
    other JAX cases and the serial port graphs run here."""
    inputs = {n: case_input(n) for n in CASES}
    jax_out = {}
    jax_out[(HANDOVER, (2, 1))], first = _jax_run(HANDOVER, (2, 1), keep_first=True)
    handover = from_jax_sharded_chain_state(first, torch.device("cpu"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, inputs, handover)
        for name, (shapes, _, _, _) in CASES.items():
            for shape in shapes:
                if (name, shape) not in jax_out:
                    jax_out[(name, shape)] = _jax_run(name, shape)[0]
        serial = {n: _serial(n) for n in CASES}
        port_out = port.result()
    return port_out, jax_out, serial


def _leaves(t):
    return [a for p in t for a in _leaves(p)] if isinstance(t, tuple) else [t]


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.complex128) - want).max()
                 / (np.abs(want).max() + 1e-12))


def _either(got, other, want):
    """``want`` against ``got`` or the other pick, relative to want's
    largest output (tests/test_torch_symsync.py)."""
    got, other, want = (np.asarray(a, np.float64) for a in (got, other, want))
    err = np.minimum(np.abs(got - want), np.abs(other - want)) / (np.abs(want).max() + 1e-12)
    return float(err.max())


PAIRS = [(n, s) for n in CASES for s in CASES[n][0]]


@pytest.mark.parametrize("name,shape", PAIRS, ids=[f"{n}-{s[0]}x{s[1]}" for n, s in PAIRS])
def test_sharded_flow_matches_serial_and_jax(runs, name, shape):
    """Each block's output of the port's ShardedChain (gathered by the
    runner, leaf by leaf) against the port's serial graph and the JAX
    ShardedChain on the same mesh."""
    port, jax_out, serial = runs
    got = port[shape][0][name]
    want, others = serial[name]
    jys = jax_out[(name, shape)]
    assert len(got) == len(want) == len(jys) == CASES[name][2]
    for b, (g, w, j) in enumerate(zip(got, want, jys)):
        gl, wl, jl = _leaves(g), _leaves(w), _leaves(j)
        assert [a.shape for a in gl] == [a.shape for a in wl] == [a.shape for a in jl], b
        for i, (ga, wa, ja) in enumerate(zip(gl, wl, jl)):
            if ga.dtype == np.uint8:          # GMSK and RDS bits
                assert np.array_equal(ga, wa) and np.array_equal(ga, ja.astype(np.uint8)), \
                    (name, b, i, int((ga != wa).sum()), int((ga != ja).sum()))
            elif name in SYNC_CASES:
                assert _either(wa, others[b], ga) < TOL, (name, b, "vs serial")
                assert _either(wa, others[b], ja) < TOL, (name, b, "JAX vs serial")
            else:
                assert _rel(ga, wa) < TOL, (name, b, i, _rel(ga, wa))
                assert _rel(ga, ja) < TOL, (name, b, i, _rel(ga, ja))


def test_stereo_rds_tee_decodes_the_serial_fields(runs):
    """The DeFMS --rds Tee at dt = 2: the stereo panel gathered to (2,
    dt·frames) per block, and the RDS fields decoded from the sharded bits
    equal the serial ones (PI, PS, the group count)."""
    port, _, serial = runs
    got = port[(2, 1)][0]["stereo_rds"]
    block = CASES["stereo_rds"][1]
    assert all(y[0].shape == (2, block // DECIM) for y in got)
    bits = np.concatenate([y[1] for y in got])
    want = np.concatenate([y[1] for y in serial["stereo_rds"][0]])
    info, info_serial = rds.decode_groups(bits), rds.decode_groups(want)
    assert info == info_serial
    assert info["pi"] == RDS_PI and info["ps"] == RDS_PS and info["groups"] >= 4


def test_jax_state_hands_over_mid_stream(runs):
    """The JAX ShardedChain state of the stereo + RDS Tee after block 0 (its
    dicts, CEnc leaves and the uint32 raw bit) through
    ``from_jax_sharded_chain_state``: the port's ranks step block 1 from it
    and match the JAX block 1."""
    port, jax_out, _ = runs
    ranks = port[(2, 1)]
    stereo = np.concatenate([r["handover"][0] for r in ranks], axis=-1)
    bits = np.concatenate([r["handover"][1] for r in ranks])
    j_stereo, j_bits = jax_out[(HANDOVER, (2, 1))][1]
    assert _rel(stereo, j_stereo) < TOL
    assert np.array_equal(bits, j_bits.astype(np.uint8))


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[0]}x{s[1]}" for s in SHAPES])
def test_sum_time_against_numpy(runs, shape):
    """``ShardCtx.sum_time``: Σ over the time ranks of each rank's vector, on
    every rank (the ch ranks sum their own time groups)."""
    ranks = runs[0][shape]
    dt, dc = shape
    for r, res in enumerate(ranks):
        mine = [ranks[t * dc + r % dc]["sum_time"][0] for t in range(dt)]
        np.testing.assert_allclose(res["sum_time"][1], np.sum(mine, axis=0), rtol=1e-6)


@pytest.mark.parametrize("graph,dt,dc,block,exc,match", [
    (lambda pkg: pkg.chain(_models(pkg)["stereo"].stereo_fm_decoder(QUAD, DECIM)), 2, 2,
     1 << 16, ValueError, "time only"),
    (lambda pkg: pkg.chain(_models(pkg)["stereo"].stereo_fm_decoder(QUAD, DECIM)), 8, 1,
     8 * 64, ValueError, "shorter than the largest halo"),
    (lambda pkg: pkg.chain(_models(pkg)["symsync"].sym_sync_r(4, 4, 0.0, 64)), 8, 1,
     8 * 4 * 8, ValueError, "sub-windows|halo|multiple"),
    (lambda pkg: pkg.chain(pkg.blocks.gmsk.gmsk_demodulator(3, 4)), 4, 1, 4 * 8, ValueError,
     "matched-filter halo"),
], ids=["stereo_dc2", "stereo_halo", "tiny_sync", "gmsk_halo"])
def test_rejections_match_jax(graph, dt, dc, block, exc, match):
    """tests/test_sharding_generic.py:293-303, :349-358: refused statically,
    with the JAX messages' substance, by both packages."""
    import jax
    from jax.sharding import Mesh

    import csdr_tpu as cs
    import csdr_tpu.blocks.gmsk  # noqa: F401
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain

    import csdr_tpu_torch.blocks.gmsk  # noqa: F401

    with pytest.raises(exc, match=match):
        ShardedChain.validate(graph(ct), dt, dc, block)
    mesh = Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc), ("time", "ch"))
    with pytest.raises(exc, match=match):
        JaxChain(graph(cs), mesh, block)


def test_static_local_lengths_equal_jax():
    """The static walk's local output length per leaf equals the JAX
    ShardedChain's for every case on its first mesh."""
    import jax
    from jax.sharding import Mesh

    import csdr_tpu as cs
    from csdr_tpu.parallel.generic import ShardedChain as JaxChain

    for name, (shapes, block, _, _) in CASES.items():
        dt, dc = shapes[0]
        nloc, _ = ShardedChain.validate(graph_of(name, ct), dt, dc, block)
        mesh = Mesh(np.asarray(jax.devices()[:dt * dc]).reshape(dt, dc), ("time", "ch"))
        want = JaxChain(graph_of(name, cs), mesh, block).nloc_out
        assert nloc == want, (name, nloc, want)


def test_gmsk_bits_decode_a_message_sharded():
    """GMSK's uint8 bits of a known sequence, through one 2x1 mesh run in
    ``ShardedPipeline``: after the filter's delay the bits are the sent
    ones (the sharded demod keeps the symbol grid)."""
    bits = np.random.default_rng(9).integers(0, 2, 4096).astype(np.uint8)
    x = gmsk_mod(bits, 4, 3)
    got = np.concatenate(spawn(_gmsk_rank, 2, "cpu", args=(x,), timeout=120.0)[0])
    serial = ct.CollectSink()
    ct.Pipeline(ct.chain(gmsk_demodulator(3, 4)), block_size=8192, device="cpu").run(
        iter([x]), serial)
    assert got.dtype == np.uint8 and np.array_equal(got, serial.concat()[:len(got)])
    assert np.mean(got[6:len(bits)] == bits[:len(got[6:len(bits)])]) > 0.99


def _gmsk_rank(device, x):
    mesh = build_mesh(2, 1, "cpu")
    runner = ShardedPipeline(ShardedChain(ct.chain(gmsk_demodulator(3, 4)), mesh, 8192))
    rank = torch.distributed.get_rank()
    return [y for y in runner.stream(iter([x]) if rank == 0 else None) if y is not None]
