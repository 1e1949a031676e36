"""The port's ShardedFlagship (K1 time-sharded on torch.distributed) against
the JAX package's ShardedFlagship (the wide Pallas kernel in interpret mode
on the virtual 8-device CPU mesh), on the same numpy-seeded inputs.

The port runs in gloo ranks started by ``parallel.spawn`` (one set per mesh
shape, module-scoped, each set computing every case of its shape), K1's
plain version on the CPU; its ranks import this module, so the JAX side is
imported inside the fixtures only.  Bounds are tests/test_sharded_flagship.py's:
share of |d| > 0.01 under 0.005 and 99th percentile under 1e-4
(:61-66), carried state within 2e-5 (:84-88); at one time rank the step is
the serial kernel bit for bit."""

import concurrent.futures

import numpy as np
import pytest
import torch

from csdr_tpu_torch.ops.cuda import flagship_fused as ff
from csdr_tpu_torch.parallel import ShardedFlagship, ShardedPipeline, build_mesh, spawn
from csdr_tpu_torch.utils.convert import from_jax_flagship_wide_state

NCH = 64

# name → (time ranks, JAX tileF, block, blocks, wire, dc_alpha, DC window
# or None, force_full)
CASES = {
    "f32_dt2": (2, 256, 2 * NCH * 256, 3, "f32", 0.0005, None, False),
    "f32_dt4": (4, 256, 4 * NCH * 256, 3, "f32", 0.0005, None, False),
    "u8_dt4": (4, 256, 4 * NCH * 256, 2, "u8", 0.0005, None, False),
    # several K1 tiles per rank: 16 at the port's tileF of 32
    "multitile_dt2": (2, 128, 2 * NCH * 128 * 4, 2, "f32", 0.0005, None, False),
    # the truncated suffix window: W = 4096 < nloc = 8192, with dc_alpha 0.02
    # keeping a^W = 0.98^4096 ≈ 1e-36 as far below float32 as production's
    "window_dt2": (2, 128, 2 * NCH * 128, 2, "f32", 0.02, 4096, False),
    "force_full_dt1": (1, 256, NCH * 256, 2, "f32", 0.0005, None, True),
    "serial_dt1": (1, 256, NCH * 256, 2, "f32", 0.0005, None, False),
}


def _signal(n, seed):
    """tests/test_sharded_flagship.py:25-31."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (0.3 * np.exp(2j * np.pi * np.mod(0.213 * t, 1.0))
         + 0.25 * np.exp(2j * np.pi * np.mod(-0.087 * t, 1.0))
         + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    return x.astype(np.complex64)


def _input(name):
    """(complex64 stream, cu8 (n, 2) rows or None) of a case."""
    dt, _, block, blocks, wire, *_ = CASES[name]
    iq = _signal(blocks * block, seed=3 + sorted(CASES).index(name))
    if wire == "f32":
        return iq, None
    rows = np.stack([iq.real, iq.imag], 1) * 127.5 + 127.5
    return iq, np.clip(np.round(rows), 0, 255).astype(np.uint8)


def _rank(device, dt, names):
    """One gloo rank: every case of this time-axis size through
    ShardedPipeline; rank 0 returns each case's audio and carried state."""
    from csdr_tpu_torch.parallel import flagship as fmod

    torch.set_num_threads(1)
    mesh = build_mesh(dt, 1, "cpu")
    out = {}
    for name in names:
        _, _, block, _, wire, alpha, window, force_full = CASES[name]
        fmod._DC_WINDOW = window or (1 << 17)
        sf = ShardedFlagship(mesh, nch=NCH, block_size=block, dc_alpha=alpha,
                             force_full=force_full)
        iq, rows = _input(name)
        pipe = ShardedPipeline(sf)
        parts = []
        pipe.run(iter([iq if rows is None else rows]), parts.append)
        if wire == "u8":
            # the (re, im) plane pair, the JAX test's wire, stepped directly
            nloc = block // dt
            st, planes = sf.init(), []
            for b in range(len(rows) // block):
                seg = rows[b * block + sf.ctx.ti * nloc:][:nloc]
                st, y = sf.step(st, (torch.from_numpy(seg[:, 0].copy()),
                                     torch.from_numpy(seg[:, 1].copy())))
                planes.append(y.numpy())
            out[name + "_planes"] = np.concatenate(planes, axis=1)
        if sf.ctx.ti == 0:
            out[name] = (np.concatenate(parts, axis=1) if parts else None,
                         {k: v.numpy() for k, v in pipe.state.items()}, sf.W)
    if dt == 2:
        out["rejects"] = {}
        for case, (m, nch, block) in {
                "nch_not_dividing_64": (mesh, 48, 2 * 48 * 256),
                "segment_off_granule": (mesh, 64, 2 * 64 * 8),
                "channel_axis": (build_mesh(1, 2, "cpu"), 64, 64 * 2048)}.items():
            try:
                ShardedFlagship(m, nch=nch, block_size=block)
                out["rejects"][case] = None
            except (ValueError, NotImplementedError) as e:
                out["rejects"][case] = type(e).__name__
    return out


def _port_runs():
    """Case name → (audio, state, W) of rank 0, the u8 case's planes run of
    every rank and the rejections; one spawn per time-axis size."""
    res = {}
    for dt in (1, 2, 4):
        names = [k for k, c in CASES.items() if c[0] == dt]
        ranks = spawn(_rank, dt, "cpu", args=(dt, names), timeout=240.0)
        res.update(ranks[0])
        res.update({f"{k}_rank{r}": v for r, got in enumerate(ranks) for k, v in got.items()
                    if k.endswith("_planes")})
    return res


@pytest.fixture(scope="module")
def runs():
    """(port results, JAX results): the port's ranks run in a thread while
    this process computes the JAX side."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs)
        jax_res = _jax_runs()
        return port.result(), jax_res


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


def _jax_runs():
    """Case name → (audio blocks, final state, state after the first block)
    of the JAX ShardedFlagship."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from csdr_tpu.parallel import flagship as jfmod

    out = {}
    saved = jfmod._DC_WINDOW
    try:
        for name, (dt, tileF, block, blocks, wire, alpha, window, _) in CASES.items():
            if name == "serial_dt1":
                continue
            jfmod._DC_WINDOW = window or saved
            mesh = Mesh(np.asarray(jax.devices()[:dt]), ("time",))
            sf = jfmod.ShardedFlagship(mesh, nch=NCH, block_size=block, tileF=tileF,
                                       dc_alpha=alpha, interpret=True)
            iq, rows = _input(name)
            st, ys, first = sf.init(), [], None
            for b in range(blocks):
                if rows is None:
                    blk = iq[b * block:(b + 1) * block]
                    x = (jnp.asarray(blk.real.astype(np.float32)),
                         jnp.asarray(blk.imag.astype(np.float32)))
                else:
                    x = tuple(jnp.asarray(rows[b * block:(b + 1) * block, i].copy())
                              for i in (0, 1))
                st, y = sf.step(st, x)
                ys.append(np.asarray(y))
                if b == 0:
                    first = jax.tree.map(np.asarray, st)
            out[name] = (ys, jax.tree.map(np.asarray, st), first)
    finally:
        jfmod._DC_WINDOW = saved
    return out


def _assert_close(got, want, ctx):
    d = np.abs(got - want)
    assert float(np.mean(d > 0.01)) < 0.005, (ctx, float(np.mean(d > 0.01)))
    assert float(np.quantile(d, 0.99)) < 1e-4, (ctx, float(np.quantile(d, 0.99)))


@pytest.mark.parametrize("name", [k for k in CASES if k != "serial_dt1"])
def test_sharded_matches_jax(port, jax_runs, name):
    dt, _, block, blocks, *_ = CASES[name]
    got, state, W = port[name]
    want_blocks, want_state, _ = jax_runs[name]
    assert got.shape == (NCH, blocks * block // NCH)
    if name == "window_dt2":
        assert W == 4096 < block // dt  # the truncated branch ran
    F = block // NCH
    for b, want in enumerate(want_blocks):
        _assert_close(got[:, b * F:(b + 1) * F], want, (name, "block", b))
    # the carried state against JAX's, its wide hist mapped to K1's
    want = from_jax_flagship_wide_state(want_state, NCH, torch.device("cpu"))
    for k in ("hist", "x_last", "y_dc_last"):
        err = float(np.max(np.abs(state[k] - want[k].numpy())))
        assert err < 2e-5, (name, k, err)
    assert abs(float(state["phase"]) - float(want["phase"])) < 1e-5


@pytest.mark.parametrize("name", ["serial_dt1", "force_full_dt1"])
def test_one_time_rank_matches_serial_kernel(port, name):
    """At one time rank the step delegates to the serial K1 (bit for bit);
    force_full runs the pre-pass and collectives and stays within the
    carry-reconstruction bounds (here the arithmetic is the same, so it is
    bit-equal too)."""
    _, _, block, blocks, *_ = CASES[name]
    iq, _ = _input(name)
    st = ff.flagship_fused_init(NCH, torch.device("cpu"))
    want = []
    for b in range(blocks):
        st, y = ff.flagship_fused_step(st, torch.from_numpy(iq[b * block:(b + 1) * block]),
                                       nch=NCH)
        want.append(y.numpy())
    want = np.concatenate(want, axis=1)
    got, state, _ = port[name]
    if name == "serial_dt1":
        assert np.array_equal(got, want)
        for k, v in st.items():
            assert np.array_equal(state[k], v.numpy()), k
    else:
        _assert_close(got, want, name)
        for k, v in st.items():
            assert float(np.max(np.abs(state[k] - v.numpy()))) < 2e-5, k


@pytest.mark.parametrize("rank", range(4))
def test_u8_planes_equal_rows(port, rank):
    """cu8 as a (re, im) plane pair gives each rank the audio the runner's
    (n, 2) rows give it."""
    got = port[f"u8_dt4_planes_rank{rank}"]
    rows, _, _ = port["u8_dt4"]
    nloc_f = CASES["u8_dt4"][2] // 4 // NCH
    F = CASES["u8_dt4"][2] // NCH
    want = np.concatenate([rows[:, b * F + rank * nloc_f:][:, :nloc_f]
                           for b in range(CASES["u8_dt4"][3])], axis=1)
    assert np.array_equal(got, want)


def test_jax_wide_state_hands_over_to_k1(jax_runs):
    """One block in JAX, its carried state converted, the second block on
    the port's serial K1 against JAX's second block."""
    _, _, block, *_ = CASES["f32_dt2"]
    ys, _, first = jax_runs["f32_dt2"]
    iq, _ = _input("f32_dt2")
    st = from_jax_flagship_wide_state(first, NCH, torch.device("cpu"))
    _, y = ff.flagship_fused_step(st, torch.from_numpy(iq[block:2 * block]), nch=NCH)
    _assert_close(y.numpy(), ys[1], "hand-over")


@pytest.mark.parametrize("case", ["nch_not_dividing_64", "segment_off_granule",
                                  "channel_axis"])
def test_rejects_bad_configs(port, case):
    """Raised on every rank of a real mesh: nch ∤ 64, a segment that is not
    a multiple of nch·tileF, and a 'ch' dimension of size 2."""
    want = {"nch_not_dividing_64": "ValueError", "segment_off_granule": "ValueError",
            "channel_axis": "NotImplementedError"}[case]
    assert port["rejects"][case] == want
