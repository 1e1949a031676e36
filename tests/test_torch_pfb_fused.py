"""The port's PFB kernels K3/K4 (``ops/cuda/pfb_fused.py``) against the JAX
package's ``ops/pallas/pfb_fused.py``, run in interpret mode on the CPU.

On a CPU tensor ``pfb_fm_fused`` / ``pfb_channelize_fused`` run their plain
versions, the arithmetic the CUDA kernel implements; the kernel itself is
held to them on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances, each with its source:
  * vs the JAX kernels (bf16x3 DFT split, polynomial atan2): 2e-3 max
    (tests/test_pallas_fused.py:55, tests/test_pfb_channelize_fused.py:39),
    frame 0 included — both start from zero history;
  * vs the eager graph, frames >= 1 (frame 0's demod seed differs by
    design): 2e-3 max (tests/test_pallas_fused.py:55);
  * K4 vs the eager channelizer on the CPU, and state carried across: the
    same float32 ops in the same order, 2e-5 max-rel (tests/test_golden.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csdr_tpu.models.receivers import channelized_fm_receiver as jax_receiver
from csdr_tpu.ops.pallas import pfb_fused as jpf
from csdr_tpu.ops.pfb import pfb_dft_matrix, pfb_taps

import csdr_tpu_torch as ct
from csdr_tpu_torch.blocks.fused_blocks import PFBFusedChannelizer, PFBFusedFM
from csdr_tpu_torch.ops.cuda import pfb_fused as pf
from csdr_tpu_torch.utils.convert import from_jax_pfb_fm_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
M, L = 7, 14


def occupied_band(nch, n, seed):
    """One FM carrier on every channel centre plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.zeros(n, np.complex128)
    for k in range(nch):
        fc = (k - (nch - 1) / 2) / nch
        fm = 0.002 * (1 + k % 5)
        ph = 2 * np.pi * np.mod(fc * t, 1.0) + 2.0 * np.sin(2 * np.pi * fm * t)
        x += 0.6 / np.sqrt(nch) * np.exp(1j * (ph + rng.uniform(0, 2 * np.pi)))
    x += 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return x.astype(np.complex64)


def panels(nch, F, H, seed):
    """(F + H, nch) frame-reversed panels of an occupied band, as numpy."""
    xs = occupied_band(nch, (F + H) * nch, seed)
    return xs.reshape(F + H, nch)[:, ::-1].copy()


def jax_operands(vfull, nch, cols):
    W = pfb_dft_matrix(nch)[:, cols]
    return (jnp.asarray(vfull.real.copy()), jnp.asarray(vfull.imag.copy()),
            jnp.asarray(pfb_taps(nch, M)), jnp.asarray(W.real.astype(np.float32)),
            jnp.asarray(W.imag.astype(np.float32)))


def port_operands(vfull, nch, cols):
    taps, W = pf.pfb_design(nch, M, 80.0, CPU)
    return torch.from_numpy(vfull), taps, W[:, cols]


@pytest.mark.parametrize("nch,tileF,shard", [(8, 64, False), (16, 32, False), (16, 32, True)])
def test_k3_plain_matches_jax_kernel(nch, tileF, shard):
    F = tileF * 4
    vfull = panels(nch, F, L, seed=nch)
    cols = slice(nch // 2, nch) if shard else slice(0, nch)
    want = jpf.pfb_fm_fused(*jax_operands(vfull, nch, cols), nch=nch, L=L, tileF=tileF,
                            kf=0.6, interpret=True)
    got = pf.pfb_fm_fused(*port_operands(vfull, nch, cols), nch=nch, L=L, tileF=tileF, kf=0.6)
    assert got.shape == (want.shape[1], F) == (len(range(nch)[cols]), F)
    assert np.max(np.abs(got.numpy() - np.asarray(want).T)) < 2e-3


@pytest.mark.parametrize("nch,tileF,shard", [(8, 64, False), (16, 32, True)])
def test_k4_plain_matches_jax_kernel(nch, tileF, shard):
    F = tileF * 4
    vfull = panels(nch, F, L - 1, seed=nch + 1)
    cols = slice(0, nch // 2) if shard else slice(0, nch)
    dre, dim = jpf.pfb_channelize_fused(*jax_operands(vfull, nch, cols), nch=nch, L=L,
                                        tileF=tileF, interpret=True)
    want = (np.asarray(dre) + 1j * np.asarray(dim)).T
    got = pf.pfb_channelize_fused(*port_operands(vfull, nch, cols), nch=nch, L=L,
                                  tileF=tileF)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) < 2e-3


def test_streaming_step_matches_jax_step():
    """Two state-chained blocks of the K3 step against the JAX step; the
    carried state too."""
    nch, tileF = 8, 64
    x = occupied_band(nch, nch * tileF * 4, seed=3)
    js = jpf.channelized_fm_pallas_init(nch)
    ts = pf.channelized_fm_pfb_init(nch, CPU)
    for blk in np.split(x, 2):
        js, jy = jpf.channelized_fm_pallas_step(js, jnp.asarray(blk), nch=nch, tileF=tileF,
                                                interpret=True)
        ts, ty = pf.channelized_fm_pfb_step(ts, torch.from_numpy(blk), nch=nch, tileF=tileF)
        assert ty.shape == jy.shape == (nch, len(blk) // nch)
        assert np.max(np.abs(ty.numpy() - np.asarray(jy))) < 2e-3
    for j, t in zip(js, ts):
        assert t.shape == j.shape and t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_receiver_matches_jax_pallas_backend(monkeypatch):
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")
    nch = 8
    x = occupied_band(nch, nch * 64 * 4, seed=4)
    jg = jax_receiver(nch, kf=0.6, backend="pallas", tileF=64)
    tg = ct.channelized_fm_receiver(nch, kf=0.6, backend="pfb_fused")
    assert tg.granule == jg.granule == nch * 64
    js, ts = jg.init(), tg.init(CPU)
    for blk in np.split(x, 2):
        js, jy = jg.apply(js, jnp.asarray(blk))
        ts, ty = tg.apply(ts, torch.from_numpy(blk))
        assert np.max(np.abs(ty.numpy() - np.asarray(jy))) < 2e-3


@pytest.mark.parametrize("nch", [8, 20])
def test_receiver_matches_eager_graph(nch):
    """dc_blocker >> PFBFusedFM through the Pipeline, a short last block
    included, against the eager graph from frame 1."""
    n = nch * 64 * 5 + 3 * nch
    x = occupied_band(nch, n, seed=nch + 5)
    outs = {}
    for backend in ("pfb_fused", "eager"):
        sink = ct.CollectSink()
        g = ct.channelized_fm_receiver(nch, backend=backend)
        assert ct.Pipeline(g, nch * 128, device=CPU).run(iter([x]), sink) == n // nch
        outs[backend] = sink.concat()
    assert outs["pfb_fused"].shape == (nch, n // nch)
    assert np.max(np.abs(outs["pfb_fused"][:, 1:] - outs["eager"][:, 1:])) < 2e-3


def test_fused_channelizer_shares_the_eager_state():
    """K4's channelizer block takes over the eager PFBChannelizer's state
    mid-stream, and hands it back."""
    nch = 8
    x = occupied_band(nch, nch * 64 * 3, seed=6)
    blocks = [torch.from_numpy(b) for b in np.split(x, 3)]
    eager = ct.firpfbch_channelizer(nch)
    fused = PFBFusedChannelizer(nch)
    assert fused.rate == eager.rate and fused.granule == nch * pf.DEFAULT_TILE_F
    se, want = eager.init(CPU), []
    for b in blocks:
        se, y = eager.apply(se, b)
        want.append(y)
    s, got = eager.init(CPU), []
    for b, blk in zip(blocks, (eager, fused, eager)):
        s, y = blk.apply(s, b)
        got.append(y)
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        err = (g - w).abs().max().item() / w.abs().max().item()
        assert err < 2e-5


def test_state_handoff_from_jax_pallas_step():
    """JAX runs block 1; its state converts; the port runs block 2 and gives
    JAX's block 2."""
    nch, tileF = 8, 64
    x = occupied_band(nch, nch * tileF * 4, seed=7)
    b1, b2 = np.split(x, 2)
    js, _ = jpf.channelized_fm_pallas_step(jpf.channelized_fm_pallas_init(nch), jnp.asarray(b1),
                                           nch=nch, tileF=tileF, interpret=True)
    _, want = jpf.channelized_fm_pallas_step(js, jnp.asarray(b2), nch=nch, tileF=tileF,
                                             interpret=True)
    ts = from_jax_pfb_fm_state(jax.tree.map(np.asarray, js), CPU)
    block = PFBFusedFM(nch, tileF=tileF)
    assert [tuple(t.shape) for t in ts] == [tuple(t.shape) for t in block.init(CPU)]
    _, got = block.apply(ts, torch.from_numpy(b2))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 2e-3


@pytest.mark.parametrize("bad", ["rows", "dtype", "nch", "taps", "W", "tileF", "contiguous"])
@pytest.mark.parametrize("demod", [True, False])
def test_wrappers_reject_bad_input(bad, demod):
    nch, tileF = 8, 16
    F = tileF * 2
    vfull = torch.zeros((F + (L if demod else L - 1), nch), dtype=torch.complex64)
    taps, W = pf.pfb_design(nch, M, 80.0, CPU)
    kw = dict(nch=nch, L=L, tileF=tileF)
    if bad == "rows":
        vfull = vfull[:-1]
    elif bad == "dtype":
        vfull = vfull.real.contiguous()
    elif bad == "nch":
        kw["nch"] = nch + 1
    elif bad == "taps":
        taps = taps[:-1]
    elif bad == "W":
        W = W[:-1]
    elif bad == "tileF":
        kw["tileF"] = 24
    else:
        vfull = torch.zeros((nch, vfull.shape[0]), dtype=torch.complex64).T
    fn = pf.pfb_fm_fused if demod else pf.pfb_channelize_fused
    before = dict(pf.launches)
    with pytest.raises(ValueError):
        fn(vfull, taps, W, **kw)
    assert pf.launches == before
