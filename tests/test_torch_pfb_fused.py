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
from csdr_tpu_torch.ops.cuda import bf16x3
from csdr_tpu_torch.ops.cuda import pfb_fused as pf
from csdr_tpu_torch.ops.cuda._build import source_ints
from csdr_tpu_torch.ops.nco import mix_stream
from csdr_tpu_torch.ops.pfb import pfb_offset
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


GID, TIG = np.arange(32) >> 2, np.arange(32) & 3
K_RUN, K_M = source_ints("pfb_fused.cu", "kRun", "kM")   # FIR rows per thread, GEMM rows


def _split_words(re, im):
    """Complex values → (hi, lo) words, re in the low halves."""
    hr, lr = bf16x3.split_bf16(re)
    hi_, li = bf16x3.split_bf16(im)
    return bf16x3.pack_pairs(hr, hi_), bf16x3.pack_pairs(lr, li)


def _words(w):
    w = np.asarray(w, np.uint32)
    return (bf16x3.bf16_value(w & 0xFFFF).astype(np.float64),
            bf16x3.bf16_value(w >> 16).astype(np.float64))


def _pfb_schedule(vfull, taps, W, L, demod, blocks, tileF=64, kf=0.6):
    """csrc/pfb_fused.cu transcribed in numpy: ``blocks`` persistent blocks,
    each walking a contiguous run of kernel_tile-frame tiles; the branch FIR
    with its register window (in a block's first tile, K3's FIR row −1, the
    frame before the tile, into U row TF and one FP32 row of D; later tiles
    carry the previous tile's last D row); W split into B and stored, then
    read, K-major in the 128-byte swizzle; U's words read through the A
    fragments (re/im interleaved along K and N, 2nch and 2ncho padded to
    whole k-steps and 32-column groups, rows to whole 64-row blocks); D =
    three bf16 products in float64; the demod or D, channel-major."""
    nch, ncho = W.shape
    H = L - 1 + demod
    F = vfull.shape[0] - H
    TF = pf.kernel_tile(F, tileF, nch)
    E = TF + H
    Kp, NG = -(-nch // 8) * 8, -(-2 * ncho // 32)
    KS, KB, NP = Kp // 8, -(-2 * Kp // 64), 32 * NG
    # B as the kernel stores it: row n (a column of D) K-major in 128-byte
    # swizzled k-blocks, word (n, p) = (B[2p][n], B[2p + 1][n]); then read
    # back element by element as wgmma reads it
    Wp = np.zeros((Kp, NP // 2), np.complex64)
    Wp[:nch, :ncho] = W
    n, p = np.meshgrid(np.arange(NP), np.arange(Kp), indexing="ij")
    w = Wp[p, n >> 1]
    v0 = np.where(n & 1, w.imag, w.real).astype(np.float32)
    v1 = np.where(n & 1, w.real, -w.imag).astype(np.float32)
    c = 2 * p
    at = (c // 64) * NP * 64 + n * 64 + ((((c % 64) // 8) ^ n) % 8) * 8 + c % 8  # element index
    B = []
    for hi_lo in zip(bf16x3.split_bf16(v0), bf16x3.split_bf16(v1)):
        store = np.zeros(KB * NP * 64, np.uint16)
        store[at], store[at + 1] = hi_lo
        cc, nn = np.meshgrid(np.arange(2 * Kp), np.arange(NP), indexing="ij")
        read = (cc // 64) * NP * 64 + nn * 64 + ((((cc % 64) // 8) ^ nn) % 8) * 8 + cc % 8
        B.append(bf16x3.bf16_value(store[read]).astype(np.float64))   # (2Kp, NP)
    out = np.zeros((ncho, F), np.float64 if demod else np.complex128)
    T = F // TF
    per, rem = divmod(T, blocks)
    for blk in range(blocks):
        first = blk * per + min(blk, rem)
        carry = None
        for i in range(per + (blk < rem)):
            f0 = (first + i) * TF
            extra = int(demod and i == 0)
            MT = K_M // 16 * -(-TF // K_M)                      # whole K_M-row blocks
            S = vfull[f0:f0 + E]
            Uh = np.zeros((MT * 16 + 16, Kp), np.uint32)         # + K3's U row TF
            Ul = np.zeros((MT * 16 + 16, Kp), np.uint32)
            for run in range(-(-(TF + extra) // K_RUN)):
                rho0 = run * K_RUN - extra
                zero = np.zeros(nch, np.complex64)
                # the register window: rows ρ0 + q + H, shifted one row per tap
                win = [S[rho0 + q + H] if rho0 + q + H < E else zero for q in range(K_RUN)]
                acc = [zero] * K_RUN
                for J in range(L):
                    if J:
                        win = [S[rho0 + H - J]] + win[:-1]
                    acc = [a + taps[J] * w for a, w in zip(acc, win)]
                for q in range(K_RUN):
                    rho = rho0 + q
                    if rho < TF:
                        r = TF if rho < 0 else rho
                        Uh[r, :nch], Ul[r, :nch] = _split_words(acc[q].real, acc[q].imag)
            A = []
            for U in (Uh[:MT * 16], Ul[:MT * 16]):
                a = np.zeros((MT * 16, 2 * Kp))
                for mt in range(MT):
                    for kk in range(KS):
                        r, p = mt * 16 + GID, 8 * kk + TIG
                        for dr, dp in ((0, 0), (8, 0), (0, 4), (8, 4)):
                            lo_v, hi_v = _words(U[r + dr, p + dp])
                            a[r + dr, 2 * (p + dp)], a[r + dr, 2 * (p + dp) + 1] = lo_v, hi_v
                A.append(a)
            Dr = A[1] @ B[0] + A[0] @ B[1] + A[0] @ B[0]
            D = (Dr[:, 0::2] + 1j * Dr[:, 1::2])[:, :ncho]
            if demod:
                if extra:   # U row TF (hi + lo) times W, in FP32 on the CUDA cores
                    u = [sum(_words(U[TF, :nch])[i] for U in (Uh, Ul)) for i in (0, 1)]
                    before = (u[0] + 1j * u[1]) @ W.astype(np.complex128)
                else:
                    before = carry
                prev = np.concatenate([before[None], D[:TF - 1]])
                out[:, f0:f0 + TF] = (np.angle(D[:TF] * prev.conj()) / (2 * np.pi * kf)).T
                carry = D[TF - 1]
            else:
                out[:, f0:f0 + TF] = D[:TF].T
    return out


@pytest.mark.parametrize("nch,F,cols,blocks", [(4, 1024, None, 1), (20, 192, None, 2),
                                               (64, 128, None, 1), (64, 128, (32, 64), 1),
                                               (64, 320, None, 2)])
@pytest.mark.parametrize("demod", [True, False])
def test_tensor_core_schedule(nch, F, cols, blocks, demod):
    """The tiling, register-window FIR and real-GEMM packing of
    csrc/pfb_fused.cu, transcribed in numpy, against the plain versions
    (< 2e-3, tests/test_pallas_fused.py:55) and, for K3, against the JAX
    kernel in interpret mode (same bf16x3 split: < 1e-4).  nch 4 (one
    k-step, one n-tile, 512-frame tiles), 20 (2nch and 2ncho padded), 64
    and the ncho = 32 column shard; every block walks 1–3 tiles, so K3 both
    computes the frame before a tile and carries it from the previous one."""
    H = L - 1 + demod
    rng_x = occupied_band(nch, (F + H) * nch, seed=nch + F)
    _, xs = mix_stream(torch.zeros(()), torch.from_numpy(rng_x), pfb_offset(nch), up=False)
    vfull = xs.reshape(F + H, nch).flip(1).contiguous()
    c = slice(*cols) if cols else slice(0, nch)
    taps, W = pf.pfb_design(nch, M, 80.0, CPU)
    W = W[:, c].contiguous()
    assert F // pf.kernel_tile(F, 64, nch) >= 2
    got = _pfb_schedule(vfull.numpy(), taps.numpy(), W.numpy(), L, demod, blocks)
    ref = (pf.pfb_fm_fused_ref(vfull, taps, W, nch=nch, L=L) if demod
           else pf.pfb_channelize_fused_ref(vfull, taps, W, nch=nch, L=L)).numpy()
    assert got.shape == ref.shape == (W.shape[1], F)
    assert np.max(np.abs(got - ref)) < 2e-3
    if demod:
        v = vfull.numpy()
        want = jpf.pfb_fm_fused(*jax_operands(v, nch, c), nch=nch, L=L, tileF=64, kf=0.6,
                                interpret=True)
        assert np.max(np.abs(got - np.asarray(want).T)) < 1e-4


def test_kernel_tile():
    """Tiles shrink from tileF to at most 4,096 samples (not below 16
    frames), or grow while they divide F and stay within 4,096 samples and
    512 frames; either way they divide F."""
    assert pf.kernel_tile(1 << 17, 64, 64) == 64
    assert pf.kernel_tile(1 << 17, 128, 64) == 64
    assert pf.kernel_tile(1 << 21, 64, 4) == 512
    assert pf.kernel_tile(64 * 6553, 64, 20) == 64
    assert pf.kernel_tile(128 * 3, 32, 20) == 128
    assert pf.kernel_tile(48, 16, 8) == 16
    assert pf.kernel_tile(64, 64, 650) == 16
