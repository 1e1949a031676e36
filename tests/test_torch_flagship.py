"""The fused flagship step of the port against the JAX package.

On a CPU tensor ``flagship_fused_step`` runs its plain twin, the
arithmetic the CUDA kernel implements; the kernel itself is held to the
twin on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances, each with its source:
  * vs the JAX narrow kernel K2 (interpret mode), frame 0 included:
    1.5e-3 max — K2's DFT is the bf16x3 split (~1.6e-5 rel) and its DC solve
    is blocked differently (tests/test_flagship_fused_wide.py:71-72);
  * vs the JAX XLA chain, frames >= 1 (frame 0's demod seed differs by
    design): 1.2e-3 max and 4e-5 RMS (tests/test_flagship_fused_wide.py:66-67);
  * cu8 converted in the step vs float input fed the host-converted
    samples: 2e-4 (tests/test_flagship_fused.py:70).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csdr_tpu.models.receivers import channelized_fm_receiver as jax_receiver
from csdr_tpu.ops.pallas.flagship_fused import (flagship_fused_init as k2_init,
                                                flagship_fused_step as k2_step)

import csdr_tpu_torch as ct
from csdr_tpu_torch.ops.cuda import flagship_fused as ff
from csdr_tpu_torch.utils.convert import from_jax_chain_state, from_jax_flagship_state

torch.set_num_threads(1)

CPU = torch.device("cpu")


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


def port_blocks(x_blocks, nch, state=None):
    st = ff.flagship_fused_init(nch, CPU) if state is None else state
    outs = []
    for blk in x_blocks:
        st, y = ff.flagship_fused_step(st, blk, nch=nch, tileF=16)
        outs.append(y.numpy())
    return st, np.concatenate(outs, axis=1)


def k2_blocks(x_blocks, nch, tileF, state=None):
    st = k2_init(nch) if state is None else state
    outs = []
    for blk in x_blocks:
        st, y = k2_step(st, jnp.asarray(blk), nch=nch, tileF=tileF, interpret=True)
        outs.append(np.asarray(y))
    return st, np.concatenate(outs, axis=1)


@pytest.mark.parametrize("nch,tileF", [(8, 64), (20, 16)])
def test_twin_matches_jax_k2_and_xla_chain(nch, tileF):
    x = occupied_band(nch, nch * tileF * 4, seed=nch)
    blocks = np.split(x, 2)
    _, got = port_blocks([torch.from_numpy(b) for b in blocks], nch)
    _, want_k2 = k2_blocks(blocks, nch, tileF)
    assert got.shape == want_k2.shape == (nch, len(x) // nch)
    assert np.max(np.abs(got - want_k2)) < 1.5e-3

    g = jax_receiver(nch, kf=0.6, backend="xla")
    st = g.init()
    want_xla = []
    for b in blocks:
        st, y = g.apply(st, jnp.asarray(b))
        want_xla.append(np.asarray(y))
    err = np.abs(got[:, 1:] - np.concatenate(want_xla, axis=1)[:, 1:])
    assert np.max(err) < 1.2e-3, np.max(err)
    assert np.sqrt(np.mean(err ** 2)) < 4e-5


def test_u8_input_matches_float_path():
    rng = np.random.default_rng(1)
    nch = 8
    n = nch * 64 * 4
    u8 = rng.integers(0, 256, 2 * n).astype(np.uint8)
    f = (u8.astype(np.float32) - 127.5) / np.float32(127.5)
    iq = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    _, yf = port_blocks([torch.from_numpy(b) for b in np.split(iq, 2)], nch)
    _, yu = port_blocks([torch.from_numpy(b) for b in np.split(u8, 2)], nch)
    _, yp = port_blocks([(torch.from_numpy(b[0::2].copy()), torch.from_numpy(b[1::2].copy()))
                         for b in np.split(u8, 2)], nch)
    assert np.max(np.abs(yf - yu)) < 2e-4
    np.testing.assert_array_equal(yu, yp)


def test_state_handoff_from_jax_k2():
    """JAX K2 runs block 1; its state converts; the port runs block 2 and
    gives JAX's block 2."""
    nch, tileF = 8, 64
    x = occupied_band(nch, nch * tileF * 4, seed=5)
    b1, b2 = np.split(x, 2)
    st1, _ = k2_blocks([b1], nch, tileF)
    _, want = k2_blocks([b2], nch, tileF, state=st1)
    st_np = jax.tree.map(np.asarray, st1)
    _, got = port_blocks([torch.from_numpy(b2)], nch, from_jax_flagship_state(st_np, CPU))
    assert np.max(np.abs(got - want)) < 1.5e-3


def test_state_handoff_from_jax_xla_chain():
    nch = 8
    x = occupied_band(nch, nch * 64 * 2, seed=6)
    b1, b2 = np.split(x, 2)
    jg = jax_receiver(nch, kf=0.6, backend="xla")
    js, _ = jg.apply(jg.init(), jnp.asarray(b1))
    _, want = jg.apply(js, jnp.asarray(b2))
    tg = ct.channelized_fm_receiver(nch, kf=0.6, backend="eager")
    ts = from_jax_chain_state(jax.tree.map(np.asarray, js), CPU)
    _, got = tg.apply(ts, torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_fused_block_in_pipeline_takes_cu8_rows():
    """The fused block streams cu8 (n, 2) rows through the Pipeline and
    equals the eager graph on the same bytes, frames >= 1."""
    rng = np.random.default_rng(7)
    nch = 8
    n = nch * 16 * 9 + 40  # a short last block
    u8 = rng.integers(0, 256, (n, 2)).astype(np.uint8)
    outs = {}
    for backend in ("fused", "eager"):
        g = ct.channelized_fm_receiver(nch, backend=backend)
        if backend == "eager":
            g = ct.chain(ct.u8_to_iq(), g)
        sink = ct.CollectSink()
        assert ct.Pipeline(g, 512, device=CPU).run(iter([u8]), sink) == n // nch
        outs[backend] = sink.concat()
    assert outs["fused"].shape == (nch, n // nch)
    assert np.max(np.abs(outs["fused"][:, 1:] - outs["eager"][:, 1:])) < 1.2e-3


def _rev(k, P):
    """k with its log2(P) bits reversed."""
    return int(f"{k:0{P.bit_length() - 1}b}"[::-1], 2) if P > 1 else 0


def _dft_reg(v):
    """csrc/fft_reg.cuh dft_reg over axis 0: radix-2 DIF, natural
    order in, bit-reversed order out."""
    v = v.copy()
    P = v.shape[0]
    half = P // 2
    while half >= 1:
        for g in range(0, P, 2 * half):
            for j in range(half):
                a, b = v[g + j].copy(), v[g + j + half].copy()
                e = j * (16 // (2 * half))
                v[g + j], v[g + j + half] = a + b, (a - b) * np.exp(-2j * np.pi * e / 16)
        half //= 2
    return v


def _lanes_dft(U, tw, nch):
    """The channel tile's DFT for nch = P·G a power of two: lane l of a
    frame runs a P-point DFT over branches l + G·m in registers, times
    tw[l·k1], then a radix-G pass across the G lanes (the xor shuffles
    transcribed); lane l then holds bins k1 + P·k2, k2 = rev(l)."""
    G = {32: 2, 64: 4}.get(nch, 1)
    P = nch // G
    lane = [_dft_reg(U[:, l::G].T.astype(np.complex128)) for l in range(G)]  # (P, frames)
    for l in range(1, G):
        for k1 in range(P):
            lane[l][_rev(k1, P)] *= tw[l * k1]
    if G == 4:  # xor 2, then lane 3 × −i
        lane = [lane[l] + lane[l ^ 2] if not l & 2 else lane[l ^ 2] - lane[l] for l in range(4)]
        lane[3] = lane[3] * -1j
    if G >= 2:  # xor 1
        lane = [lane[l] + lane[l ^ 1] if not l & 1 else lane[l ^ 1] - lane[l] for l in range(G)]
    D = np.zeros((U.shape[0], nch), np.complex128)
    for l in range(G):
        k2 = _rev(l, G)
        for k1 in range(P):
            D[:, k1 + P * k2] = lane[l][_rev(k1, P)]
    return D


@pytest.mark.parametrize("nch", [8, 16, 32, 64])
def test_channel_fft_schedule_matches_dft(nch):
    """The register/shuffle FFT schedule of csrc/flagship_fused.cu
    channel_tile, with the wrapper's twiddle table, equals the DFT matrix
    the plain twin multiplies by (_forward_dft), to float32 rounding."""
    rng = np.random.default_rng(nch)
    U = (rng.normal(size=(33, nch)) + 1j * rng.normal(size=(33, nch))).astype(np.complex64)
    tw = ff._constants(nch, 7, 80.0, 32, 0.0005, nch * 32, CPU)["twiddle"].numpy()
    got = _lanes_dft(U, tw.astype(np.complex128), nch)
    want = U.astype(np.complex128) @ ff._forward_dft(nch).astype(np.complex128)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-6


def _decay_scan(vals, pw):
    """The inclusive decay scan of csrc decay_scan: sc[t] = Σ_{j≤t} pw[t−j]·w[j]."""
    sc = vals.copy()
    d = 1
    while d < len(sc):
        prev = sc.copy()
        sc[d:] += pw[d] * prev[:-d]
        d *= 2
    return sc


def _kernel_dc(x, nch, tileF, m, x_last, y_last, alpha=0.0005):
    """The DC blocker as the three launches compute it, in numpy: dc_chunk's
    zero-carry chunk ends and halo-start partials, the chunk carries, then
    each channel block's replay of its own frames (tb of them, a run of
    tiles) and halo from r^{o_h}·chunk_in[c] + partial[c] (y_dc_last for the
    first blocks).
    Returns (y over the block, as tile 0.. last write it, y_last)."""
    n, C, L = len(x), tileF * nch, 2 * m
    c = ff._constants(nch, m, 80.0, tileF, alpha, n, CPU)
    r = 1.0 - alpha
    g = (1.0 + r) / 2.0
    spt, spt2, o_h = c["spt"], c["spt2"], c["o_h"]
    pow_thr, pow_rep = c["pow_thr"].numpy().astype(np.float64), c["pow_rep"].numpy()
    xp_all = np.concatenate([[x_last], x])             # xp_all[i] = x[i − 1]

    def run(b, e, y):
        """y after samples b .. e−1 from carry y; every value."""
        out = np.zeros(e - b, np.complex128)
        for i in range(b, e):
            y = r * y + g * (x[i] - xp_all[i])
            out[i - b] = y
        return out

    n_chunks = n // C
    ends, partial = np.zeros(n_chunks, complex), np.zeros(n_chunks, complex)
    th, loc = divmod(o_h, spt)
    for k in range(n_chunks):
        w = np.array([run(k * C + t * spt, k * C + (t + 1) * spt, 0.0)[-1]
                      for t in range(C // spt)])
        sc = _decay_scan(w, pow_thr)
        ends[k] = sc[-1]
        rec = run(k * C + th * spt, k * C + th * spt + loc, 0.0)[-1] if loc else 0.0
        partial[k] = rec + (c["r_loc"] * sc[th - 1] if th else 0.0)
    chunk_in = np.zeros(n_chunks, complex)
    G = y_last
    for k in range(n_chunks):
        chunk_in[k] = G
        G = c["rC"] * G + ends[k]
    y = np.zeros(n, complex)
    B = c["tb"] * nch
    for k in range(n // B):
        s_h = k * B - (L + 1) * nch
        s_r, e = max(s_h, 0), (k + 1) * B
        y0 = y_last if s_h <= 0 else c["r_oh"] * chunk_in[s_h // C] + partial[s_h // C]
        R = e - s_r
        bs = [min(t * spt2, R) for t in range(256)]
        w = np.array([run(s_r + b, s_r + b + min(spt2, R - b), 0.0)[-1] if R > b else 0.0
                      for b in bs])
        sc = _decay_scan(w, pow_rep)
        for t, b in enumerate(bs):
            if R > b:
                carry = pow_rep[t] * y0 + (sc[t - 1] if t else 0.0)
                seg = run(s_r + b, s_r + b + min(spt2, R - b), carry)
                if s_r + b >= s_h:   # the tile's values, halo included, must agree
                    done = y[s_r + b:s_r + b + len(seg)]
                    assert np.all((done == 0) | (np.abs(done - seg) < 1e-5))
                y[s_r + b:s_r + b + len(seg)] = seg
    return y, G


@pytest.mark.parametrize("nch,tileF,tiles", [(8, 8, 6), (20, 16, 6), (64, 32, 2), (64, 8, 5)])
def test_dc_replay_matches_dc_blocker_stream(nch, tileF, tiles):
    """The halo-start partial and the per-block replay, over 3 chained
    blocks, equal the DC blocker the plain twin runs (dc_blocker_stream);
    nch 8 and 20 group the tiles three and six to a channel block, nch 64 ×
    tileF 8 over 5 tiles (one tile a block) puts a halo start two chunks
    back."""
    rng = np.random.default_rng(nch + tileF)
    n = nch * tileF * tiles
    x = (0.3 + rng.normal(size=3 * n) + 1j * rng.normal(size=3 * n)).astype(np.complex64)
    xl, yl = np.complex64(0.5 - 0.25j), np.complex64(0.1 + 0.2j)
    st = (torch.tensor([xl]), torch.tensor([yl]))
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        got, g_last = _kernel_dc(blk.astype(np.complex128), nch, tileF, 7, complex(xl), complex(yl))
        st, want = ff.dc_blocker_stream(st, torch.from_numpy(blk), 0.0005)
        assert np.max(np.abs(got - want.numpy())) < 2e-5
        assert abs(g_last - complex(st[1][0])) < 2e-5
        xl, yl = blk[-1], np.complex64(g_last)


@pytest.mark.parametrize("bad", ["shape", "dtype", "nch", "tileF", "state"])
def test_wrapper_rejects_bad_input(bad):
    nch, tileF = 8, 16
    st = ff.flagship_fused_init(nch, CPU)
    x = torch.zeros(nch * tileF * 2, dtype=torch.complex64)
    kw = dict(nch=nch, tileF=tileF)
    if bad == "shape":
        x = x[:-nch]
    elif bad == "dtype":
        x = x.real.contiguous()
    elif bad == "nch":
        kw["nch"] = 1
    elif bad == "tileF":
        kw["tileF"] = 12
    else:
        st = ff.flagship_fused_init(nch + 1, CPU)
    launches = ff.launches
    with pytest.raises((ValueError, TypeError)):
        ff.flagship_fused_step(st, x, **kw)
    assert ff.launches == launches
