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

import os
import re

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


def _segments(x, xp, r, g, spt, R, y_in=None, linear=False):
    """Each of 256 threads' DC run over samples [t·spt, t·spt + spt) ∩ [0, R)
    of x (xp[i] = the sample before x[i]), vectorised over the threads:
    from zero carry (``y_in`` None; returns each thread's end value) or
    from y_in[t] (returns every value): recursively from y_in (the X-plane
    replay), or with ``linear`` as the zero-carry value plus r^(i+1)·y_in
    (a later tile's register replay)."""
    out = np.zeros(R, complex)
    y = np.zeros(_THREADS, complex) if y_in is None or linear else y_in.astype(complex)
    c = None if y_in is None else y_in.astype(complex)
    b = np.minimum(np.arange(_THREADS) * spt, R)
    n = np.minimum(spt, R - b)
    for i in range(spt):
        live = i < n
        j = b[live] + i
        y[live] = r * y[live] + g * (x[j] - xp[j])
        if linear:
            c[live] = r * c[live]
        out[j] = y[live] + (c[live] if linear else 0.0)
    return y if y_in is None else out


_THREADS = 256   # csrc/flagship_fused.cu kChannelThreads


def _kernel_channel(x, st, nch, tileF, slots, m=7, kf=0.6, alpha=0.0005):
    """The three launches of csrc/flagship_fused.cu in numpy (float64): the
    chunk pass and the chunk carries, then the channel pass's schedule,
    ``ff.channel_plan`` with ``slots`` resident blocks: each block walks
    its run of tiles; a run's first tile stages its halo and starts its DC
    from r^{o_h}·chunk_in[c] + partial[c] (or y_dc_last, hist for the
    stream's first frames); a later tile takes the DC output and the raw
    sample carried from the tile before (its segments' replay adds
    r^(i+1)·carry to their zero-carry values), and finds the last DFT frame
    and the FIR halo (the last L frames) in the rows the tile before left.
    Returns (audio, new state, DC output as the tiles wrote it, samples
    staged)."""
    n, C, L = len(x), tileF * nch, 2 * m
    F = n // nch
    c = ff._constants(nch, m, 80.0, tileF, alpha, n, CPU)
    r = 1.0 - alpha
    g = (1.0 + r) / 2.0
    spt, o_h = c["spt"], c["o_h"]
    pow_thr = c["pow_thr"].numpy().astype(np.float64)
    pow_rep = c["pow_rep"].numpy().astype(np.float64)
    x_last, y_last = complex(st["x_last"]), complex(st["y_dc_last"])
    phase = float(st["phase"])
    xp_all = np.concatenate([[x_last], x])[:-1]        # xp_all[i] = x[i − 1]

    # dc_chunk and carry_scan
    n_chunks = n // C
    ends, partial = np.zeros(n_chunks, complex), np.zeros(n_chunks, complex)
    th, loc = divmod(o_h, spt)
    for k in range(n_chunks):
        seg = slice(k * C, (k + 1) * C)
        w = _segments(x[seg], xp_all[seg], r, g, spt, C)[:C // spt]
        sc = _decay_scan(w, pow_thr)
        ends[k] = sc[-1]
        at = slice(k * C + th * spt, k * C + th * spt + loc)
        rec = _segments(x[at], xp_all[at], r, g, loc, loc)[0] if loc else 0.0
        partial[k] = rec + (c["r_loc"] * sc[th - 1] if th else 0.0)
    chunk_in = np.zeros(n_chunks, complex)
    G = y_last
    for k in range(n_chunks):
        chunk_in[k] = G
        G = c["rC"] * G + ends[k]

    # channel_tile
    TF, run, grid = ff.channel_plan(nch, tileF, F, L, slots)
    assert TF == c["TF"]
    T = ff.permuted_tap_panel(nch, m, 80.0).astype(np.float64)
    W = ff._forward_dft(nch).astype(np.complex128)
    ramp = ff.phase_ramp(float(ff.pfb_offset(nch)), 2 * nch).astype(np.float64)
    rot = np.exp(1j * (ramp.astype(np.float32) + np.float32(phase)).astype(np.float64))
    hist = st["hist"].numpy().astype(np.complex128)
    audio = np.full((nch, F), np.nan)
    y_all = np.zeros(n, complex)
    new_hist = np.full((L + 1, nch), np.nan, complex)
    staged = 0
    tiles = -(-F // TF)
    for blk in range(grid):
        S = np.zeros((TF + L + 1, nch), complex)        # row j: frame f0 − (L+1) + j
        for ti in range(blk * run, min(blk * run + run, tiles)):
            first = ti == blk * run
            f0 = ti * TF
            nf = min(TF, F - f0)
            if first:
                s_h = (f0 - (L + 1)) * nch
                s0 = max(s_h, 0)
                y0 = y_last if s_h <= 0 else c["r_oh"] * chunk_in[s_h // C] + partial[s_h // C]
                xprev = x_last if s0 == 0 else x[s0 - 1]
                spt_t, pw = c["spt_a"], pow_rep[0]
                for row in range(max(0, L + 1 - f0)):    # frames before the stream
                    S[row] = hist[f0 + row]
            else:
                s0 = f0 * nch
                y0, xprev = carry                        # from the tile before
                spt_t, pw = c["spt_b"], pow_rep[1]
                assert np.all(np.isfinite(S[:L + 1]))
            R = (f0 + nf) * nch - s0
            staged += R
            xs = x[s0:s0 + R]
            xp = np.concatenate([[xprev], xs[:-1]])
            w = _segments(xs, xp, r, g, spt_t, R)
            sc = _decay_scan(w, pw)
            y_in = pw[:_THREADS] * y0 + np.concatenate([[0.0], sc[:-1]])
            y = _segments(xs, xp, r, g, spt_t, R, y_in, linear=not first)
            if not first or s0 > 0:   # a run's halo: the run before wrote it
                done = y_all[s0:f0 * nch]
                assert np.all(np.abs(done - y[:len(done)]) < 1e-5)
            y_all[s0:s0 + R] = y
            carry = (y[-1], xs[-1])
            s = np.arange(s0, s0 + R)
            shifted = y * np.conj(rot[s % (2 * nch)])
            rows = s // nch - (f0 - (L + 1))
            S[rows, s % nch] = shifted
            for row in range(L + 1, nf + L + 1):        # hist: the tile's own frames
                fr = f0 - (L + 1) + row
                if fr >= F - L - 1:
                    new_hist[fr - (F - L - 1)] = S[row]
            if first and f0 == 0:
                for row in range(min(nf + L + 1, L + 1)):
                    fr = row - (L + 1)
                    if fr >= F - L - 1:
                        new_hist[fr - (F - L - 1)] = S[row]
            u0 = 0 if first else 1
            U = np.zeros((nf + 1, nch), complex)
            for t in range(u0, nf + 1):
                U[t] = sum(T[J] * S[t + L - J] for J in range(L + 1))
            D = S.copy()
            D[u0:nf + 1] = U[u0:] @ W
            prod = D[1:nf + 1] * np.conj(D[:nf])
            audio[:, f0:f0 + nf] = (np.angle(prod) / (2 * np.pi * kf)).T
            S = np.zeros_like(S)
            S[:L + 1] = np.concatenate([D[nf:nf + 1], D[nf + 1:nf + L + 1]])
    new_state = dict(hist=new_hist, x_last=x[-1], y_dc_last=G)
    return audio, new_state, y_all, staged


# (nch, tileF, frames a block, resident slots): 8, 20 and 64 channels at
# tileF 8, 16 and 32; a last run shorter than the others (8, 64), a short
# last tile (20), one tile a block (64 × 8), F below one tile (64 × 8 at
# 40 frames, 64 × 32 at 32), one block walking every tile (20 × 32, 8 × 32)
SCHEDULES = [(8, 8, 1536, 2), (20, 16, 672, 2), (64, 32, 320, 2), (64, 8, 40, 4),
             (64, 8, 192, 8), (20, 32, 448, 1), (8, 32, 1024, 1), (64, 32, 32, 4)]


@pytest.mark.parametrize("nch,tileF,F,slots", SCHEDULES)
def test_channel_schedule_matches_twin_and_dc_blocker(nch, tileF, F, slots):
    """The channel pass's persistent schedule, transcribed in numpy, over 3
    chained blocks: its DC output equals the DC blocker the plain twin runs
    (dc_blocker_stream), a run's halo equals what the run before computed,
    its audio and carried state equal the twin's (flagship_fused_ref), and
    the samples it stages equal ``staged_samples``."""
    rng = np.random.default_rng(nch + tileF + F)
    n = nch * F
    x = occupied_band(nch, 3 * n, seed=nch + F) + np.complex64(0.3 - 0.2j)
    x += (0.05 * (rng.normal(size=3 * n) + 1j * rng.normal(size=3 * n))).astype(np.complex64)
    st = ff.flagship_fused_init(nch, CPU)
    st["x_last"] = torch.tensor(0.5 - 0.25j, dtype=torch.complex64)
    st["y_dc_last"] = torch.tensor(0.1 + 0.2j, dtype=torch.complex64)
    st["hist"] = torch.from_numpy((rng.normal(size=(15, nch)) + 1j * rng.normal(size=(15, nch)))
                                  .astype(np.complex64) * np.float32(0.1))
    dc = (st["x_last"].reshape(1), st["y_dc_last"].reshape(1))
    TF, run, _ = ff.channel_plan(nch, tileF, F, 14, slots)
    for b in range(3):
        blk = x[b * n:(b + 1) * n]
        got, got_st, y_dc, staged = _kernel_channel(blk.astype(np.complex128), st, nch, tileF,
                                                    slots)
        dc, want_dc = ff.dc_blocker_stream(dc, torch.from_numpy(blk), 0.0005)
        assert np.max(np.abs(y_dc - want_dc.numpy())) < 2e-5
        assert abs(got_st["y_dc_last"] - complex(dc[1][0])) < 2e-5
        st, want = ff.flagship_fused_ref(st, torch.from_numpy(blk), nch=nch)
        d = got - want.numpy()
        d = np.remainder(d + 0.5 / 0.6, 1 / 0.6) - 0.5 / 0.6
        assert np.max(np.abs(d)) < 2e-4, np.max(np.abs(d))
        assert np.max(np.abs(got_st["hist"] - st["hist"].numpy())) < 2e-5
        assert staged == ff.staged_samples(nch, F, 14, TF, run)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kernels_keep_the_names_k1_roofline_reads():
    """Every __global__ function of csrc/flagship_fused.cu is dc_chunk,
    carry_scan or channel_tile, and each matches the kernel pattern of
    portbench's k1_roofline, which sums K1's device time by name."""
    src = open(os.path.join(ROOT, "csdr_tpu_torch", "csrc", "flagship_fused.cu")).read()
    src = re.sub(r"//[^\n]*", "", src)
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       src)
    assert len(names) == src.count("__global__")
    assert sorted(names) == ["carry_scan", "channel_tile", "dc_chunk"]
    metric = open(os.path.join(ROOT, "portbench", "metrics", "k1_roofline.py")).read()
    pattern = re.search(r're\.compile\(r"([^"]+)"\)', metric).group(1)
    for name in names:
        assert re.search(pattern, f"void (anonymous namespace)::{name}<16, 4>(int, float)")


@pytest.mark.parametrize("F,slots,run,share", [
    (1 << 17, 264, 8, (131072 + 255 * 15) / 131072),   # the cell: 2 blocks on each of 132 SMs
    (1 << 17, 396, 6, (131072 + 341 * 15) / 131072),   # 3 on each
    (1536, 264, 1, (1536 + 23 * 15) / 1536)])          # 24 tiles: one a block
def test_channel_staging_share(F, slots, run, share):
    """The channel pass's staged samples over the block's samples at nch 64,
    tileF 32: every tile once, plus the 15 halo frames of each run but the
    stream's first; at the nbfm64 cell's 2^23 samples at most 1.05 (the
    one-tile-a-block pass before runs staged 47 frames a 32: 1.47)."""
    TF, got_run, grid = ff.channel_plan(64, 32, F, 14, slots)
    assert (TF, got_run) == (64, run) and (grid - 1) * run < -(-F // TF) <= grid * run
    staged = ff.staged_samples(64, F, 14, TF, run)
    assert staged / (F * 64) == pytest.approx(share, rel=1e-12)
    if F == 1 << 17:
        assert staged / (F * 64) <= 1.05


def _atan2_poly(y, x):
    """csrc/flagship_fused.cu atan2_poly in float32 (its coefficients read
    from the source), each fmaf rounded once."""
    src = open(os.path.join(ROOT, "csdr_tpu_torch", "csrc", "flagship_fused.cu")).read()
    body = re.search(r"kAtan\[9\] = \{([^}]*)\}", src).group(1)
    c = np.array([float(v.strip().rstrip("f")) for v in body.split(",")], np.float32)
    f32 = np.float32
    y, x = y.astype(f32), x.astype(f32)
    ax, ay = np.abs(x), np.abs(y)
    mx, mn = np.maximum(ax, ay), np.minimum(ax, ay)
    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.where(mx > 0, (mn.astype(np.float64) / mx).astype(f32), f32(0))
    s2 = (t * t).astype(f32)
    p = np.full_like(s2, c[8])
    for k in range(7, -1, -1):
        p = (p.astype(np.float64) * s2 + c[k]).astype(f32)
    a = (t * p).astype(f32)
    a = np.where(ay > ax, (f32(np.pi / 2) - a).astype(f32), a)
    a = np.where(np.signbit(x), (f32(np.pi) - a).astype(f32), a)
    return np.copysign(a, y)


def test_demod_atan2_matches_arctan2():
    """The channel pass's branch-free atan2 is within 3e-7 rad of atan2 over
    every octant and a wide range of magnitudes, and gives atan2's signed
    results on the axes and at the signed zeros."""
    rng = np.random.default_rng(0)
    ang = rng.uniform(-np.pi, np.pi, 200_000)
    mag = 10.0 ** rng.uniform(-6, 3, ang.size)
    y, x = (mag * np.sin(ang)).astype(np.float32), (mag * np.cos(ang)).astype(np.float32)
    err = np.abs(_atan2_poly(y, x) - np.arctan2(y.astype(np.float64), x.astype(np.float64)))
    assert np.max(np.minimum(err, 2 * np.pi - err)) < 3e-7
    z = np.float32(0.0)
    edge_y = np.array([z, -z, z, -z, 1, -1, 0, 0, 2, -2], np.float32)
    edge_x = np.array([z, z, -z, -z, 0, 0, 1, -1, 2, -2], np.float32)
    np.testing.assert_array_equal(_atan2_poly(edge_y, edge_x),
                                  np.arctan2(edge_y, edge_x).astype(np.float32))


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
