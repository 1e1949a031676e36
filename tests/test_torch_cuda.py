"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  The file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: 1.2e-3 max over every frame (tests/test_flagship_fused_wide.py:66;
kernel and twin share frame 0's seed), on a band with a carrier in every
channel so no channel magnitude sits near zero, where atan2 would amplify
float32 rounding by 1/|d|.  The PFB kernels K3/K4 (``pfb_fused``): 2e-3
max (tests/test_pallas_fused.py:55, tests/test_pfb_channelize_fused.py:39)
and 4e-5 RMS (tests/test_flagship_fused_wide.py:67, the same arithmetic).
K3's audio is compared modulo 1/kf: a phase step near ±π may land on
either side of atan2's branch cut in two right implementations, and then
differs by exactly 2π/(2π·kf).  The FIR kernels, relative to the largest
output: K5 (``fir_valid``) 1e-4, tighter than the JAX package's 2e-3
(tests/test_pallas_fir.py:21,32) because its bf16x3 products read ~1e-5 and
one product left out reads ~2e-3 (tests/test_torch_fir.py); K6
(``fft_fir``) 2e-4 (tests/test_fftfir.py:36,51).  The block symbol sync
(K9, ``symsync_block``) against the CPU's plain version: 2e-3 of either
pick where float order picks (tests/test_torch_symsync.py), τ within 1e-3;
two runs on the card bit for bit, and the sharded step bit for bit the
serial one on the card.  The Hilbert blocks and the imagery
chains (no kernel of their own) against the CPU: 2e-5 relative to the
largest output (tests/test_golden.py), the SSTV and WEFAX frequency tracks
from output 180 (the FIR's start-up, tests/test_sstv.py:97-102); a
profiled or recorded Pipeline equal to the plain one bit for bit, with no
device barrier; the staging ring of ``Pipeline`` and of ``ShardedPipeline``
(``core/runtime._Staging``) equal to a fresh buffer a block bit for bit,
with the host staging ahead of the copies still queued.  The scan
kernels against their twins: K7 (``pll_scan``) 2e-3 relative to the
largest output (tests/test_sharding_generic.py:60), θ within 1e-4 (the
φ pass's atan2f and the CPU's atan2 may differ by an ulp), with a run of
exact zeros and carries outside the loop's range; K8 (``symsync_scan``)
bit for bit, every output and τ, through the ring, the re-seats and the
reads from the row: its twin steps and sums in the kernel's order.
"""

import numpy as np
import pytest
import torch

import csdr_tpu_torch as ct
from csdr_tpu_torch.ops import fir as fir_ops
from csdr_tpu_torch.ops.cuda import fft_fir as k6
from csdr_tpu_torch.ops.cuda import fir_valid as k5
from csdr_tpu_torch.ops.cuda import flagship_fused as ff
from csdr_tpu_torch.ops.cuda import pfb_fused as pf
from csdr_tpu_torch.ops.nco import mix_stream
from csdr_tpu_torch.ops.pfb import pfb_offset

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def occupied_band(nch, n, seed, per_frame=False):
    """A carrier on every channel centre, FM by a tone of 0.002·(1 + k mod 5)
    cycles per sample, or per frame with ``per_frame``: then each channel's
    demod phase step stays well inside (−π, π), so atan2's branch cut never
    separates two right implementations whose D differs by bf16x3 rounding."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.zeros(n, np.complex128)
    for k in range(nch):
        fc = (k - (nch - 1) / 2) / nch
        fm = 0.002 * (1 + k % 5) / (nch if per_frame else 1)
        ph = 2 * np.pi * np.mod(fc * t, 1.0) + 2.0 * np.sin(2 * np.pi * fm * t)
        x += 0.6 / np.sqrt(nch) * np.exp(1j * (ph + rng.uniform(0, 2 * np.pi)))
    x += 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return x.astype(np.complex64)


def _k1_frames(nch, fmt, runs, dev):
    """Frames a block: 1,536 (at most 24 tiles, fewer than the card's
    resident channel blocks: one tile a block), or, for ``runs="short"``,
    enough tiles that every block walks a run of several and the last run
    is shorter than the others."""
    if runs == "one":
        return 1536
    mode = {"f32": "complex", "u8": "u8", "u8_planes": "u8_planes"}[fmt]
    TF = ff.tile_frames(nch, ff.DEFAULT_TILE_F, 1 << 30, 14)
    with torch.cuda.device(dev):
        slots = ff._library().csdr_channel_slots(ff._MODES[mode], nch, 14, TF, 1)
    tiles = 2 * slots + 1
    if tiles % 3 == 0:
        tiles += 1
    TF_, run, grid = ff.channel_plan(nch, ff.DEFAULT_TILE_F, tiles * TF, 14, slots)
    assert TF_ == TF and run == 3 and tiles - (grid - 1) * run < run
    return tiles * TF


@pytest.mark.cuda
@pytest.mark.parametrize("nch,fmt,runs", [(64, "f32", "one"), (20, "f32", "one"),
                                          (64, "u8", "one"), (20, "u8_planes", "one"),
                                          (8, "f32", "one"), (32, "u8", "one"),
                                          (64, "u8", "short"), (20, "f32", "short"),
                                          (8, "u8_planes", "short"), (32, "f32", "short")])
def test_kernel_matches_twin(dev, nch, fmt, runs):
    """K1 against its twin over 3 chained blocks, with one tile a channel
    block or runs of tiles whose last is short; a second run of the same
    blocks equals the first bit for bit.  The long blocks of the runs take
    the tone per frame: at a tone per sample some of their 2·10^6 phase
    steps a channel come within float32 rounding of ±π, where kernel and
    twin may land on the two sides of atan2's branch cut."""
    x = occupied_band(nch, nch * _k1_frames(nch, fmt, runs, dev) * 3, seed=nch,
                      per_frame=runs == "short")
    if fmt != "f32":
        q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 60 + 127.5), 0, 255)
        x = q.astype(np.uint8).reshape(-1)
    sk, st = ff.flagship_fused_init(nch, dev), ff.flagship_fused_init(nch, dev)
    again = ff.flagship_fused_init(nch, dev)
    for blk in np.split(x, 3):
        xb = torch.from_numpy(blk).to(dev)
        if fmt == "u8_planes":
            xb = (xb[0::2].contiguous(), xb[1::2].contiguous())
        before = ff.launches
        sk, yk = ff.flagship_fused_step(sk, xb, nch=nch)
        assert ff.launches == before + 1
        st, yt = ff.flagship_fused_ref(st, xb, nch=nch)
        assert yk.shape == yt.shape == (nch, len(blk) // nch // (1 if fmt == "f32" else 2))
        assert torch.max(torch.abs(yk - yt)).item() < 1.2e-3
        again, ya = ff.flagship_fused_step(again, xb, nch=nch)
        assert torch.equal(ya, yk)
    for k in ("phase", "hist", "x_last", "y_dc_last"):
        assert torch.allclose(sk[k], st[k], rtol=1e-4, atol=1e-5), k
        assert torch.equal(again[k], sk[k]), k


@pytest.mark.cuda
def test_kernel_counts_its_staging(dev):
    """At the nbfm64 cell's shape (cu8, nch 64, 2^23 samples) a step adds
    its samples and the channel pass's staged samples to the recorder's
    counters: the share staged more than once is under 5 %."""
    from csdr_tpu_torch.utils import prof

    n = 1 << 23
    u8 = torch.randint(0, 256, (2 * n,), dtype=torch.uint8, device=dev)
    st = ff.flagship_fused_init(64, dev)
    with prof.recording() as rec:
        ff.flagship_fused_step(st, u8, nch=64)
    TF, run, staged = ff._launch_plan("u8", 64, 14, ff.DEFAULT_TILE_F, n // 64, 1, dev)
    assert rec.counters["flagship.samples"] == n
    assert rec.counters["flagship.channel_staged_samples"] == staged
    assert staged == ff.staged_samples(64, n // 64, 14, TF, run) and staged / n <= 1.05


def _sharded_flagship_rank(device, blocks):
    """The one rank of a one-card mesh: ``ShardedFlagship`` over ``blocks``
    and the serial K1 step over the same blocks; whether each output and the
    state after are equal bit for bit."""
    from csdr_tpu_torch.parallel import build_mesh
    from csdr_tpu_torch.parallel.flagship import ShardedFlagship

    sh = ShardedFlagship(build_mesh(1, 1, "cuda"), 64, len(blocks[0]) // 2)
    ss, st = sh.init(), ff.flagship_fused_init(64, device)
    same = []
    for b in blocks:
        xb = torch.from_numpy(b).to(device)
        ss, ys = sh.step(ss, xb)
        st, yt = ff.flagship_fused_step(st, xb, nch=64)
        same.append(torch.equal(ys, yt))
    return same + [torch.equal(ss[k], st[k]) for k in ("phase", "hist", "x_last", "y_dc_last")]


@pytest.mark.cuda
def test_sharded_flagship_one_card_equals_serial(dev):
    """``ShardedFlagship`` at one card (W = 1) equals serial K1 bit for
    bit over 3 chained cu8 blocks of 2^21 samples."""
    from csdr_tpu_torch.parallel import spawn

    x = occupied_band(64, 3 << 21, seed=21)
    q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 60 + 127.5), 0, 255)
    blocks = np.split(q.astype(np.uint8).reshape(-1), 3)
    [same] = spawn(_sharded_flagship_rank, 1, "cuda", args=(blocks,), timeout=600.0)
    assert all(same), same


@pytest.mark.cuda
def test_launch_refuses_bad_input_on_card(dev):
    st = ff.flagship_fused_init(64, dev)
    with pytest.raises(ValueError):
        ff.flagship_fused_step(st, torch.zeros(64 * 32 + 64, dtype=torch.complex64,
                                               device=dev), nch=64)
    with pytest.raises(ValueError):  # state on another device
        ff.flagship_fused_step(ff.flagship_fused_init(64, torch.device("cpu")),
                               torch.zeros(64 * 32, dtype=torch.complex64, device=dev), nch=64)
    nch = 650  # the channel block's shared memory exceeds the limit
    with pytest.raises(ValueError, match="shared memory"):
        ff.flagship_fused_step(ff.flagship_fused_init(nch, dev),
                               torch.zeros(nch * 8 * 3, dtype=torch.complex64, device=dev),
                               nch=nch, tileF=8)


KF = 0.6          # the receivers' default FM gain
K5_REL_ERR = 1e-4


def _err(a, b, kf=None):
    """(max, RMS) of |a − b|; with ``kf``, of FM audio, the difference taken
    modulo 1/kf into [−1/(2kf), 1/(2kf))."""
    d = a.double() - b.double()
    if kf is not None:
        d = torch.remainder(d + 0.5 / kf, 1.0 / kf) - 0.5 / kf
    d = d.abs()
    return d.max().item(), d.pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("nch,shard,tiles", [(64, False, 40), (64, True, 40), (20, False, 40),
                                            (4, False, 40), (64, False, 600)])
@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("demod", [True, False])
def test_pfb_kernels_match_plain(dev, nch, shard, tiles, per_frame, demod):
    """K3 (demod) and K4 on the same panels as their plain versions, the
    full DFT matrix or its column shard [nch/2, nch); 600 tiles of 64
    frames are more than the persistent blocks, so each walks several.
    Tones per sample make phase steps up to and past π; per frame, small."""
    L, tileF = 14, pf.DEFAULT_TILE_F
    F = tileF * tiles
    x = torch.from_numpy(occupied_band(nch, (F + L) * nch, seed=nch + 1,
                                       per_frame=per_frame)).to(dev)
    # NCO-shifted as on the main path: unshifted, every carrier sits on a
    # channel edge, where the demod's phase step is ≈π and atan2's ±π branch
    # cut flips between two right implementations
    _, xs = mix_stream(torch.zeros((), device=dev), x, pfb_offset(nch), up=False)
    vfull = xs.reshape(F + L, nch).flip(1).contiguous()
    if not demod:
        vfull = vfull[1:].contiguous()
    taps, W = pf.pfb_design(nch, 7, 80.0, dev)
    if shard:
        W = W[:, nch // 2:]
    name = "pfb_fm_fused" if demod else "pfb_channelize_fused"
    fn, ref = ((pf.pfb_fm_fused, pf.pfb_fm_fused_ref) if demod
               else (pf.pfb_channelize_fused, pf.pfb_channelize_fused_ref))
    before = pf.launches[name]
    got = fn(vfull, taps, W, nch=nch, L=L)
    torch.cuda.synchronize()
    assert pf.launches[name] == before + 1
    want = ref(vfull, taps, W.contiguous(), nch=nch, L=L)
    assert got.shape == want.shape == (W.shape[1], F)
    assert got.dtype == (torch.float32 if demod else torch.complex64)
    mx, rms = _err(torch.view_as_real(got) if not demod else got,
                   torch.view_as_real(want) if not demod else want, KF if demod else None)
    assert mx < 2e-3 and rms < 4e-5, (mx, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 9])
def test_pfb_kernels_any_filter_length(dev, m):
    """K3/K4 at filter lengths L = 2m other than the designs' 14 against
    their plain versions."""
    nch, L, F = 64, 2 * m, pf.DEFAULT_TILE_F * 8
    x = torch.from_numpy(occupied_band(nch, (F + L) * nch, seed=m, per_frame=True)).to(dev)
    _, xs = mix_stream(torch.zeros((), device=dev), x, pfb_offset(nch), up=False)
    vfull = xs.reshape(F + L, nch).flip(1).contiguous()
    taps, W = pf.pfb_design(nch, m, 80.0, dev)
    assert taps.shape == (L, nch)
    for got, want in ((pf.pfb_fm_fused(vfull, taps, W, nch=nch, L=L),
                       pf.pfb_fm_fused_ref(vfull, taps, W, nch=nch, L=L)),
                      (pf.pfb_channelize_fused(vfull[1:].contiguous(), taps, W, nch=nch, L=L),
                       pf.pfb_channelize_fused_ref(vfull[1:].contiguous(), taps, W, nch=nch, L=L))):
        mx, rms = _err(torch.view_as_real(got) if got.is_complex() else got,
                       torch.view_as_real(want) if want.is_complex() else want,
                       None if got.is_complex() else KF)
        assert mx < 2e-3 and rms < 4e-5, (mx, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [64, 20])
@pytest.mark.parametrize("per_frame", [False, True])
def test_pfb_fused_receivers_match_eager(dev, nch, per_frame):
    """dc_blocker >> PFBFusedFM (K3) and the K4 channelizer with AGC, three
    state-chained blocks, against the eager graphs on the card (K3 from
    frame 1: its demod history starts at zeros); FM audio modulo 1/kf."""
    n = nch * pf.DEFAULT_TILE_F * 48
    x = torch.from_numpy(occupied_band(nch, 3 * n, seed=nch + 2,
                                       per_frame=per_frame)).to(dev)
    graphs = {
        "k3": (ct.channelized_fm_receiver(nch, kf=KF, backend="pfb_fused"),
               ct.channelized_fm_receiver(nch, kf=KF, backend="eager"), "pfb_fm_fused"),
        "k4": (ct.channelized_receiver(nch, ct.fm_demodulator(KF), agc_threshold_db=-60.0,
                                       backend="pfb_fused"),
               ct.channelized_receiver(nch, ct.fm_demodulator(KF), agc_threshold_db=-60.0),
               "pfb_channelize_fused"),
    }
    for fused, eager, name in graphs.values():
        sf, se = fused.init(dev), eager.init(dev)
        yf, ye = [], []
        before = pf.launches[name]
        for b in range(3):
            sf, y = fused.apply(sf, x[b * n:(b + 1) * n])
            yf.append(y)
            se, y = eager.apply(se, x[b * n:(b + 1) * n])
            ye.append(y)
        assert pf.launches[name] == before + 3
        yf, ye = torch.cat(yf, dim=1), torch.cat(ye, dim=1)
        assert yf.shape == ye.shape == (nch, 3 * n // nch)
        mx, rms = _err(yf[:, 1:], ye[:, 1:], KF)
        assert mx < 2e-3 and rms < 4e-5, (name, mx, rms)


def _rel(a, b):
    a, b = (torch.view_as_real(v) if v.is_complex() else v for v in (a, b))
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def _rows(dev, shape, cplx, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(*shape, 2 if cplx else 1, generator=g)
    x = torch.view_as_complex(x) if cplx else x[..., 0]
    return x.contiguous().to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,K,cplx", [(64, 1 << 13, 585, True), (1, 40_000, 3651, True),
                                           (3, 10_000, 1, False), (2, 5000, 1200, False),
                                           (4, 9_001, 257, True), (3, 70_001, 701, False),
                                           (5, 4_099, 585, False), (2, 50_000, 3651, False),
                                           (300, 4_500, 585, True)])
def test_fir_valid_kernel_matches_plain(dev, rows, n, K, cplx):
    """K5 against its plain version: batched rows, one tap, 3,651 taps
    across two tap chunks, n not a multiple of the 4,096-output run or the
    16-output frame, real and complex, and 600 work items (more than the
    persistent blocks)."""
    h = np.random.default_rng(K).normal(size=K)
    x = _rows(dev, (rows, n + K - 1), cplx, seed=K)
    before = k5.launches
    got = k5.fir_valid(x, h)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    want = k5.fir_valid_ref(x, h)
    assert got.shape == want.shape == (rows, n) and got.dtype == x.dtype
    assert _rel(got, want) < K5_REL_ERR


@pytest.mark.cuda
@pytest.mark.parametrize("K,cplx,ctaps,rows,n", [(1, False, False, 2, 70_000),
                                                 (401, False, False, 2, 70_000),
                                                 (2048, True, True, 2, 70_000),
                                                 (1826, True, True, 2, 70_000),
                                                 (300, False, True, 2, 70_000),
                                                 (3651, False, False, 3, 30_468)])
def test_fft_fir_kernel_matches_plain(dev, K, cplx, ctaps, rows, n):
    """K6 against its plain version over several segments, every
    input/taps type pair; real × real pairs segments, and 3 rows of 30,468
    outputs at 3,651 taps are 3 segments each (the last pair half empty)."""
    rng = np.random.default_rng(K)
    taps = rng.normal(size=K) / np.sqrt(K)
    if ctaps:
        taps = taps * np.exp(2j * np.pi * 0.19 * np.arange(K))
    x = _rows(dev, (rows, n + K - 1), cplx, seed=K + 1)
    before = k6.launches
    got = k6.fft_fir_valid(x, taps)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    want = k6.fft_fir_valid_ref(x, taps)
    assert got.shape == want.shape == (rows, n) and got.dtype == want.dtype
    assert _rel(got, want) < 2e-4


@pytest.mark.cuda
def test_auto_strategy_launches_fir_valid_on_the_card(dev):
    """conv_valid("auto") sends the CW filter (585 real taps) to K5."""
    taps = ct.cw_demodulator(500 / 40000, 700 / 40000).blocks[0].taps
    x = _rows(dev, (4, 1 << 12), True, seed=3)
    fir = ct.fir_filter(taps, True)
    state = fir.init(dev).expand(4, -1).contiguous()
    before = k5.launches
    _, y = fir.apply(state, x)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    _, want = fir_ops.fir_stream(taps, state, x, "fft")
    assert _rel(y, want) < K5_REL_ERR


@pytest.mark.cuda
def test_rtty_bit_filter_runs_fir_valid_on_one_complex_row(dev):
    """DeRTTY at 48 kHz: the AFSK discriminator's two 1,056-tap moving
    averages over one complex row (a 1-D block) take K5 through "auto",
    each against K5's plain version."""
    from csdr_tpu_torch.models import rtty

    rx = rtty.rtty_receiver(48000.0).blocks[0]
    taps = rx.parts[0][1].taps
    assert len(taps) == 1056
    x = _rows(dev, (1, (1 << 16) + 1055), True, seed=9)[0]
    before = k5.launches
    got = k5.fir_valid(x, taps)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    want = k5.fir_valid_ref(x, taps)
    assert got.shape == want.shape == (1 << 16,)
    assert _rel(got, want) < K5_REL_ERR
    audio = torch.randn(1 << 16, device=dev)
    before = k5.launches
    rx.apply(rx.init(dev), audio)
    torch.cuda.synchronize()
    assert k5.launches == before + 2


@pytest.mark.cuda
def test_pocsag_band_monitor_pfb_fused_matches_eager(dev):
    """The band monitor on K4 against the eager channelizer, 2e-3 max
    (tests/test_pallas_fused.py:55): the envelope on every channel, the bit
    score on the paged channels while a page is on the air (on noise the
    discriminator's atan2 turns K4's rounding into a 2π branch flip); both
    leaves trimmed to n/nch, and the same pages decoded on the same
    channels."""
    from csdr_tpu_torch.models import pocsag

    nch, rate = 64, 38400.0
    pages = {3: (1234567, "BAND K4"), 40: (765432, "0123 45")}
    n = nch * 64 * 16 * 56  # 56 blocks of 2^16; a page lasts 1,664 bits (1.39 s)
    t = np.arange(n)
    rng = np.random.default_rng(1)
    x = 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for ch, (ric, text) in pages.items():
        # FSK synthesized at the band's rate, on the channel's centre
        bb = pocsag.pocsag_modulate(pocsag.make_transmission(ric, text), nch * rate)
        seg = slice(100_000, 100_000 + len(bb))
        x[seg] += 0.5 * bb * np.exp(2j * np.pi * np.mod((ch - (nch - 1) / 2) / nch * t[seg], 1.0))
    x = x.astype(np.complex64)
    out = {}
    for backend in ("eager", "pfb_fused"):
        g = pocsag.pocsag_band_monitor(nch, rate, backend=backend)
        sink = ct.CollectSink()
        before = pf.launches["pfb_channelize_fused"]
        ct.Pipeline(g, block_size=nch * 64 * 16, device=dev).run(iter([x]), sink)
        ran = pf.launches["pfb_channelize_fused"] - before
        assert (ran > 0) == (backend == "pfb_fused")
        out[backend] = sink.concat()
    for got, want in zip(out["pfb_fused"], out["eager"]):
        assert got.shape == want.shape == (nch, n // nch)
    (score, env), (score_e, env_e) = out["pfb_fused"], out["eager"]
    assert np.max(np.abs(env - env_e)) < 2e-3
    # the score while a page is on the air: this sample's and the 32 before
    # (the bit filter's window) above the noise
    paged = sorted(pages)
    loud = (env_e[paged] > 0.1).astype(np.float64)
    on_air = np.stack([np.convolve(r, np.ones(33))[:len(r)] for r in loud]) > 32.5
    assert on_air.mean() > 0.4
    assert np.max(np.abs(score[paged] - score_e[paged])[on_air]) < 2e-3
    msgs = pocsag.decode_channels(out["pfb_fused"], rate)
    assert {m["channel"]: (m["ric"], m["text"]) for m in msgs} == pages
    assert msgs == pocsag.decode_channels(out["eager"], rate)


def _nrz_rows(rows, n, k, seed, smooth, cplx=False):
    """Bipolar NRZ rows at k·(1 + ε) samples/symbol, each with its own clock
    offset ε (±100 ppm: under 2 samples of drift per timing window, far from
    the ±k/2 the unwrap allows) and timing phase, read at the rows' sample
    times from an 8× dense grid: the step train itself (``smooth`` False:
    every transition falls between two samples, so the timing tone fits
    near-integer timing and many outputs sit where the window position
    crosses an integer) or its one-symbol moving average.  With ``cplx``
    complex64 rows, I and Q of their own bits on the row's one clock."""
    rng = np.random.default_rng(seed)
    out = np.empty((rows, n), np.complex64 if cplx else np.float32)
    L = 8 * k
    for r in range(rows):
        eps, d0 = rng.uniform(-1e-4, 1e-4), rng.uniform(0, k)
        t = (np.arange(n) + d0) * (1 + eps) * 8
        lanes = []
        for _ in range(2 if cplx else 1):
            bits = rng.integers(0, 2, int(t[-1] // L) + 3) * 2.0 - 1.0
            if smooth:
                c = np.concatenate([[0.0], np.cumsum(np.repeat(bits, L))])
                lanes.append(np.interp(t, np.arange(len(c) - L), (c[L:] - c[:-L]) / L))
            else:
                lanes.append(np.interp(t, np.arange(len(bits) * L), np.repeat(bits, L)))
        out[r] = lanes[0] + 1j * lanes[1] if cplx else lanes[0]
    return out


def _sync_case(case):
    """(block, blocks of input (…, n) as numpy, a state edit or None) of a
    ``test_sym_sync_on_card_matches_cpu`` case."""
    from csdr_tpu_torch.core.block import PerChannel
    from csdr_tpu_torch.models import symsync

    r8 = lambda rows: PerChannel(symsync.sym_sync_r(8, 4, 0.0, 64), rows)  # noqa: E731
    split = lambda x, n: [x[..., b * n:(b + 1) * n] for b in range(x.shape[-1] // n)]  # noqa: E731
    if case in ("steps", "smoothed"):
        return r8(64), split(_nrz_rows(64, 2 << 17, 8, 5, case == "smoothed"), 1 << 17), None
    if case in ("complex", "tracker"):
        # complex NRZ at k = 4: I and Q of their own bits, one clock a row
        x = _nrz_rows(16, 2 << 15, 4, 6, True, cplx=True)
        blk = (symsync.sym_sync_c(3, 4) if case == "complex" else
               symsync.SymSync(4, 3, 0.25, 32, complex_input=True, ftype="rrc",
                               out_per_sym=1, name="symtrack_sync"))
        return PerChannel(blk, 16), split(x, 1 << 15), None
    if case == "single_row":
        return symsync.sym_sync_r(8, 4, 0.0, 64), split(_nrz_rows(1, 2 << 16, 8, 8, True)[0],
                                                        1 << 16), None
    if case == "one_window":      # n < 128·k: one timing window
        return r8(16), split(_nrz_rows(16, 3 * 960, 8, 9, True), 960), None
    # carried states: per row, (τ, valid) of the first block
    rows = 16
    x = split(_nrz_rows(rows, 2 << 14, 8, 10, True), 1 << 14)
    if case == "invalid_tau":     # a carried τ marked invalid is not read
        tau = np.where(np.arange(rows) % 2 == 0, 1e6, 2.7)
        valid = np.arange(rows) % 2 == 1
    elif case == "slip":          # carries past B = 40 slip back by whole symbols
        tau = np.linspace(-47.0, 47.0, rows)
        valid = np.ones(rows, bool)
    else:                         # "edges": windows leave the row at both ends
        tau = np.where(np.arange(rows) % 2 == 0, -300.0, 300.0)
        valid = np.ones(rows, bool)
    return r8(rows), x, (tau.astype(np.float32), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["steps", "smoothed", "complex", "tracker", "single_row",
                                  "one_window", "invalid_tau", "slip", "edges"])
def test_sym_sync_on_card_matches_cpu(dev, case):
    """The block sync on the card (K9, two launches a block) against the
    CPU's plain version, state-chained blocks: 2e-3 relative to the
    largest output (tests/test_sharding_generic.py:346) of the CPU's output
    or, where float order picks (``torch_oracles.record_ties`` at 0.01), of the
    CPU's output of the other pick (tests/test_torch_symsync.py); the
    carried τ within 1e-3 samples.  Real (kaiser, npfb 64) and complex
    (rnyquist npfb 32 two outputs a symbol; ``sym_tracker``'s RRC sync, one)
    panels, one un-batched row, one timing window, an invalid carried τ,
    carries that slip past B and windows that leave the row at both ends
    (a carried τ of ±300 samples)."""
    from torch_oracles import record_ties
    from csdr_tpu_torch.ops.cuda import symsync_block as k9

    blk, xs, edit = _sync_case(case)
    sg, sc = blk.init(dev), blk.init(torch.device("cpu"))
    if edit is not None:
        tau, valid = (torch.from_numpy(v) for v in edit)
        sg, sc = (sg[0], tau.to(dev), valid.to(dev)), (sc[0], tau, valid)
    before = k9.launches
    for b, xb in enumerate(xs):
        xb = torch.from_numpy(np.ascontiguousarray(xb))
        sg, yg = blk.apply(sg, xb.to(dev))
        with record_ties(0.01) as rec:
            sc, yc = blk.apply(sc, xb)
        yg, yc = np.atleast_2d(yg.cpu().numpy()), np.atleast_2d(yc.numpy())
        assert yg.shape == yc.shape, (case, b, yg.shape, yc.shape)
        codes, other = rec[0]
        scale = np.abs(yc).max(axis=1, keepdims=True)
        err = np.minimum(np.abs(yg - yc), np.abs(yg - np.atleast_2d(other))) / scale
        assert err.max() < 2e-3, (case, b, float(err.max()),
                                  np.bincount(np.ravel(codes), minlength=3))
        assert np.abs(sg[1].cpu().numpy() - sc[1].numpy()).max() < 1e-3, (case, b)
        assert torch.equal(sg[0].cpu(), sc[0]) and bool(sg[2].all())
    assert k9.launches - before == 2 * len(xs)
    if case == "slip":
        assert np.abs(sc[1].numpy()).max() <= 40.0


@pytest.mark.cuda
def test_denbfmsync_block_on_card_is_bit_identical_run_to_run(dev):
    """PerChannel(fm_dem_with_sync(10)) over the same 64-row block twice
    from the same state on the card: every output and τ bit for bit (the
    tone's partial sums take a fixed order, with no atomics)."""
    from csdr_tpu_torch.core.block import PerChannel
    from csdr_tpu_torch.models import symsync

    x = occupied_band(64, 64 * 40960, seed=11, per_frame=True).reshape(40960, 64).T.copy()
    blk = PerChannel(symsync.fm_dem_with_sync(10), 64)
    xg = torch.from_numpy(x).to(dev)
    runs = []
    for _ in range(2):
        st = blk.init(dev)
        for _ in range(2):
            st, y = blk.apply(st, xg)
        runs.append((y.cpu(), st[1][1].cpu()))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


class _ThreadTimeCtx:
    """Time rank ``ti`` of ``dt`` ranks run as threads of one process on one
    card: the ``ShardCtx`` exchanges the sync's sharded step uses, through a
    shared board and a barrier (the ranks enqueue on one stream, so a
    tensor a rank hands over is written before the other's later launch
    reads it)."""

    def __init__(self, ti, dt, board):
        self.ti, self.dt, self.board = ti, dt, board

    def _swap(self, t):
        self.board["slots"][self.ti] = t
        self.board["barrier"].wait(timeout=60)
        got = list(self.board["slots"])
        self.board["barrier"].wait(timeout=60)
        return got

    def left_halo(self, x, carried, h):
        got = self._swap(x[..., -h:])
        return carried if self.ti == 0 else got[self.ti - 1]

    def right_halo(self, x, r):
        got = self._swap(x[..., :r])
        if self.ti == self.dt - 1:
            return x[..., -1:].expand(tuple(x.shape[:-1]) + (r,))
        return got[self.ti + 1]

    def all_gather_time(self, t):
        return torch.stack(self._swap(t))

    def from_last_time(self, val):
        return self._swap(val)[-1]


@pytest.mark.cuda
def test_sharded_sym_sync_on_card_equals_serial_kernel(dev):
    """``SymSync.shard_apply`` on the card over two time ranks (threads of
    this process) against serial ``apply`` on the card, two state-chained
    blocks of 16 rows × 2^16: the ranks' tone partials are the serial
    step's window by window and every rank fits the same line, so the
    outputs, τ and the history equal the serial ones bit for bit."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from csdr_tpu_torch.core.block import PerChannel
    from csdr_tpu_torch.models import symsync

    rows, n, dt = 16, 1 << 16, 2
    blk = PerChannel(symsync.sym_sync_r(8, 4, 0.0, 64), rows)
    sync = blk.inner
    x = torch.from_numpy(_nrz_rows(rows, 2 * n, 8, 12, True)).to(dev)
    ss = blk.init(dev)
    sh = [blk.init(dev) for _ in range(dt)]
    board = dict(slots=[None] * dt, barrier=threading.Barrier(dt))
    for b in range(2):
        xb = x[:, b * n:(b + 1) * n]
        ss, ys = blk.apply(ss, xb.contiguous())
        nloc = n // dt

        def rank(ti, b=b, xb=xb, nloc=nloc):
            ctx = _ThreadTimeCtx(ti, dt, board)
            return sync.shard_apply(sh[ti], xb[:, ti * nloc:(ti + 1) * nloc].contiguous(), ctx)

        with ThreadPoolExecutor(dt) as pool:
            outs = [f.result(timeout=120) for f in [pool.submit(rank, ti) for ti in range(dt)]]
        sh = [o[0] for o in outs]
        y = torch.cat([o[1] for o in outs], dim=-1)
        assert torch.equal(y, ys), (b, float((y - ys).abs().max()))
        for st in sh:
            assert torch.equal(st[1], ss[1]) and torch.equal(st[0], ss[0])


@pytest.mark.cuda
def test_denbfmsync_pfb_fused_cli_launches_k4(dev, tmp_path):
    """-c 64 --backend pfb_fused "DeNBFMSync 10" through the CLI on the
    card: K4 launches once per block and no other kernel does; every
    channel's file holds n·2/(64·10) finite samples."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main
    from csdr_tpu_torch.ops.cuda import fft_fir as k6
    from csdr_tpu_torch.ops.cuda import fir_valid as k5

    nch, block, blocks = 64, 64 * 64 * 10 * 4, 3
    x = occupied_band(nch, block * blocks, seed=9, per_frame=True)
    q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 60 + 127.5), 0, 255)
    q.astype(np.uint8).tofile(tmp_path / "cap.cu8")
    before = (dict(pf.launches), ff.launches, k5.launches, k6.launches)
    rc = main(["--filename", str(tmp_path / "cap.cu8"), "-n", str(block * blocks), "-c", str(nch),
               "--demod", "DeNBFMSync 10", "--backend", "pfb_fused", "--blocksize", str(block),
               "-o", str(tmp_path / "s"), "--device", "cuda"])
    assert rc == 0
    assert pf.launches["pfb_channelize_fused"] - before[0]["pfb_channelize_fused"] == blocks
    assert pf.launches["pfb_fm_fused"] == before[0]["pfb_fm_fused"]
    assert (ff.launches, k5.launches, k6.launches) == before[1:]
    for ch in range(1, nch + 1):
        y = np.fromfile(tmp_path / f"s_ch{ch}.f32", np.float32)
        assert y.shape == (block * blocks * 2 // (nch * 10),) and np.isfinite(y).all()


@pytest.mark.cuda
def test_hilbert_blocks_on_card_match_cpu(dev):
    rng = np.random.default_rng(11)
    x = rng.normal(size=3 * 8192).astype(np.float32)
    outs = {}
    for d in (dev, torch.device("cpu")):
        r2c, c2r = ct.real_to_complex(), ct.complex_to_real()
        s1, s2 = r2c.init(d), c2r.init(d)
        cs, rs = [], []
        for blk in np.split(x, 3):
            s1, c = r2c.apply(s1, torch.from_numpy(blk).to(d))
            s2, r = c2r.apply(s2, c)
            cs.append(c.cpu().numpy())
            rs.append(r.cpu().numpy())
        outs[d.type] = (np.concatenate(cs), np.concatenate(rs))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["apt", "sstv", "wefax"])
def test_imagery_chain_on_card_matches_cpu(dev, kind):
    from csdr_tpu_torch.models import apt, sstv, wefax

    rng = np.random.default_rng(12)
    if kind == "apt":
        img = rng.integers(11, 244, size=(4, apt.LINE_WORDS)).astype(np.uint8)
        img[:, :39] = (apt.SYNC_A * 233 + 11).astype(np.uint8)
        fs, rx, first = 8 * apt.WORD_RATE, apt.apt_receiver, 0
        audio = apt.apt_modulate(img, fs)
    elif kind == "sstv":
        fs, rx, first = 11025.0, sstv.sstv_receiver, 180
        audio = sstv.sstv_modulate(rng.integers(0, 256, (2, 320, 3)).astype(np.uint8), fs)
    else:
        fs, rx, first = 12000.0, wefax.wefax_receiver, 180
        audio = wefax.wefax_modulate(rng.integers(0, 256, (2, wefax.PX_PER_LINE))
                                     .astype(np.uint8), fs, phasing_lines=3)
    outs = {}
    for d in ("cuda", "cpu"):
        sink = ct.CollectSink()
        ct.Pipeline(rx(fs), block_size=1 << 15, device=d).run(iter([audio]), sink)
        outs[d] = sink.concat()
    got, want = outs["cuda"], outs["cpu"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got[first:] - want[first:]).max() / np.abs(want).max() < 2e-5


@pytest.mark.cuda
def test_profiled_pfb_fused_pipeline_matches_unprofiled(dev):
    """dc_blocker >> PFBFusedFM (K3) with profile=True: one stage per block,
    the same output bit for bit, K3 launched once per block."""
    from csdr_tpu_torch.models.receivers import channelized_fm_receiver

    nch = 64
    x = occupied_band(nch, nch * 64 * 16 * 3, seed=13, per_frame=True)
    outs = []
    for profile in (False, True):
        pipe = ct.Pipeline(channelized_fm_receiver(nch, backend="pfb_fused"),
                           block_size=nch * 64 * 16, device=dev, profile=profile)
        before = pf.launches["pfb_fm_fused"]
        outs.append(np.concatenate([pipe.process_block(b).cpu().numpy()
                                    for b in np.split(x, 3)], axis=-1))
        assert pf.launches["pfb_fm_fused"] - before == 3
    assert np.array_equal(outs[0], outs[1])
    assert [s.calls for s in pipe.stage_stats] == [3, 3]
    assert "pfb_fused_fm(64)" in pipe.profile_report()


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [False, True], ids=["recording", "profile"])
def test_stage_spans_carry_device_intervals_without_a_barrier(dev, monkeypatch, profile):
    """The recorder on the card (``utils/prof``): each stage span of
    ``Chain.apply`` in a Pipeline step reads a device interval from its CUDA
    events (outside a step, none), the Pipeline's copies are spans of their
    own and counted, and neither ``prof.recording()`` nor ``profile=True``
    calls a device barrier; the output is the unrecorded run's bit for
    bit."""
    from csdr_tpu_torch.models.receivers import channelized_fm_receiver
    from csdr_tpu_torch.utils import prof

    nch = 64
    block = nch * 64 * 16
    x = occupied_band(nch, block * 3, seed=14, per_frame=True)

    def run_once():
        outs = []
        pipe = ct.Pipeline(channelized_fm_receiver(nch), block_size=block, device=dev,
                           profile=profile)
        pipe.run(iter([x]), outs.append)
        return pipe, np.concatenate(outs, axis=-1)

    _, plain = run_once()
    barriers = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: barriers.append(a) or real_sync(*a))
    with prof.recording() as rec:
        pipe, got = run_once()
    assert barriers == [] and np.array_equal(plain, got)
    if profile:
        stats = pipe.stage_stats
        assert [s.calls for s in stats] == [3, 3, 3]
        assert all(s.seconds > 0 and s.host_seconds > 0 for s in stats)
        assert "pipeline.h2d" in pipe.profile_report()
        return
    spans = rec.read()
    applies = {s.id for s in spans if s.name == "pipeline.apply"}
    stages = [s for s in spans if s.parent in applies]
    assert len(stages) == 9 and all(s.device_ms is not None and s.device_ms > 0 for s in stages)
    assert {"pipeline.h2d", "pipeline.d2h"} <= {s.name for s in spans}
    assert rec.counters["pipeline.h2d_bytes"] == 3 * block * 8
    assert rec.counters["pipeline.d2h_bytes"] == 3 * block * 4
    # outside a Pipeline step a stage span records no CUDA events
    graph = channelized_fm_receiver(nch)
    with prof.recording() as rec:
        graph.apply(graph.init(dev), torch.from_numpy(x[:block]).to(dev))
    spans = rec.read()
    assert len(spans) == 3 and all(s.device_ms is None for s in spans)


@pytest.mark.cuda
def test_native_reader_feeds_the_card(dev, tmp_path):
    """The native reader (built with the host's g++ into build/) on the
    card's host: the same samples as the Python reader, and K1 on the
    blocks it reads equals K1 on the Python reader's bit for bit; its
    output written by NativeRawFileSink reads back equal."""
    from csdr_tpu_torch.io import native
    from csdr_tpu_torch.io.sources import cf32_file_source

    nch, n = 64, 64 * 32 * 64
    x = occupied_band(nch, 2 * n, seed=21)
    path = tmp_path / "x.cf32"
    x.tofile(path)
    outs = []
    for reader in (native.native_cf32_source, cf32_file_source):
        state, ys = ff.flagship_fused_init(nch, dev), []
        for blk in reader(str(path), n):
            state, y = ff.flagship_fused_step(state, torch.from_numpy(blk).to(dev), nch=nch)
            ys.append(y.cpu().numpy())
        outs.append(np.concatenate(ys, axis=1))
    assert outs[0].shape == (nch, 2 * n // nch) and np.array_equal(outs[0], outs[1])
    with native.NativeRawFileSink(str(tmp_path / "y.f32")) as sink:
        sink(outs[0])
    assert np.array_equal(np.fromfile(tmp_path / "y.f32", np.float32), outs[0].ravel())


@pytest.mark.cuda
def test_autotune_sweep_on_k1(dev, tmp_path, monkeypatch):
    """utils/autotune.sweep over K1 tiles on the card: a tile whose channel
    tile needs more shared memory than a block has is recorded infeasible;
    FlagshipFused(tileF=None) then takes the winner, within K1's bounds of
    the default tile's output (1.2e-3 max, 4e-5 RMS)."""
    from csdr_tpu_torch.blocks.fused_blocks import FlagshipFused
    from csdr_tpu_torch.utils import autotune

    monkeypatch.setenv("CSDR_TPU_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    nch, n = 64, 64 * 512 * 8
    x = occupied_band(nch, n, seed=22)
    u8 = torch.from_numpy(np.clip(np.round(np.stack([x.real, x.imag], 1) * 60 + 127.5), 0, 255)
                          .astype(np.uint8).reshape(-1)).to(dev)

    def bench(t):
        state = ff.flagship_fused_init(nch, dev)
        state, _ = ff.flagship_fused_step(state, u8, nch=nch, tileF=t)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            state, _ = ff.flagship_fused_step(state, u8, nch=nch, tileF=t)
        b.record()
        torch.cuda.synchronize()
        return n * 5 / a.elapsed_time(b) / 1e3

    best, results = autotune.sweep("flagship_fused", nch, (16, 32, 64, 512), bench)
    by_t = {r["tileF"]: r for r in results}
    assert "shared memory" in by_t[512]["error"]
    assert best in (16, 32, 64) and all("msps" in by_t[t] for t in (16, 32, 64))
    blk = FlagshipFused(nch)
    assert blk.tileF == best and autotune.has_entry("flagship_fused", nch)
    _, got = blk.apply(blk.init(dev), u8)
    _, want = ff.flagship_fused_step(ff.flagship_fused_init(nch, dev), u8, nch=nch)
    d = (got.double() - want.double()).abs()
    assert d.max().item() < 1.2e-3 and d.pow(2).mean().sqrt().item() < 4e-5


CW_NCH, CW_BLOCK = 64, 1 << 20   # -c 64 "DeCW 500 700" at 2.56 MS/s: 585 taps per channel


def _cw_channel_graph():
    return ct.chain(ct.dc_blocker(), ct.firpfbch_channelizer(CW_NCH),
                    ct.PerChannel(ct.cw_demodulator(500.0 / 40000.0, 700.0 / 40000.0), CW_NCH))


def _cw_channel_rank(device, shape, x):
    """One NCCL rank: the -c 64 DeCW channel graph as a ShardedChain over
    three blocks of ``x``; this rank's panels and its K5 launches per step."""
    from csdr_tpu_torch.parallel import ShardedChain, build_mesh

    dt, dc = shape
    rank = torch.distributed.get_rank()
    ti = rank // dc
    sh = ShardedChain(_cw_channel_graph(), build_mesh(dt, dc, "cuda"), CW_BLOCK)
    nloc = CW_BLOCK // dt
    st, outs, launches = sh.init(), [], []
    for b in range(len(x) // CW_BLOCK):
        seg = torch.from_numpy(x[b * CW_BLOCK + ti * nloc:][:nloc].copy()).to(device)
        before = k5.launches
        st, y = sh.step(st, seg)
        torch.cuda.synchronize()
        launches.append(k5.launches - before)
        outs.append(y.cpu().numpy())
    return outs, launches


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_sharded_channel_graph_on_two_cards_launches_k5(dev, shape):
    """PerChannel(DeCW) behind the channelizer on a 2-rank NCCL mesh (time
    or channel axis) equals the serial K5 graph on one card within K5's
    1e-4, and each rank launches K5 once per step on its own panel."""
    from csdr_tpu_torch.parallel import spawn

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one rank per card")
    x = occupied_band(CW_NCH, 3 * CW_BLOCK, seed=31)
    ranks = spawn(_cw_channel_rank, 2, "cuda", args=(shape, x), timeout=600.0)
    g = _cw_channel_graph()
    pipe = ct.Pipeline(g, block_size=CW_BLOCK, device=dev)
    dt, dc = shape
    for b in range(3):
        before = k5.launches
        want = pipe.process_block(x[b * CW_BLOCK:(b + 1) * CW_BLOCK]).cpu().numpy()
        assert k5.launches == before + 1
        rows = [np.concatenate([ranks[ti * dc + ci][0][b] for ti in range(dt)], axis=-1)
                for ci in range(dc)]
        got = np.concatenate(rows, axis=0)
        assert got.shape == want.shape == (CW_NCH, CW_BLOCK // CW_NCH)
        assert np.abs(got - want).max() / np.abs(want).max() < K5_REL_ERR
    for _, launches in ranks:
        assert launches == [1, 1, 1]


FMS_RATE = 200000.0   # -b 200000 "DeFMS 8 WAV" --rds: the RDS data filter's 333 taps on K5


def _fms_rds_graph():
    from csdr_tpu_torch.models.rds import rds_receiver
    from csdr_tpu_torch.models.stereo import stereo_fm_decoder

    return ct.chain(ct.dc_blocker(), ct.fm_demodulator(0.8),
                    ct.Tee(stereo_fm_decoder(FMS_RATE, 8), rds_receiver(FMS_RATE)))


def _fms_rds_capture(n, seed):
    """FM (0.8 of the demod's scale) of a stereo composite with RDS groups
    0A at 200 kHz: L 1 kHz, R 2.5 kHz, the pilot at a seeded phase."""
    from csdr_tpu_torch.models import rds

    rng = np.random.default_rng(seed)
    t = np.arange(n) / FMS_RATE
    pil = 2 * np.pi * 19000.0 * t + rng.uniform(0, 2 * np.pi)
    left, right = 0.6 * np.sin(2 * np.pi * 1000.0 * t), 0.6 * np.sin(2 * np.pi * 2500.0 * t)
    tx = rds.bits_from_groups([rds.make_group_0a(0xC5D7, s, "PORTTEST"[2 * s:2 * s + 2])
                               for s in range(4)])
    bit = np.floor(t * rds.RDS_BAUD).astype(np.int64) % len(tx)
    half = np.floor(t * 2 * rds.RDS_BAUD).astype(np.int64) % 2
    x = (0.45 * (left + right) + 0.1 * np.cos(pil) + 0.45 * (left - right) * np.cos(2 * pil)
         + 0.05 * (tx[bit] * 2.0 - 1.0) * np.where(half == 0, 1.0, -1.0) * np.cos(3 * pil))
    return np.exp(1j * np.cumsum(2 * np.pi * 0.8 * 0.25 * x)).astype(np.complex64)


def _fms_rds_block():
    g = _fms_rds_graph().granule
    return (1 << 20) // (2 * g) * 2 * g


def _fms_rds_rank(device, x):
    """One NCCL rank of a 2x1 mesh: the DeFMS --rds graph as a ShardedChain
    over three blocks of ``x``; this rank's (stereo panel, bits) per step and
    its K5 launches per step."""
    from csdr_tpu_torch.parallel import ShardedChain, build_mesh

    block = _fms_rds_block()
    rank = torch.distributed.get_rank()
    sh = ShardedChain(_fms_rds_graph(), build_mesh(2, 1, "cuda"), block)
    nloc = block // 2
    st, outs, launches = sh.init(), [], []
    for b in range(len(x) // block):
        seg = torch.from_numpy(x[b * block + rank * nloc:][:nloc].copy()).to(device)
        before = k5.launches
        st, (stereo, bits) = sh.step(st, seg)
        torch.cuda.synchronize()
        launches.append(k5.launches - before)
        outs.append((stereo.cpu().numpy(), bits.cpu().numpy()))
    return outs, launches


@pytest.mark.cuda
def test_sharded_defms_rds_on_two_cards_launches_k5(dev):
    """The DeFMS --rds graph (the stereo panel and the RDS bits of one Tee)
    on a 2x1 NCCL mesh: the stereo audio within K5's 1e-4 of the serial
    graph on one card, the RDS bits equal, and each rank launches K5 (the
    333-tap data filter) once per step."""
    from csdr_tpu_torch.parallel import spawn

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one rank per card")
    block = _fms_rds_block()
    x = _fms_rds_capture(3 * block, seed=33)
    ranks = spawn(_fms_rds_rank, 2, "cuda", args=(x,), timeout=600.0)
    g = _fms_rds_graph()
    st = g.init(dev)
    for b in range(3):
        before = k5.launches
        st, (stereo, bits) = g.apply(st, torch.from_numpy(x[b * block:(b + 1) * block]).to(dev))
        torch.cuda.synchronize()
        assert k5.launches == before + 1
        got = np.concatenate([r[0][b][0] for r in ranks], axis=-1)
        got_bits = np.concatenate([r[0][b][1] for r in ranks])
        want = stereo.cpu().numpy()
        assert got.shape == want.shape == (2, block // 8)
        assert np.abs(got - want).max() / np.abs(want).max() < K5_REL_ERR
        assert np.array_equal(got_bits, bits.cpu().numpy())
    for _, launches in ranks:
        assert launches == [1, 1, 1]


def _pilot_rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    w = 2 * np.pi * rng.uniform(18990.0, 19010.0, (rows, 1)) / 192000.0
    p = 0.1 * np.exp(1j * (w * t + rng.uniform(0, 6, (rows, 1))))
    p += 0.01 * (rng.normal(size=(rows, n)) + 1j * rng.normal(size=(rows, n)))
    return p.astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3])
def test_pll_scan_kernel_matches_twin(dev, rows):
    """K7 on rows of 5,000 samples (across kChunk boundaries), two
    state-chained blocks, against its twin on the CPU; one launch per
    block."""
    from csdr_tpu_torch.ops.cuda import pll_scan as k7

    p = _pilot_rows(rows, 10000, rows)
    omega, alpha, beta = 2 * np.pi * 19000.0 / 192000.0, 4 * 9.0 / 192e3, 4 * (9.0 / 192e3) ** 2
    cg = (torch.full((rows,), 0.5, device=dev), torch.zeros(rows, device=dev))
    cc = tuple(c.cpu() for c in cg)
    before = k7.launches
    for b in range(2):
        pb = torch.from_numpy(np.ascontiguousarray(p[:, b * 5000:(b + 1) * 5000]))
        cg, yg = k7.pll_scan(pb.to(dev), cg, omega, alpha, beta)
        cc, yc = k7.pll_scan(pb, cc, omega, alpha, beta)
        torch.cuda.synchronize()
        assert _rel(yg.cpu(), yc) < 2e-3
        assert (cg[0].cpu() - cc[0]).abs().max() < 1e-4
    assert k7.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows", [("real", 5), ("complex", 3)])
def test_symsync_scan_kernel_matches_twin(dev, kind, rows):
    """K8 through SymSyncScan (real k = 10, kaiser; complex k = 4, m = 3,
    rnyquist) on ragged row counts (kWarps = 4 rows per block) of the JAX
    sync tests' signals, three state-chained blocks, against its twin on
    the CPU; one launch per block."""
    from torch_oracles import sync_rows
    from csdr_tpu_torch.models import symsync
    from csdr_tpu_torch.ops.cuda import symsync_scan as k8

    blk = (symsync.sym_sync_r(10, 4, 0.0, 64, mode="scan") if kind == "real"
           else symsync.sym_sync_c(3, 4, mode="scan"))
    x = sync_rows(rows, 3 * 4000, blk.k, 7, kind == "complex")
    sg = tuple(torch.zeros((rows, *leaf.shape), dtype=leaf.dtype, device=dev)
               for leaf in blk.init(dev))
    sc = tuple(leaf.cpu() for leaf in sg)
    before = k8.launches
    for b in range(3):
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * 4000:(b + 1) * 4000]))
        sg, yg = blk.apply(sg, xb.to(dev))
        sc, yc = blk.apply(sc, xb)
        torch.cuda.synchronize()
        assert torch.equal(yg.cpu(), yc), b
        assert all(torch.equal(a.cpu(), c) for a, c in zip(sg[1:], sc[1:]))
    assert k8.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zeros", "carry_high", "carry_low"])
def test_pll_scan_kernel_rare_branches_match_twin(dev, case):
    """K7's rare branches on the card: a row with runs of exact zeros (e
    from the rotated product's signed zeros) and carries of θ = ±20, freq =
    0.5 (the rotated product, then the floored mod), against the twin on
    the CPU, 2e-3 and θ within 1e-4; one launch."""
    from csdr_tpu_torch.ops.cuda import pll_scan as k7

    p = _pilot_rows(2, 6000, 12)
    if case == "zeros":
        p[:, 1000:1300] = 0
        p[1, 5990:] = 0
    th0, fr0 = {"zeros": (1.0, 0.0), "carry_high": (20.0, 0.5), "carry_low": (-20.0, 0.5)}[case]
    omega, alpha, beta = 2 * np.pi * 19000.0 / 192000.0, 4 * 9.0 / 192e3, 4 * (9.0 / 192e3) ** 2
    cc = (torch.full((2,), th0), torch.full((2,), fr0))
    before = k7.launches
    (tg, fg), yg = k7.pll_scan(torch.from_numpy(p).to(dev), tuple(c.to(dev) for c in cc), omega,
                               alpha, beta)
    (tc, fc), yc = k7.pll_scan(torch.from_numpy(p), cc, omega, alpha, beta)
    torch.cuda.synchronize()
    assert _rel(yg.cpu(), yc) < 2e-3
    assert (tg.cpu() - tc).abs().max() < 1e-4 and (fg.cpu() - fc).abs().max() < 1e-6
    assert k7.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind,case", [("real", "wrap"), ("real", "wrap+1"), ("real", "jump"),
                                       ("complex", "wrap")])
def test_symsync_scan_kernel_ring_paths_match_twin(dev, kind, case):
    """K8 where the window leaves its shared-memory ring: a τ that puts the
    first windows before the row's start (their wrapped starts clamp to
    its end), the same one output later (a pair's edge and centre on either
    side), and a carried η of −30 that runs τ back through a 12,000-sample
    row (re-seats chunk after chunk, pairs straddling the ring's edge read
    from the row); against the twin on the CPU, bit for bit, every output
    and τ."""
    from torch_oracles import sync_rows
    from csdr_tpu_torch.models import symsync
    from csdr_tpu_torch.ops.cuda import symsync_scan as k8

    blk = (symsync.sym_sync_r(10, 4, 0.0, 64, mode="scan") if kind == "real"
           else symsync.sym_sync_c(3, 4, mode="scan"))
    n = 12000 if case == "jump" else 4000
    x = torch.from_numpy(sync_rows(2, n, blk.k, 13, kind == "complex"))
    xf = torch.cat([torch.zeros((2, blk.H), dtype=x.dtype), x], dim=-1)
    bank = symsync._bank_on(blk.k, blk.m, blk.npfb, blk.ftype, blk.beta, torch.device("cpu"))
    loop = blk.loop(n)
    tau0 = {"wrap": -(blk.H + 3 * blk.k + 0.25), "wrap+1": -(blk.H + 3 * blk.k + 0.25) - loop.half,
            "jump": 3000.3}[case]
    z = torch.zeros(2, dtype=x.dtype)
    carry = (torch.full((2,), np.float32(tau0)),
             torch.full((2,), np.float32(-30.0 if case == "jump" else 0.0)), z, z)
    cg, yg = k8.symsync_scan(xf.to(dev), bank.to(dev), tuple(c.to(dev) for c in carry), loop)
    cc, yc = k8.symsync_scan(xf, bank, carry, loop)
    torch.cuda.synchronize()
    assert torch.equal(yg.cpu(), yc)
    assert all(torch.equal(a.cpu(), c) for a, c in zip(cg, cc))


# ---- the Pipeline's staging ring (core/runtime._Staging) ---------------------

STAGE_BLOCK = 1 << 15


def _hold_stream(cycles: int):
    """A stage that holds the card's stream for ``cycles`` clock cycles
    ahead of the rest of the graph, then passes its input on."""
    return ct.Lambda(lambda x: (torch.cuda._sleep(cycles), x)[1], "hold")


def _staging_graph(cycles: int = 0):
    stages = [ct.u8_to_iq(), ct.dc_blocker(), ct.fm_demodulator(0.6)]
    return ct.chain(_hold_stream(cycles), *stages) if cycles else ct.chain(*stages)


def _staging_blocks(nblocks: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (STAGE_BLOCK, 2), dtype=np.uint8) for _ in range(nblocks)]


def _fresh_staging(device):
    """The staging step without a ring: each block in a fresh tensor."""
    return lambda chunk: torch.from_numpy(np.array(chunk)).to(device)


@pytest.mark.cuda
def test_staging_ring_waits_for_h2d_copies_still_queued(dev):
    """A stage that holds the stream ~10 ms a block ahead of the graph,
    blocks fed by ``process_block`` with no drain: the host stages block
    k + 2 while block k's H2D copy is still queued behind the hold, so the
    ring must wait on that copy's event before it refills the buffer.  Every
    output equals a fresh buffer's for each block, bit for bit, and every
    block past the first two is staged into a reused buffer."""
    from csdr_tpu_torch.utils import prof

    blocks = _staging_blocks(8, seed=41)
    pipe = ct.Pipeline(_staging_graph(cycles=20_000_000), STAGE_BLOCK, device=dev)
    with prof.recording() as rec:
        got = [pipe.process_block(b) for b in blocks]
    ref = ct.Pipeline(_staging_graph(), STAGE_BLOCK, device=dev)
    ref._staging = _fresh_staging(dev)
    want = [ref.process_block(b) for b in blocks]
    torch.cuda.synchronize()
    for j, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), j
    nbytes = blocks[0].nbytes
    assert rec.counters["pipeline.h2d_bytes"] == 8 * nbytes
    assert rec.counters["pipeline.stage_reused_bytes"] == 6 * nbytes


@pytest.mark.cuda
def test_staging_ring_keeps_two_buffers_over_a_run(dev):
    """``Pipeline.run`` over 50 blocks: the ring's two pinned buffers are
    the ones the first two blocks filled, every later block is staged into
    one of them (``pipeline.stage_reused_bytes`` = ``pipeline.h2d_bytes``
    less the first two blocks' bytes), and the output equals a fresh
    buffer's for each block, bit for bit."""
    from csdr_tpu_torch.utils import prof

    blocks = _staging_blocks(50, seed=42)
    pipe = ct.Pipeline(_staging_graph(), STAGE_BLOCK, device=dev)
    first, got = [], []

    def sink(out):
        got.append(out)
        if not first:   # block 1 is staged when block 0 drains
            first.extend(s[0].data_ptr() for s in pipe._staging.ring)

    with prof.recording() as rec:
        pipe.run(iter(blocks), sink)
    ring = pipe._staging.ring
    assert all(s is not None and s[0].is_pinned() for s in ring)
    assert [s[0].data_ptr() for s in ring] == first and first[0] != first[1]
    nbytes = blocks[0].nbytes
    assert rec.counters["pipeline.h2d_bytes"] == 50 * nbytes
    assert rec.counters["pipeline.stage_reused_bytes"] == 48 * nbytes
    ref = ct.Pipeline(_staging_graph(), STAGE_BLOCK, device=dev)
    ref._staging = _fresh_staging(dev)
    want = []
    ref.run(iter(blocks), want.append)
    assert len(got) == len(want) == 50
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _staging_rank(device, blocks):
    """Rank 0 of a one-card mesh: ``ShardedPipeline`` over ``blocks`` with
    the staging ring, then with a fresh tensor for each block; both runs'
    outputs, the ring's buffers after the first two blocks and after the
    last, and the ring run's counters."""
    from csdr_tpu_torch.parallel import ShardedChain, ShardedPipeline, build_mesh
    from csdr_tpu_torch.utils import prof

    mesh = build_mesh(1, 1, "cuda")
    runner = ShardedPipeline(ShardedChain(_staging_graph(), mesh, STAGE_BLOCK))
    got, first = [], []

    def sink(out):
        got.append(out)
        if len(got) == 2:
            first.extend(s[0].data_ptr() for s in runner._staging.ring)

    with prof.recording() as rec:
        runner.run(iter(blocks), sink)
    last = [s[0].data_ptr() for s in runner._staging.ring]
    fresh = ShardedPipeline(ShardedChain(_staging_graph(), mesh, STAGE_BLOCK))
    fresh._staging = _fresh_staging(device)
    want = []
    fresh.run(iter(blocks), want.append)
    return (got, want), first, last, dict(rec.counters)


@pytest.mark.cuda
def test_sharded_pipeline_stages_through_the_ring(dev):
    """Rank 0 of ``ShardedPipeline`` (a one-card NCCL mesh) stages through
    the same ring: its two buffers stay the ones the first two blocks
    filled over 50 blocks, every later block is staged into one of them,
    and the output equals a fresh tensor's for each block, bit for bit."""
    from csdr_tpu_torch.parallel import spawn

    blocks = _staging_blocks(50, seed=43)
    [(runs, first, last, counters)] = spawn(_staging_rank, 1, "cuda", args=(blocks,),
                                            timeout=600.0)
    assert last == first and len(set(first)) == 2
    nbytes = blocks[0].nbytes
    assert counters["pipeline.h2d_bytes"] == 50 * nbytes
    assert counters["pipeline.stage_reused_bytes"] == 48 * nbytes
    got, want = runs
    assert len(got) == len(want) == 50
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
