"""The port's CLI with ``--mesh TxC`` over the generic sharded chain
(parallel/generic.ShardedChain) on gloo ranks against the serial CLI's
files, and the configurations that ``--mesh`` refuses.

Each admitted -c 1 flow (DeNBFM, DeWBFM, DeAM, DeUSB, DeLSB, DeCW with
--offset and -b 48000, -a DeNo) runs through the CLI's own rank function
(``_mesh_rank``) on one module-scoped pair of ranks, while this process
runs the serial CLI; two flows also run whole through ``main`` (the parent's
static check, then ``spawn``), one of them on a 2x2 mesh (the time layout
replicated over 'ch').  The -c 8 flows (DeAM, DeCW, -a DeNo, DeWBFM, DeUSB,
-m DeNBFM: the channel layout, ``dc_blocker >> firpfbch_channelizer >>
PerChannel(...) [>> MixChannels]``) run the same way on 2x1 and 1x2 against
the serial ``--backend eager`` CLI, and DeCW whole through ``main`` on 2x2
against the JAX CLI's ``--mesh 2x2`` files.  Bound: 2e-3 relative to the
largest output (tests/test_sharding_generic.py:60)."""

import concurrent.futures
import os
import re

import numpy as np
import pytest
import torch

from csdr_tpu_torch.apps import soapy_sdr_cli as cli
from csdr_tpu_torch.parallel import spawn

torch.set_num_threads(1)

FS = 2_560_000
N_IN = 163_840
# every rank's segment holds samples: 8192-sample blocks at the input rate,
# 2048 at 48 kHz (its 1024-sample segments cover DeCW's 700-sample halo)
FULL = ["--blocksize", "8192"]
AT48K = ["-b", "48000", "--blocksize", "2048", "-n", "3000"]

# name → (argv after the capture, output extension, samples out)
FLOWS = {
    "DeNBFM": (["--demod", "DeNBFM 0.6 WAV", "-n", str(N_IN - 1000), *FULL], "wav",
               N_IN - 1000),
    "DeWBFM": (["-b", "200000", "--demod", "DeWBFM 8 WAV", "-n", "12000", *FULL], "wav", 1500),
    "DeAM": (["--demod", "DeAM F32", "-n", str(N_IN), *FULL], "f32", N_IN),
    "DeUSB": (["--offset", "95000", "--demod", "DeUSB 3000 WAV", *AT48K], "wav", 3000),
    "DeLSB": (["--offset", "95000", "--demod", "DeLSB 3000 WAV", *AT48K], "wav", 3000),
    "DeCW": (["--offset", "94300", "--demod", "DeCW 500 700 WAV", *AT48K], "wav", 3000),
    "DeNo -a": (["-a", "-60", "--demod", "DeNo", "-n", str(N_IN - 24), *FULL], "cf32",
                N_IN - 24),
}


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A cu8 capture at 2.56 MS/s: a wideband FM station at DC (75 kHz
    deviation), a keyed carrier at +95 kHz, noise."""
    d = tmp_path_factory.mktemp("cli_mesh")
    rng = np.random.default_rng(41)
    t = np.arange(N_IN)
    msg = np.cumsum(np.sin(2 * np.pi * 1000.0 / FS * t)) * (2 * np.pi * 75e3 / FS)
    x = 0.35 * np.exp(1j * np.mod(msg, 2 * np.pi))
    key = (np.floor(t / 20000) % 3 != 2).astype(float)
    x = x + 0.2 * key * np.exp(2j * np.pi * np.mod(95000.0 / FS * t, 1.0))
    x = x + 0.01 * (rng.normal(size=N_IN) + 1j * rng.normal(size=N_IN))
    q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 127.5 + 127.5), 0, 255)
    path = d / "cap.cu8"
    q.astype(np.uint8).tofile(path)
    return str(path)


def _argv(capture, name, out):
    argv, _, _ = FLOWS[name]
    return ["--filename", capture, "-s", str(FS), "-c", "1", "-o", out, *argv,
            "--device", "cpu"]


def _mesh_flows(device, capture, outdir):
    """One gloo rank: every flow through the CLI's rank function on a 2x1
    mesh, as ``_run_mesh`` spawns it."""
    torch.set_num_threads(1)
    for name in FLOWS:
        opts = cli.build_parser().parse_args(
            _argv(capture, name, os.path.join(outdir, f"mesh_{name.replace(' ', '_')}"))
            + ["--mesh", "2x1"])
        demod = cli.parse_demod(opts.demod)
        cli._mesh_rank(device, opts, demod, opts.agc if opts.agc != 0.0 else None)
    return True


def _read(path, ext):
    if ext == "wav":
        return np.fromfile(path, "<f4", offset=44)
    return np.fromfile(path, "<c8" if ext == "cf32" else "<f4")


@pytest.fixture(scope="module")
def runs(capture, tmp_path_factory):
    """The mesh ranks in a thread while the serial CLI writes each flow's
    file here: {flow: (serial samples, mesh samples)}."""
    outdir = str(tmp_path_factory.mktemp("cli_mesh_out"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        mesh = pool.submit(spawn, _mesh_flows, 2, "cpu", (capture, outdir), 300.0)
        for name in FLOWS:
            assert cli.main(_argv(capture, name, os.path.join(
                outdir, f"serial_{name.replace(' ', '_')}"))) == 0, name
        mesh.result()
    out = {}
    for name, (_, ext, _) in FLOWS.items():
        stem = name.replace(" ", "_")
        out[name] = tuple(_read(os.path.join(outdir, f"{k}_{stem}.{ext}"), ext)
                          for k in ("serial", "mesh"))
    return out


@pytest.mark.parametrize("name", list(FLOWS))
def test_mesh_flow_matches_serial_cli(runs, name):
    serial, mesh = runs[name]
    assert serial.shape == mesh.shape == (FLOWS[name][2],), (serial.shape, mesh.shape)
    assert np.abs(serial).max() > 0
    err = np.abs(mesh.astype(np.complex128) - serial).max() / np.abs(serial).max()
    print(f"{name}: {err:.3g}")
    assert err < 2e-3, (name, err)


@pytest.mark.parametrize("name,mesh", [("DeCW", "2x1"), ("DeNo -a", "2x2")])
def test_mesh_cli_main_matches_serial(capture, runs, tmp_path, capsys, name, mesh):
    """The whole CLI: the parent validates the graph, spawns the ranks, and
    rank 0 writes the file; -v prints each rank's kernel launches."""
    _, ext, n = FLOWS[name]
    out = str(tmp_path / "m")
    assert cli.main(_argv(capture, name, out) + ["--mesh", mesh, "-v"]) == 0
    got = _read(f"{out}.{ext}", ext)
    serial = runs[name][0]
    assert got.shape == serial.shape == (n,)
    assert np.abs(got.astype(np.complex128) - serial).max() / np.abs(serial).max() < 2e-3


@pytest.mark.parametrize("extra,code,why", [
    (["-c", "1", "--demod", "DeFMS 8 WAV", "--mesh", "2x2"], 1,
     "--mesh: invalid configuration (stereo_fm(2560000,8): stereo output (2, n) shards over "
     "time only: use a mesh with ch=1)"),
    (["-c", "1", "--demod", "DeNBFMSync 10", "--blocksize", "1280", "--mesh", "4x1"], 1,
     "--mesh: invalid configuration (symsync_r(k=10): 2 timing sub-windows cannot align with "
     "4 time shards"),
    (["-c", "4", "--demod", "DeCW 500 700 WAV", "--mesh", "1x3"], 1,
     "--mesh: invalid configuration (pfb_channelizer(4): nch=4 not divisible by the 3-way "
     "channel mesh axis)"),
    (["-c", "6", "-m", "--demod", "DeNBFM 0.6 WAV", "--mesh", "2x4"], 1,
     "--mesh: invalid configuration (pfb_channelizer(6): nch=6 not divisible by the 4-way "
     "channel mesh axis)"),
    (["-c", "4", "--demod", "DeAIS"], 1, "DeAIS does not support channel splitting"),
    (["-c", "1", "--offset", "94300", "-b", "48000", "--demod", "DeCW 500 700 WAV",
      "--blocksize", "1024", "--mesh", "4x1"], 1,
     "--mesh: invalid configuration (cw_lp(0.01042): local segment 256 shorter than its "
     "700-sample halo"),
], ids=["DeFMS", "DeNBFMSync", "-c 4 DeCW", "-m", "DeAIS", "halo"])
def test_mesh_refusals(capture, tmp_path, capsys, extra, code, why):
    """Refused before any rank starts, with the JAX CLI's message and no
    traceback: the stereo decoder on a mesh with C > 1 (time only), a sync
    block whose timing windows do not align with the time ranks, a packet
    flow with -c N, a channel count that the C axis does not divide (-c N
    DeCW, -c N -m DeNBFM), a block too short for a halo."""
    argv = ["--filename", capture, "-o", str(tmp_path / "x"), "--device", "cpu", *extra]
    if "--mesh" not in argv:
        argv += ["--mesh", "2x1"]
    assert cli.main(argv) == code
    err = capsys.readouterr().err
    assert why in err and "Traceback" not in err, err
    assert not os.listdir(tmp_path)


def test_mesh_refuses_a_block_that_cannot_be_time_sharded(capture, tmp_path, capsys,
                                                          monkeypatch):
    """A graph with a block that has no shard methods (here the symbol
    tracker's power normalizer, as a -c 1 graph) prints the JAX CLI's "this
    flow cannot be time-sharded" and exits 1."""
    from csdr_tpu_torch import blocks as B
    from csdr_tpu_torch.core.block import chain
    from csdr_tpu_torch.models.symsync import sym_tracker

    monkeypatch.setattr(cli, "_graph", lambda *a: chain(B.dc_blocker(), sym_tracker(3, 4)))
    argv = ["--filename", capture, "-c", "1", "-o", str(tmp_path / "x"), "--device", "cpu",
            "--demod", "DeAM WAV", "--mesh", "2x1"]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert ("--mesh: this flow cannot be time-sharded (_PowerNormalize (pwr_norm) does not "
            "support sharded execution)") in err
    assert "Traceback" not in err and not os.listdir(tmp_path)


# ---- -c N: the channel layout -------------------------------------------------

FS8 = 256_000          # 32 kHz channels: every inner FIR's halo fits a rank's frames
N8 = 3 * 16384 + 512   # a short last block, padded and trimmed
CH_MESHES = ["2x1", "1x2"]
CH_COMMON = ["-s", str(FS8), "-c", "8", "-n", str(N8), "--blocksize", "8192"]

# name → (argv, output extension, per-channel files (False: one mixed file),
#         samples out per file)
CH_FLOWS = {
    "DeAM": (["--demod", "DeAM WAV"], "wav", True, N8 // 8),
    "DeCW": (["--demod", "DeCW 500 700 WAV"], "wav", True, N8 // 8),
    "DeNo -a": (["-a", "-60", "--demod", "DeNo"], "cf32", True, N8 // 8),
    "DeWBFM": (["--demod", "DeWBFM 4 F32"], "f32", True, N8 // 32),
    "DeUSB": (["--demod", "DeUSB 3000 WAV"], "wav", True, N8 // 8),
    "-m DeNBFM": (["-m", "--demod", "DeNBFM 0.6 WAV"], "wav", False, N8 // 8),
}


@pytest.fixture(scope="module")
def capture8(tmp_path_factory):
    """A cu8 capture at 256 kS/s with an FM carrier near every channel's
    centre (no channel near zero, where atan2 amplifies rounding; every
    channel far above the -60 dB squelch), and noise."""
    d = tmp_path_factory.mktemp("cli_mesh_ch")
    rng = np.random.default_rng(43)
    t = np.arange(N8)
    x = 0.01 * (rng.normal(size=N8) + 1j * rng.normal(size=N8))
    for k in range(8):
        f = (k - 3.5) / 8 + 0.01
        x = x + 0.1 * np.exp(1j * (2 * np.pi * np.mod(f * t, 1.0)
                                   + 1.5 * np.sin(2 * np.pi * 0.003 * (1 + k % 3) * t)))
    q = np.clip(np.round(np.stack([x.real, x.imag], 1) * 127.5 + 127.5), 0, 255)
    path = d / "cap8.cu8"
    q.astype(np.uint8).tofile(path)
    return str(path)


def _argv8(capture8, name, out):
    return ["--filename", capture8, "-o", out, *CH_COMMON, *CH_FLOWS[name][0], "--device", "cpu"]


def _stem(name, kind):
    return f"{kind}_{name.replace(' ', '_').replace('-', '')}"


def _read8(prefix, name):
    _, ext, per_channel, _ = CH_FLOWS[name]
    if not per_channel:
        return _read(f"{prefix}.{ext}", ext)[None]
    return np.stack([_read(f"{prefix}_ch{i}.{ext}", ext) for i in range(1, 9)])


def _mesh_flows8(device, capture8, outdir, mesh):
    """One gloo rank: every -c 8 flow through the CLI's rank function on
    ``mesh``, as ``_run_mesh`` spawns it."""
    torch.set_num_threads(1)
    for name in CH_FLOWS:
        opts = cli.build_parser().parse_args(
            _argv8(capture8, name, os.path.join(outdir, _stem(name, f"mesh{mesh}")))
            + ["--mesh", mesh])
        demod = cli.parse_demod(opts.demod)
        cli._mesh_rank(device, opts, demod, opts.agc if opts.agc != 0.0 else None)
    return True


@pytest.fixture(scope="module")
def runs8(capture8, tmp_path_factory):
    """The -c 8 flows on each mesh (their ranks in a thread) while this
    process runs the serial --backend eager CLI: {(flow, mesh): (serial,
    mesh) arrays, (files or 1, samples)}."""
    outdir = str(tmp_path_factory.mktemp("cli_mesh_ch_out"))

    def meshes():
        for mesh in CH_MESHES:
            spawn(_mesh_flows8, 2, "cpu", (capture8, outdir, mesh), 300.0)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        done = pool.submit(meshes)
        for name in CH_FLOWS:
            assert cli.main(_argv8(capture8, name, os.path.join(outdir, _stem(name, "serial")))
                            + ["--backend", "eager"]) == 0, name
        done.result()
    return {(name, mesh): (_read8(os.path.join(outdir, _stem(name, "serial")), name),
                           _read8(os.path.join(outdir, _stem(name, f"mesh{mesh}")), name))
            for name in CH_FLOWS for mesh in CH_MESHES}


@pytest.mark.parametrize("mesh", CH_MESHES)
@pytest.mark.parametrize("name", list(CH_FLOWS))
def test_channel_mesh_flow_matches_serial_cli(runs8, name, mesh):
    """-c 8 --mesh TxC (ShardedChain over the eager graph) writes the
    serial --backend eager CLI's files within 2e-3: every channel, every
    sample, the short last block trimmed to the serial count."""
    serial, got = runs8[(name, mesh)]
    _, _, per_channel, n = CH_FLOWS[name]
    assert serial.shape == got.shape == ((8 if per_channel else 1), n), (serial.shape, got.shape)
    assert all(np.abs(row).max() > 0 for row in serial)
    err = np.abs(got.astype(np.complex128) - serial).max() / np.abs(serial).max()
    print(f"-c 8 {name} on {mesh}: {err:.3g}")
    assert err < 2e-3, (name, mesh, err)


def test_channel_mesh_main_matches_jax_cli(capture8, tmp_path, capfd, monkeypatch):
    """The whole CLI at 2x2 (the parent's check, four spawned ranks, rank
    0's per-channel files) against the JAX CLI's --mesh 2x2 files of the
    same -c 8 DeCW flow: equal byte counts, 2e-3; -v prints each rank's
    kernel launches and the count per channel."""
    from csdr_tpu.apps.soapy_sdr_cli import main as jax_main

    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")
    argv = _argv8(capture8, "DeCW", str(tmp_path / "p"))
    assert cli.main(argv + ["--mesh", "2x2", "-v"]) == 0
    out = capfd.readouterr().out   # the ranks' processes write to the descriptor
    assert "over mesh 2x2 (ShardedChain, cpu)" in out and " per channel " in out
    # four processes share the descriptor: find each rank's line wherever it lands
    assert set(re.findall(r"Kernel launches on rank (\d): \{", out)) == {"0", "1", "2", "3"}
    assert jax_main(["--filename", capture8, "-o", str(tmp_path / "j"), *CH_COMMON,
                     *CH_FLOWS["DeCW"][0], "--mesh", "2x2"]) == 0
    for i in range(1, 9):
        assert (os.path.getsize(tmp_path / f"p_ch{i}.wav")
                == os.path.getsize(tmp_path / f"j_ch{i}.wav")), i
    got, want = _read8(str(tmp_path / "p"), "DeCW"), _read8(str(tmp_path / "j"), "DeCW")
    assert got.shape == want.shape == (8, N8 // 8)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-3


def test_channel_mesh_mix_ignores_play(capture8, runs8, tmp_path, capsys):
    """--play under --mesh -c N -m: the mixed file is written and nothing
    plays (the JAX CLI's sharded mix does not play either); stderr says so."""
    out = str(tmp_path / "m")
    argv = _argv8(capture8, "-m DeNBFM", out) + ["--mesh", "2x1", "--play",
                                                  "sh -c 'cat > played.raw'"]
    assert cli.main(argv) == 0
    assert "--play ignored" in capsys.readouterr().err
    got = _read8(out, "-m DeNBFM")
    serial = runs8[("-m DeNBFM", "2x1")][0]
    assert got.shape == serial.shape
    assert np.abs(got - serial).max() / np.abs(serial).max() < 2e-3
    assert not os.path.exists("played.raw")
