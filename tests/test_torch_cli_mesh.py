"""The port's CLI with ``--mesh TxC -c 1`` (the generic sharded chain,
parallel/generic.ShardedChain) on gloo ranks against the serial CLI's
files, and the flows that still refuse ``--mesh``.

Each admitted flow (DeNBFM, DeWBFM, DeAM, DeUSB, DeLSB, DeCW with --offset
and -b 48000, -a DeNo) runs through the CLI's own rank function
(``_mesh_rank``) on one module-scoped pair of ranks, while this process
runs the serial CLI; two flows also run whole through ``main`` (the parent's
static check, then ``spawn``), one of them on a 2x2 mesh (the time layout
replicated over 'ch').  Bound: 2e-3 relative to the largest output
(tests/test_sharding_generic.py:60)."""

import concurrent.futures
import os

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
    (["-c", "1", "--demod", "DeFMS 8 WAV"], 2, "not yet ported in csdr_tpu_torch"),
    (["-c", "1", "--demod", "DeNBFMSync 10"], 2, "not yet ported in csdr_tpu_torch"),
    (["-c", "4", "--demod", "DeCW 500 700 WAV"], 2, "not yet ported in csdr_tpu_torch"),
    (["-c", "4", "-m", "--demod", "DeNBFM 0.6 WAV"], 2, "not yet ported in csdr_tpu_torch"),
    (["-c", "1", "--demod", "DeAIS"], 2, "not yet ported in csdr_tpu_torch"),
    (["-c", "1", "--offset", "94300", "-b", "48000", "--demod", "DeCW 500 700 WAV",
      "--blocksize", "1024", "--mesh", "4x1"], 1,
     "--mesh: invalid configuration (cw_lp(0.01042): local segment 256 shorter than its "
     "700-sample halo"),
], ids=["DeFMS", "DeNBFMSync", "-c 4 DeCW", "-m", "DeAIS", "halo"])
def test_mesh_refusals(capture, tmp_path, capsys, extra, code, why):
    """Refused before any rank starts, with a message and no traceback."""
    argv = ["--filename", capture, "-o", str(tmp_path / "x"), "--device", "cpu", *extra]
    if "--mesh" not in argv:
        argv += ["--mesh", "2x1"]
    assert cli.main(argv) == code
    err = capsys.readouterr().err
    assert why in err and "Traceback" not in err, err
    assert not os.listdir(tmp_path)


def test_mesh_refuses_a_block_that_cannot_be_time_sharded(capture, tmp_path, capsys,
                                                          monkeypatch):
    """A graph whose block cannot be time-sharded in this port (here the
    channelizer, as a -c 1 graph) prints the JAX CLI's "this flow cannot be
    time-sharded" and exits 1."""
    from csdr_tpu_torch import blocks as B
    from csdr_tpu_torch.core.block import chain

    monkeypatch.setattr(cli, "_graph", lambda *a: chain(B.dc_blocker(),
                                                       B.firpfbch_channelizer(8)))
    argv = ["--filename", capture, "-c", "1", "-o", str(tmp_path / "x"), "--device", "cpu",
            "--demod", "DeAM WAV", "--mesh", "2x1"]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert ("--mesh: this flow cannot be time-sharded (pfb_channelizer(8): sharded execution "
            "of PFBChannelizer is not yet ported in csdr_tpu_torch)") in err
    assert "Traceback" not in err and not os.listdir(tmp_path)
