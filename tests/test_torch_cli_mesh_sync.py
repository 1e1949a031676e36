"""The port's CLI with ``--mesh`` for DeNBFMSync on gloo ranks against the
serial CLI's ``.f32`` files: ``-c 8`` (``dc_blocker >>
firpfbch_channelizer(8) >> PerChannel(fm_dem_with_sync(10))``, the channel
layout) on 2x1 and 2x2, and ``-c 1`` on 2x1.  The sync's outputs are held
within 2e-3 of the serial output or of its other pick where float order
picks (``torch_oracles.record_ties`` around the serial run,
tests/test_sharding_generic.py:346), on full blocks only (the captures are
whole blocks long: a zero-padded last block's line fit reads atan2 of
rounding).  The flows run through the CLI's rank function on module-scoped
ranks while this process runs the serial CLI; the ranks import this
module, so it imports no JAX."""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from csdr_tpu_torch.apps import soapy_sdr_cli as cli
from csdr_tpu_torch.parallel import spawn

torch.set_num_threads(1)

K, NCH, FS = 10, 8, 256_000
TOL = 2e-3
# name → (argv, per-channel files, blocks of --blocksize, --blocksize)
FLOWS = {
    "-c 8": (["-c", str(NCH)], NCH, 2, 40960),
    "-c 1": (["-c", "1"], 1, 2, 10240),
}
MESHES = {"-c 8": ["2x1", "2x2"], "-c 1": ["2x1"]}


def fsk_capture(nch, n, seed):
    """2-FSK at the DeNBFMSync deviation (±0.1 cycles per channel sample at
    k = 10) on every channel centre of an nch-way split (nch = 1: at DC),
    each with its own bits, symbol phase and carrier phase, over light
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for c in range(nch):
        spb = K * nch
        lv = np.repeat(rng.integers(0, 2, n // spb + 2) * 2.0 - 1.0, spb)
        d = int(rng.integers(0, spb))
        fc = (c - (nch - 1) / 2) / nch
        cyc = np.cumsum(lv[d:d + n] * 0.02 * K * 0.5 / nch) + fc * t + rng.uniform()
        x = x + 0.3 * np.exp(2j * np.pi * np.mod(cyc, 1.0))
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_sync")
    out = {}
    for name, (_, nch, blocks, block) in FLOWS.items():
        path = d / f"sync{nch}.cf32"
        fsk_capture(nch, blocks * block, 40 + nch).tofile(path)
        out[name] = str(path)
    return out


def _argv(captures, name, out):
    argv, _, blocks, block = FLOWS[name]
    return ["--filename", captures[name], "-s", str(FS), "-n", str(blocks * block),
            "--blocksize", str(block), *argv, "--demod", f"DeNBFMSync {K}", "-o", out,
            "--device", "cpu"]


def _mesh_flows(device, captures, outdir, mesh):
    torch.set_num_threads(1)
    for name in FLOWS:
        if mesh in MESHES[name]:
            opts = cli.build_parser().parse_args(
                _argv(captures, name, os.path.join(outdir, f"{mesh}_{name[3:]}"))
                + ["--mesh", mesh])
            cli._mesh_rank(device, opts, cli.parse_demod(opts.demod), None)
    return True


def _read(prefix, files):
    if files == 1:
        return np.fromfile(prefix + ".f32", np.float32)[None]
    return np.stack([np.fromfile(f"{prefix}_ch{i}.f32", np.float32)
                     for i in range(1, files + 1)])


def _meshes(captures, outdir):
    for mesh in ("2x1", "2x2"):
        world = int(mesh[0]) * int(mesh[2])
        spawn(_mesh_flows, world, "cpu", (captures, outdir, mesh), 300.0)


@pytest.fixture(scope="module")
def runs(captures, tmp_path_factory):
    """The mesh ranks in a thread (2x1, then 2x2) while the serial CLI runs
    each flow here inside ``record_ties``: {flow: (serial (files, n), the
    serial run's other picks (files, n), {mesh: (files, n)})}."""
    from torch_oracles import record_ties

    outdir = str(tmp_path_factory.mktemp("mesh_sync_out"))
    serial = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        meshes = pool.submit(_meshes, captures, outdir)
        for name, (_, files, _, _) in FLOWS.items():
            prefix = os.path.join(outdir, f"serial_{name[3:]}")
            with record_ties() as rec:
                assert cli.main(_argv(captures, name, prefix)) == 0
            other = np.concatenate([np.reshape(r[1], (files, -1)) for r in rec], axis=-1)
            serial[name] = (_read(prefix, files), other)
        meshes.result()
    return {name: (*serial[name], {m: _read(os.path.join(outdir, f"{m}_{name[3:]}"),
                                            FLOWS[name][1]) for m in MESHES[name]})
            for name in FLOWS}


CASES = [(name, mesh) for name in FLOWS for mesh in MESHES[name]]


@pytest.mark.parametrize("name,mesh", CASES, ids=[f"{n[1:].replace(' ', '')}-{m}"
                                                  for n, m in CASES])
def test_sync_mesh_matches_serial_cli(runs, name, mesh):
    """Every channel's .f32 of the mesh run within 2e-3 of the serial
    channel's largest output, against its output or its other pick."""
    want, other, got = runs[name][0], runs[name][1], runs[name][2][mesh]
    _, files, blocks, block = FLOWS[name]
    n = blocks * block // files // K * 2
    assert want.shape == other.shape == got.shape == (files, n)
    for c in range(files):
        scale = np.abs(want[c]).max()
        assert scale > 0.1, c
        err = np.minimum(np.abs(got[c] - want[c]), np.abs(got[c] - other[c])) / scale
        assert err.max() < TOL, (c, float(err.max()), int((err >= TOL).sum()))
