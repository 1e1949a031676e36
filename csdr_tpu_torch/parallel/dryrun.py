"""One sharded step of each receiver on an n-rank mesh, shapes asserted.

Counterpart of ``__graft_entry__.dryrun_multichip``: one
``ShardedChannelizedFM`` step with the audio decimator, two
``ShardedFlagship`` steps on cu8 input (the second takes the first's
carried state), and one ``ShardedChain`` step each of the WBFM chain, the
USB chain, a multi-rate Tee and the symbol-sync flow (``fm_dem_with_sync(4)``
on a block that gives the estimator its 8 timing windows: the gathered
window sums and the right halo) on ones.

    python -m csdr_tpu_torch.parallel.dryrun 4 cpu
"""

from __future__ import annotations

import sys

import torch

from .mesh import build_mesh, make_mesh, spawn

__all__ = ["dryrun_multichip"]


def _chain_steps(mesh, device: torch.device) -> tuple:
    """One ShardedChain step on ones of the WBFM, USB, multi-rate Tee and
    symbol-sync graphs; this rank's output shapes, each checked."""
    from .. import blocks as B
    from ..core.block import Tee, chain
    from ..models.symsync import fm_dem_with_sync
    from .generic import ShardedChain

    dt = mesh.shape[0]
    wbfm = chain(B.resampler(0.5), B.dc_blocker(), B.wbfm_demodulator(128_000.0, 2))
    usb = chain(B.dc_blocker(), B.ssb_demodulator("usb", 0.0125))
    tee = chain(B.dc_blocker(),
                Tee(chain(B.fir_filter_c_kaiser(33, 0.2), B.fir_decimator(4, complex_input=True)),
                    B.fir_filter_c_kaiser(17, 0.45)))
    sync = chain(fm_dem_with_sync(4))
    halo = max(b.tail_len for b in usb.blocks if hasattr(b, "tail_len"))
    # the sync's 8 sub-windows of 64 symbols each, whole on every rank
    sblock = -(-max(dt * sync.granule, 64 * 4 * 8) // (dt * sync.granule)) * dt * sync.granule
    shapes = []
    for graph, block, want in (
            (wbfm, dt * wbfm.granule * max(1, 2048 // wbfm.granule), lambda n: [(n // 4,)]),
            (usb, dt * max(4096, halo + 256), lambda n: [(n,)]),
            (tee, dt * 4 * 512, lambda n: [(n // 4,), (n,)]),
            (sync, sblock, lambda n: [(n // 4 * 2,)])):
        sh = ShardedChain(graph, mesh, block)
        x = torch.ones(block // dt, dtype=torch.complex64, device=device)
        _, y = sh.step(sh.init(), x)
        got = [tuple(t.shape) for t in (y if isinstance(y, tuple) else (y,))]
        if got != want(block // dt):
            raise RuntimeError(f"{graph.name} step: outputs of shapes {got}")
        shapes.append(tuple(got))
    return tuple(shapes)


def _rank(device: torch.device, n: int) -> tuple:
    from .channelized import ShardedChannelizedFM
    from .flagship import ShardedFlagship

    mesh = make_mesh(n, device.type)
    dt, dc = mesh.shape
    nch = max(8, dc * 4)
    # 80 frames per time rank: the smallest multiple of audio_decim that
    # covers the audio decimator's 40-frame halo
    block = dt * nch * 80
    sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=block, audio_decim=2)
    x = torch.ones(block // dt, dtype=torch.complex64, device=device)
    _, y = sh.step(sh.init(), x)
    if y.shape != (nch // dc, block // dt // nch // 2):
        raise RuntimeError(f"channelized step: audio of shape {tuple(y.shape)}")

    # the flagship kernel over a pure time axis of all n ranks, cu8 rows
    tmesh = build_mesh(n, 1, device.type)
    fnch, ftile = 64, 32
    fblock = n * fnch * ftile
    sf = ShardedFlagship(tmesh, nch=fnch, block_size=fblock, tileF=ftile)
    fx = torch.tensor([137, 120], dtype=torch.uint8, device=device).repeat(fblock // n, 1)
    state, fy = sf.step(sf.init(), fx)
    state, fy = sf.step(state, fx)      # the carried-state hand-off
    if fy.shape != (fnch, fblock // n // fnch):
        raise RuntimeError(f"flagship step: audio of shape {tuple(fy.shape)}")
    chains = _chain_steps(mesh, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (dt, dc), tuple(y.shape), tuple(fy.shape), chains


def dryrun_multichip(n: int, device_type: str = "cuda") -> list:
    """Run the dry run on n local ranks (NCCL on ``"cuda"``, one card each;
    gloo on ``"cpu"``); returns each rank's (mesh shape, channelized
    output shape, flagship output shape, the ShardedChain steps' output
    shapes)."""
    return spawn(_rank, n, device_type, args=(n,), timeout=600.0)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    out = dryrun_multichip(n, sys.argv[2] if len(sys.argv) > 2 else "cuda")
    print(f"dryrun_multichip({n}) ok: {out[0]}")
