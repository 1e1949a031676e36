"""soapy-sdr — the channelized flows of the reference CLI on PyTorch.

Counterpart of ``csdr_tpu/apps/soapy_sdr_cli.py``, reduced to the flows the
port carries, all from a .cf32 or .cu8 capture split into N > 1 channels,
one file per channel (``<output>_ch1`` .. ``<output>_chN``):

  * ``--demod "DeNBFM kf WAV|F32"``: DC blocker → PFB → per-channel FM demod;
  * ``-a T``: per-channel AGC with a T dB squelch before the demod;
  * ``--demod DeNo``: the raw split, complex64 ``.cf32`` per channel (with or
    without ``-a``).

``--backend eager`` runs the plain PyTorch graph; ``pfb_fused`` runs the
channelizer's FIR and DFT in the K3 kernel (with the demod) or, for the AGC
and DeNo flows, the K4 kernel; ``fused`` runs the whole DeNBFM chain in one
kernel and has no AGC or raw output.  Every other flow, demod and option of
the JAX CLI exits non-zero with "not yet ported in csdr_tpu_torch".

    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename cap.cu8 -n 33554432 \\
        -c 64 --demod "DeNBFM 0.6 F32" --backend fused --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..core.block import Chain, chain
from ..core.runtime import Pipeline
from ..io import sinks as S
from ..io import sources as SRC

__all__ = ["main", "build_parser", "run_opts", "parse_demod"]

_NOT_PORTED = "not yet ported in csdr_tpu_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="soapy-sdr",
        description="Channelized NBFM receiver and raw channel split on PyTorch "
                    "(CUDA or CPU)")
    p.add_argument("--filename", metavar="NAME",
                   help="Input file: raw CF32 (.cf32) or rtl_sdr uint8 IQ (.cu8)")
    p.add_argument("-s", "--samplerate", type=float, default=2.56e6, metavar="DOUBLE",
                   help="Sample rate in Hz (sets the WAV rate: samplerate / channels)")
    p.add_argument("-n", "--numsamples", type=int, default=1024, metavar="INT",
                   help="Number of samples to process")
    p.add_argument("-c", "--channels", type=int, default=1, metavar="INT",
                   help="Number of channels to split the signal into")
    p.add_argument("-o", "--output", default="output", metavar="FILENAME",
                   help="Output file name prefix (without extension)")
    p.add_argument("--blocksize", type=int, default=1 << 20,
                   help="Device block size in samples")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print the flow's blocks and a throughput summary")
    p.add_argument("--demod", default="DeNo", metavar="DEMOD",
                   help='Demodulation: "DeNBFM <kf> WAV|F32" or DeNo (raw CF32 channels)')
    p.add_argument("-a", "--agc", type=float, default=0.0, metavar="DOUBLE",
                   help="Per-channel AGC squelch threshold in dB (0 = no AGC)")
    p.add_argument("--backend", default="eager", choices=["eager", "pfb_fused", "fused"],
                   help="eager = plain PyTorch graph; pfb_fused = channelizer (and "
                        "demod) in the PFB CUDA kernels; fused = the whole DeNBFM "
                        "chain in one CUDA kernel")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="Device the graph runs on (cuda never falls back to cpu)")
    # options of the JAX CLI that the port refuses by name, not by argparse
    p.add_argument("-m", "--mix", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    p.add_argument("--offset", type=float, default=0.0, help=argparse.SUPPRESS)
    p.add_argument("-b", "--bandwidth", type=float, default=0.0, help=argparse.SUPPRESS)
    return p


def parse_demod(s: str):
    """Parse the reference's Haskell-Read demod syntax; only ``DeNBFM`` and
    ``DeNo`` are ported, everything else returns its kind alone."""
    toks = s.replace("(", " ").replace(")", " ").split()
    if not toks:
        return ("DeNo",)
    if toks[0] == "DeNBFM":
        return ("DeNBFM", float(toks[1]), toks[2].upper())
    return (toks[0],)


def _refusal(opts, demod) -> str | None:
    """Why the requested flow is outside the port, or None."""
    if demod[0] not in ("DeNBFM", "DeNo"):
        return f"--demod {demod[0]} is {_NOT_PORTED}; use \"DeNBFM <kf> WAV|F32\" or DeNo"
    if demod[0] == "DeNBFM" and demod[2] not in ("WAV", "F32"):
        return f"audio format {demod[2]} is {_NOT_PORTED}; use WAV or F32"
    for flag, on in (("--mix", opts.mix), ("--mesh", opts.mesh),
                     ("--offset", opts.offset), ("--bandwidth", opts.bandwidth)):
        if on:
            return f"{flag} is {_NOT_PORTED}"
    if opts.channels < 2:
        return f"single-channel flows (-c 1) are {_NOT_PORTED}; use -c N with N > 1"
    if not opts.filename:
        return f"SDR devices are {_NOT_PORTED}; use --filename"
    with open(opts.filename, "rb") as f:
        if f.read(4) == b"RIFF":
            return f"WAV input is {_NOT_PORTED}; use a .cf32 or .cu8 capture"
    return None


def _graph(opts, demod, agc_t):
    """The flow's graph, composed as the JAX CLI composes it: DeNBFM with no
    AGC is ``channelized_fm_receiver``; the AGC and DeNo flows put
    ``PerChannel([AGC >>] demod)`` behind the channelizer."""
    from ..models.receivers import channelized_fm_receiver, channelized_receiver
    from .. import blocks as B

    nch = opts.channels
    if demod[0] == "DeNo":
        per = B.automatic_gain_control(agc_t) if agc_t is not None else None
        return channelized_receiver(nch, per, backend=opts.backend)
    if agc_t is not None:
        return channelized_receiver(nch, B.fm_demodulator(demod[1]), agc_threshold_db=agc_t,
                                    backend=opts.backend)
    return channelized_fm_receiver(nch, kf=demod[1], backend=opts.backend)


def run_opts(opts) -> int:
    demod = parse_demod(opts.demod)
    why = _refusal(opts, demod)
    if why:
        print(why, file=sys.stderr)
        return 2
    agc_t = opts.agc if opts.agc != 0.0 else None
    if opts.backend == "fused" and (demod[0] == "DeNo" or agc_t is not None):
        print("--backend fused runs the whole DeNBFM chain in one kernel, with no AGC "
              "stage and no raw channel output; use --backend pfb_fused or eager",
              file=sys.stderr)
        return 2
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu)",
              file=sys.stderr)
        return 1
    device = torch.device(opts.device)
    nch = opts.channels
    cu8 = opts.filename.endswith(".cu8")

    from .. import blocks as B

    graph = _graph(opts, demod, agc_t)
    if cu8 and opts.backend != "fused":
        graph = chain(B.u8_to_iq(), graph)  # the fused kernel converts cu8 itself
    if opts.verbose:
        blocks = graph.blocks if isinstance(graph, Chain) else [graph]
        print(f"Flow (rate {graph.rate}, granule {graph.granule}) on {device}:")
        for b in blocks:
            print(f"  {b!r}")

    pipe = Pipeline(graph, block_size=opts.blocksize, device=device)
    read = SRC.cu8_file_source if cu8 else SRC.cf32_file_source
    src = read(opts.filename, pipe.block_size)
    if demod[0] == "DeNo":
        make_sink = lambda i: S.RawFileSink(f"{opts.output}_ch{i + 1}.cf32")
    elif demod[2] == "WAV":
        rate = int(round(opts.samplerate)) // nch
        make_sink = lambda i: S.AudioFileSink(f"{opts.output}_ch{i + 1}", rate)
    else:
        make_sink = lambda i: S.RawFileSink(f"{opts.output}_ch{i + 1}.f32")
    t0 = time.perf_counter()
    with S.ChannelFileSinks(make_sink, nch) as sink:
        total = pipe.run(src, sink, num_samples=opts.numsamples)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if opts.verbose and dt > 0:
        print(f"Throughput: {total * nch} input samples in {dt:.3f} s "
              f"({total * nch / dt / 1e6:.2f} MSPS in)")
    print(f"Wrote {total} output samples per stream ({opts.backend}, {device})")
    return 0


def main(argv=None) -> int:
    return run_opts(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
