"""soapy-sdr — the reference CLI on PyTorch.

Counterpart of ``csdr_tpu/apps/soapy_sdr_cli.py``.  The input is an SDR
device or a file.  Without ``--filename`` the CLI lists the drivers
(``io/sources.enumerate_devices``) and opens ``--devname`` (default
``rtlsdr``) at ``-s`` S/s, tuned to ``-f`` Hz with gain ``-g`` (0 = the
device's AGC): ``synthetic`` (seeded tones and noise, ``-n`` samples long),
``rtl_tcp`` (a network dongle at ``$CSDR_RTLTCP_ADDR``, with ``--ppm`` and
``--bias-t``; ``apps/rtl_tcp_server`` serves a capture so) or a SoapySDR
driver where the ``SoapySDR`` module imports.  A device yields complex64.
A file is a .cu8 capture, a mono WAV (a sound-card IF recording: Hilbert
real → complex 2:1, then a mix by π, ``io/sources.wav_iq_source``, at half
the WAV's rate) or anything else as raw CF32, read ``--chunksize`` samples
at a time.  Every flow below runs from either:

  * a front end: ``--offset`` (NCO mixer) and ``-b/--bandwidth`` (half-band
    cascade + rational resampler), then ``-n`` samples at the front end's
    output rate;
  * ``-c 1``: ``dc_blocker >> [AGC] >> demod`` into ``<output>.wav|.f32``
    (``.cf32`` for DeNo);
  * ``-c N > 1``: DC blocker → PFB → per-channel ``[AGC >>] demod``, one
    file per channel (``<output>_ch1`` .. ``<output>_chN``), or with
    ``-m/--mix`` the channels summed into one ``<output>`` file;
  * ``--demod``: ``"DeNBFM kf WAV|F32"``, ``"DeWBFM decim WAV|F32"``,
    ``"DeFMS decim WAV|F32"`` (stereo, ``-c 1`` only; ``--rds`` adds the RDS
    decode to ``<output>.rds.txt``), ``"DeAM WAV|F32"``,
    ``"DeUSB|DeLSB bw_hz WAV|F32"``, ``"DeCW [bw_hz pitch_hz] WAV|F32"``,
    ``"DeNBFMSync k"`` (FM demod with kf = 0.02·k, then symbol sync from k
    samples/symbol to 2, into ``.f32`` files for ``apps/helidecode``) or
    ``DeNo`` (raw complex64); ``-a T`` adds an AGC with a T dB squelch.
    Audio runs at int(bandwidth) // decim // nch Hz, as float32 WAV, Sun AU
    (``<output>.au``) or raw little-endian float32 (``F32``, ``<output>.f32``);
  * the packet flows (``-c 1`` only): ``"DeAIS"`` (GMSK at n·9600 S/s),
    ``"DeAPRS [kf]"`` (NBFM → AFSK1200), ``"DeADSB"`` (Mode S at 2n MS/s,
    no AGC), ``"DePOCSAG [baud]"`` and ``"DeRTTY [baud]"`` (USB → ITA2): the
    device chain into a ``CollectSink``, the host-side decode, one line per
    message on stdout, then ``N message(s)``, and the same lines in
    ``<output>.{ais,aprs,adsb,pocsag,rtty}.txt``.

``--backend`` picks the channelizer of ``-c N`` flows: ``eager`` runs the
plain PyTorch graph; ``pfb_fused`` runs its FIR and DFT in the K3 kernel
(DeNBFM without AGC, with the demod) or the K4 kernel (every other flow);
``fused`` runs the whole DeNBFM chain in one kernel and nothing else.  Long
real FIRs (the CW filter, the RDS data filter) take the K5 kernel on the
card.

``--mesh TxC`` runs a flow over T time × C channel ranks, one process per
device (``csdr_tpu_torch/parallel``).  ``-c N --demod "DeNBFM kf
WAV|F32"`` ([``-a T``], without ``-m``): ``--backend fused`` is the
time-sharded flagship kernel (``ShardedFlagship``, C = 1, no AGC, nch |
64); ``pfb_fused`` and ``eager`` are ``ShardedChannelizedFM`` with and
without K3/K4.  Every other flow runs the serial ``--backend eager``
graph as a ``ShardedChain``, whatever ``--backend`` says, so the mesh and
serial runs build the same graph: ``dc_blocker >> [AGC >>] demod`` over
time for ``-c 1`` (DeFMS: ``fm_demodulator(0.8) >> stereo_fm_decoder``, a
(2, n) panel over time only, so C must be 1; with ``--rds`` a ``Tee`` of
it and ``rds_receiver``, each leaf gathered by its own layout), the packet
flows' receivers without the DC blocker, as serial; ``dc_blocker >>
firpfbch_channelizer(N) >> PerChannel([AGC >>] demod) [>> MixChannels()]``
for ``-c N`` (DeNBFMSync included), the channels over C and the frames
over T (C must divide N).  The front end (``--offset``, ``-b``, with a cu8
file's ``u8_to_iq``) runs on rank 0's own Pipeline (a cu8 file without a
front end puts ``u8_to_iq`` at the graph's head, as the serial flow does);
the sinks, the plot taps and the decoders (the packet ``.txt``, the
``.rds.txt``) are rank 0's, and ``--play`` is ignored for a ``-c N -m``
mix.  Under torchrun the CLI joins the group it finds (one rank per GPU);
otherwise it starts its own T·C local ranks.  ``--device cpu`` runs gloo
ranks.

The host-side options: ``--spectrum [FILE]`` and ``--constellation [FILE]``
tap the stream after the front end (before the DC blocker) into a Welch PSD
and a scatter-plot Octave script; ``--play [CMD]`` tees single-stream audio
into a live player (``io/sinks.PlaybackSink``); ``--profile`` records the
main Pipeline's spans (``utils/prof``, no device barrier) and prints the
per-stage table: each stage's device interval on a card (its host span on
the CPU) and host ms, the Pipeline's own spans (staging, H2D, drain wait,
trim, the sink's file writes) and the MB copied per block.

    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename cap.cu8 -n 33554432 \\
        -c 64 --demod "DeCW 500 700 WAV" --backend pfb_fused --device cuda
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename cap.cu8 -s 2560000 \\
        -b 200000 -n 2621440 --demod "DeFMS 8 WAV" --rds --device cuda
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename ais.cu8 -s 1920000 \\
        --offset 25000 -b 48000 -n 838860 --demod DeAIS -o ais --device cuda
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename if.wav -s 48000 -n 2097152 \\
        -c 64 --demod "DeNBFM 0.6 AU" --backend fused --spectrum --profile
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename heli.cu8 -n 33554432 \\
        -c 64 --demod "DeNBFMSync 10" --backend pfb_fused --blocksize 8388608
    CSDR_RTLTCP_ADDR=127.0.0.1:1234 python -m csdr_tpu_torch.apps.soapy_sdr_cli \\
        --devname rtl_tcp -s 2.56e6 -f 100e6 --ppm 3 -n 33554432 -c 64 \\
        --demod "DeNBFM 0.6 F32" --backend fused
    python -m torch.distributed.run --nproc-per-node 4 -m csdr_tpu_torch.apps.soapy_sdr_cli \\
        --filename cap.cu8 -n 33554432 -c 64 --mesh 4x1 --backend fused \\
        --demod "DeNBFM 0.6 F32"
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename cap.cu8 -c 1 --offset 95000 \\
        -b 48000 -n 524288 --blocksize 131072 --mesh 2x1 --demod "DeCW 500 700 WAV" \\
        --device cpu
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename cap.cu8 -n 33554432 -c 64 \\
        --blocksize 8388608 --mesh 2x2 --demod "DeCW 500 700 WAV" --device cuda
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename cap.cu8 -s 2560000 \\
        -b 200000 -n 2621440 --mesh 4x1 --demod "DeFMS 8 WAV" --rds --device cuda
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename ais.cu8 -s 1920000 \\
        --offset 25000 -b 48000 -n 838860 --mesh 4x1 --demod DeAIS -o ais
    python -m csdr_tpu_torch.apps.soapy_sdr_cli --filename heli.cu8 -n 33554432 -c 64 \\
        --blocksize 8376320 --mesh 2x2 --demod "DeNBFMSync 10" --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import tempfile
import time

import numpy as np
import torch

from ..core.block import Chain, chain
from ..core.runtime import Pipeline, take_n
from ..io import sinks as S
from ..io import sources as SRC
from ..io.wav import probe_wav
from ..ops.cuda import kernel_launches

__all__ = ["main", "build_parser", "run_opts", "parse_demod", "packet_messages", "packet_lines",
           "PACKET_SUFFIX"]

_NOT_PORTED = "not yet ported in csdr_tpu_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="soapy-sdr",
        description="Single-channel and channelized receivers on PyTorch (CUDA or CPU)")
    p.add_argument("--filename", metavar="NAME",
                   help="Input file: rtl_sdr uint8 IQ (.cu8), a mono WAV (IF recording, "
                        "lifted to IQ at half its rate) or raw CF32; without it, the SDR "
                        "device --devname")
    p.add_argument("--chunksize", type=int, default=None, metavar="INT",
                   help="Samples per file read (default: the device block size); a device "
                        "reads its own MTU")
    p.add_argument("--devname", default="rtlsdr", metavar="NAME",
                   help="SDR device driver: synthetic, rtl_tcp (at $CSDR_RTLTCP_ADDR) or a "
                        "SoapySDR driver")
    p.add_argument("--ppm", type=int, default=0, metavar="INT",
                   help="Frequency correction in ppm (rtl_tcp driver)")
    p.add_argument("--bias-t", dest="bias_t", action="store_true",
                   help="Power the bias tee (rtl_tcp driver)")
    p.add_argument("-f", "--frequency", type=float, default=100.0e6, metavar="DOUBLE",
                   help="Rx frequency in Hz")
    p.add_argument("-g", "--gain", type=float, default=0.0, metavar="DOUBLE",
                   help="SDR gain level (0 = auto)")
    p.add_argument("-s", "--samplerate", type=float, default=2.56e6, metavar="DOUBLE",
                   help="Sample rate in Hz")
    p.add_argument("--offset", type=float, default=0.0, metavar="DOUBLE",
                   help="Offset frequency in Hz (mixed to DC before everything else)")
    p.add_argument("-b", "--bandwidth", type=float, default=0.0, metavar="DOUBLE",
                   help="Output bandwidth in Hz (0 = samplerate = no resampling)")
    p.add_argument("-n", "--numsamples", type=int, default=1024, metavar="INT",
                   help="Number of samples to process, counted after the front end")
    p.add_argument("-c", "--channels", type=int, default=1, metavar="INT",
                   help="Number of channels to split the signal into")
    p.add_argument("-o", "--output", default="output", metavar="FILENAME",
                   help="Output file name prefix (without extension)")
    p.add_argument("--blocksize", type=int, default=1 << 20,
                   help="Device block size in samples")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print the flow's blocks and a throughput summary")
    p.add_argument("-m", "--mix", action="store_true",
                   help="Mix the channels into one output instead of per-channel files")
    p.add_argument("--demod", default="DeNo", metavar="DEMOD",
                   help='Demodulation: "DeNBFM <kf> WAV|F32", "DeWBFM <decim> WAV|F32", '
                        '"DeFMS <decim> WAV|F32" (stereo), "DeAM WAV|F32", '
                        '"DeUSB|DeLSB <bw Hz> WAV|F32", "DeCW [<bw Hz> <pitch Hz>] '
                        'WAV|F32", "DeNBFMSync <k>" (2 samples/symbol F32), DeNo (raw '
                        'CF32), or the packet decoders DeAIS, '
                        '"DeAPRS [kf]", DeADSB, "DePOCSAG [baud]", "DeRTTY [baud]" '
                        '(-c 1; <output>.<kind>.txt); audio as WAV, AU or raw F32')
    p.add_argument("--rds", action="store_true",
                   help="With --demod 'DeFMS ...': also decode the 57 kHz RDS subcarrier "
                        "(PS/RadioText/PI) to <output>.rds.txt")
    p.add_argument("-a", "--agc", type=float, default=0.0, metavar="DOUBLE",
                   help="AGC with a squelch threshold in dB (0 = no AGC); per channel "
                        "with -c N")
    p.add_argument("--backend", default="eager", choices=["eager", "pfb_fused", "fused"],
                   help="Channelizer of -c N flows: eager = plain PyTorch graph; "
                        "pfb_fused = FIR and DFT (and the DeNBFM demod) in the PFB CUDA "
                        "kernels; fused = the whole DeNBFM chain in one CUDA kernel")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="Device the graph runs on (cuda never falls back to cpu)")
    p.add_argument("--spectrum", nargs="?", const="", default=None, metavar="FILE",
                   help="Also write a Welch-averaged PSD Octave script of the IQ after the "
                        "front end (default <output>_spectrum.m)")
    p.add_argument("--constellation", nargs="?", const="", default=None, metavar="FILE",
                   help="Also write a constellation scatter Octave script of the IQ after "
                        "the front end (default <output>_constellation.m)")
    p.add_argument("--play", nargs="?", const="", default=None, metavar="CMD",
                   help="Also play single-stream audio live (pacat/aplay/play found on the "
                        "PATH, or this command; float32le PCM on its stdin)")
    p.add_argument("--profile", action="store_true",
                   help="Record the main pipeline's spans (no device barrier) and print "
                        "the per-stage table: device interval and host ms per stage, the "
                        "pipeline's own spans, MB copied per block")
    p.add_argument("--mesh", default=None, metavar="TxC",
                   help="Run the flow on a device mesh of T time × C channel ranks, e.g. "
                        "'4x1' (one process per device); DeFMS and the packet flows on "
                        "-c 1, DeFMS with C = 1")
    return p


PACKET_SUFFIX = {"DeAIS": ".ais.txt", "DeAPRS": ".aprs.txt", "DeADSB": ".adsb.txt",
                 "DePOCSAG": ".pocsag.txt", "DeRTTY": ".rtty.txt"}
_DEMODS = ("DeNBFM", "DeWBFM", "DeFMS", "DeAM", "DeUSB", "DeLSB", "DeCW", "DeNBFMSync", "DeNo",
           *PACKET_SUFFIX)


def parse_demod(s: str):
    """Parse the reference's Haskell-Read demod syntax for the ported demods;
    any other kind returns its name alone."""
    toks = s.replace("(", " ").replace(")", " ").split()
    if not toks:
        return ("DeNo",)
    kind = toks[0]
    if kind == "DeNBFM":
        return ("DeNBFM", float(toks[1]), toks[2].upper())
    if kind in ("DeWBFM", "DeFMS"):
        return (kind, int(toks[1]), toks[2].upper())
    if kind == "DeNBFMSync":
        return ("DeNBFMSync", int(toks[1]))
    if kind == "DeAM":
        return ("DeAM", toks[1].upper())
    if kind in ("DeUSB", "DeLSB"):
        return (kind, float(toks[1]), toks[2].upper())
    if kind == "DeCW":
        if len(toks) == 2:
            return ("DeCW", 500.0, 700.0, toks[1].upper())
        return ("DeCW", float(toks[1]), float(toks[2]), toks[3].upper())
    if kind == "DeAPRS":
        return ("DeAPRS", float(toks[1]) if len(toks) > 1 else 0.5)
    if kind == "DePOCSAG":
        return ("DePOCSAG", float(toks[1]) if len(toks) > 1 else 1200.0)
    if kind == "DeRTTY":
        return ("DeRTTY", float(toks[1]) if len(toks) > 1 else 1000.0 / 22.0)
    return (kind,)


def _refusal(opts, demod) -> str | None:
    """Why the requested flow is outside the port, or None."""
    if demod[0] not in _DEMODS:
        return (f"--demod {demod[0]} is {_NOT_PORTED}; use DeNBFM, DeWBFM, DeFMS, DeAM, "
                "DeUSB, DeLSB, DeCW, DeNBFMSync, DeNo, DeAIS, DeAPRS, DeADSB, DePOCSAG or "
                "DeRTTY")
    if (demod[0] not in ("DeNo", "DeNBFMSync", *PACKET_SUFFIX)
            and demod[-1] not in ("WAV", "AU", "F32")):
        return f"audio format {demod[-1]} is {_NOT_PORTED}; use WAV, AU or F32"
    return None


def _on_chain(opts, demod) -> bool:
    """Whether a --mesh flow runs as a ``ShardedChain`` over ``_flow``'s
    eager graph: every flow but non-mixed -c N DeNBFM, which runs the
    hand-fused ``ShardedFlagship`` or ``ShardedChannelizedFM``."""
    return opts.channels == 1 or demod[0] != "DeNBFM" or opts.mix


def _open_device(opts):
    """The SDR device ``--devname``, with the JAX CLI's messages: the
    drivers there are, then the one used; None, after "No SDR devices
    detected", "Device X not found" or "Failed to open device X: …" on
    stderr, where it cannot be opened.  ``synthetic`` streams ``-n``
    samples; ``rtl_tcp`` takes ``--ppm`` and ``--bias-t``."""
    devs = [d.get("driver") for d in SRC.enumerate_devices()]
    if not devs:
        print("No SDR devices detected", file=sys.stderr)
        return None
    print(f"Available devices: {devs}")
    if opts.devname not in devs:
        print(f"Device {opts.devname} not found", file=sys.stderr)
        return None
    print(f"Using device: {opts.devname}")
    kw = {}
    if opts.devname == "synthetic" and opts.numsamples:
        kw["total_samples"] = int(opts.numsamples)
    if opts.devname == "rtl_tcp":
        if opts.ppm:
            kw["ppm"] = opts.ppm
        if opts.bias_t:
            kw["bias_t"] = True
    try:
        return SRC.open_sdr(opts.devname, opts.samplerate, opts.frequency, opts.gain, **kw)
    except OSError as e:  # an unreachable or silent server (ConnectionError is one)
        print(f"Failed to open device {opts.devname}: {e}", file=sys.stderr)
        return None


def _open_source(opts, device, block_size: int):
    """The input: the SDR device without ``--filename`` (None where it
    cannot be opened), else the file, sniffed as the JAX CLI does: ``.cu8``
    first, then a header-only ``probe_wav`` (a WAV goes through
    ``wav_iq_source`` on ``device``), and a file it cannot read as WAV is
    raw CF32, read ``--chunksize`` samples at a time (default
    ``block_size``).  A WAV the source refuses (not mono) raises
    ValueError."""
    if not opts.filename:
        return _open_device(opts)
    chunk = opts.chunksize or block_size
    if opts.filename.endswith(".cu8"):
        return SRC.cu8_file_source(opts.filename, chunk)
    try:
        probe_wav(opts.filename)
    except (ValueError, struct.error):
        return SRC.cf32_file_source(opts.filename, chunk)
    return SRC.wav_iq_source(opts.filename, chunk, device=device)


def _is_cu8(opts) -> bool:
    """Whether the input is a .cu8 capture (uint8 rows); a device yields
    complex64."""
    return bool(opts.filename) and opts.filename.endswith(".cu8")


def _host_iq(chunk: np.ndarray) -> np.ndarray:
    """A source block as complex64 IQ on the host: cu8 (n, 2) rows go
    through ``U8ToIQ`` on the CPU."""
    if chunk.dtype != np.uint8:
        return chunk
    from ..blocks import U8ToIQ

    return U8ToIQ().apply((), torch.from_numpy(chunk.copy()))[1].numpy()


def _plot_taps(opts, stream, out_bw: float):
    """``--spectrum`` / ``--constellation``: the stream cut to ``-n`` and
    copied, block by block, into the plot sinks on the host (closed when the
    stream ends); the stream itself passes on unchanged."""
    taps = []
    if opts.spectrum is not None:
        taps.append(S.SpectrumPlotSink(opts.spectrum or f"{opts.output}_spectrum.m",
                                       sample_rate=out_bw))
    if opts.constellation is not None:
        taps.append(S.ConstellationPlotSink(opts.constellation
                                            or f"{opts.output}_constellation.m"))
    if not taps:
        return stream

    def tapped():
        try:
            for blk in take_n(stream, opts.numsamples):
                iq = _host_iq(np.asarray(blk))
                for t in taps:
                    t(iq)
                yield blk
        finally:
            for t in taps:
                t.close()

    return tapped()


def _demod_block(demod, out_bw: float, nch: int):
    """The per-stream demod of the flow (None for DeNo); bandwidths and
    pitches in Hz are normalized to the channel's rate.  DeWBFM designs its
    de-emphasis for the rate ahead of the split, out_bw, as the JAX CLI
    does."""
    from .. import blocks as B

    kind = demod[0]
    chan_rate = out_bw / nch
    if kind == "DeNBFM":
        return B.fm_demodulator(demod[1])
    if kind == "DeWBFM":
        return B.wbfm_demodulator(out_bw, demod[1])
    if kind == "DeAM":
        return B.am_demodulator()
    if kind in ("DeUSB", "DeLSB"):
        return B.ssb_demodulator("usb" if kind == "DeUSB" else "lsb", demod[1] / chan_rate)
    if kind == "DeCW":
        return B.cw_demodulator(demod[1] / chan_rate, demod[2] / chan_rate)
    if kind == "DeNBFMSync":
        from ..models.symsync import fm_dem_with_sync

        return fm_dem_with_sync(demod[1])
    return None


def _packet_graph(demod, agc: list, rate: float):
    """The packet flow's device chain at the front end's output ``rate``,
    as the JAX CLI composes it: ``[AGC >>]`` the receiver (no AGC for
    DeADSB, whose envelope detector is its gain normalizer), a USB
    demodulator in front of RTTY and an FM demodulator in front of APRS."""
    from .. import blocks as B
    from ..models import adsb, ais, aprs, pocsag, rtty

    kind = demod[0]
    if kind == "DeAIS":
        return chain(*agc, ais.ais_receiver(rate))
    if kind == "DeADSB":
        return chain(adsb.adsb_receiver(rate))
    if kind == "DePOCSAG":
        return chain(*agc, pocsag.pocsag_receiver(rate, demod[1]))
    if kind == "DeRTTY":
        return chain(*agc, B.ssb_demodulator("usb", 3000.0 / rate),
                     rtty.rtty_receiver(rate, demod[1]))
    return chain(*agc, B.fm_demodulator(demod[1]), aprs.afsk1200_receiver(rate))


def packet_messages(demod, collected, rate: float) -> list:
    """Decode a packet flow's collected output at ``rate``: message dicts,
    or for DeRTTY the non-empty lines of the decoded text."""
    from ..models import adsb, ais, aprs, pocsag, rtty

    kind = demod[0]
    if kind == "DeAIS":
        return ais.decode_bits(np.asarray(collected))
    if kind == "DeADSB":
        return adsb.pair_positions(adsb.decode_collected(collected, rate))
    if kind == "DePOCSAG":
        return pocsag.decode_score(np.asarray(collected), rate, demod[1])
    if kind == "DeRTTY":
        text = rtty.decode_score(np.asarray(collected), rate, demod[1])
        return [ln for ln in text.splitlines() if ln.strip()]
    return aprs.decode_score(np.asarray(collected), rate)


def packet_lines(kind: str, msgs: list) -> list[str]:
    """The lines the JAX CLI prints and writes for a packet flow's messages."""
    from .adsb_decode import format_msg as adsb_line
    from .pocsag_decode import format_msg as pocsag_line

    if kind == "DeAIS":
        return [(f"type {m['type']} mmsi {m['mmsi']:09d} "
                 f"lat {m['lat_deg']:+.5f} lon {m['lon_deg']:+.5f} "
                 f"sog {m['sog_kn']:.1f} cog {m['cog_deg']:.1f}"
                 if "lat_deg" in m else f"type {m['type']} mmsi {m['mmsi']:09d}")
                for m in msgs]
    if kind == "DeADSB":
        return [adsb_line(m) for m in msgs]
    if kind == "DePOCSAG":
        return [pocsag_line(m) for m in msgs]
    if kind == "DeRTTY":
        return list(msgs)
    return [f"{m['src']}>{m['dst']}" + (("," + ",".join(m["via"])) if m["via"] else "")
            + f":{m['info']}" for m in msgs]


def _report_packet(opts, demod, collected, rate: float):
    """Print the decoded lines and ``N message(s)``, and write the lines to
    ``<output>.<kind>.txt``."""
    msgs = packet_messages(demod, collected, rate)
    lines = packet_lines(demod[0], msgs)
    for ln in lines:
        print(ln)
    print(f"{len(msgs)} message(s)")
    with open(opts.output + PACKET_SUFFIX[demod[0]], "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def _graph(opts, demod, agc_t, out_bw: float, backend: str):
    """The flow's main graph behind the front end, composed as the JAX CLI
    composes it: ``dc_blocker >> [AGC] >> demod`` for -c 1 (DeFMS:
    ``fm_demodulator(0.8) >> stereo_fm_decoder``, with ``--rds`` a ``Tee`` of
    it and ``rds_receiver``); for -c N, DeNBFM with no AGC is
    ``channelized_fm_receiver``, every other flow puts ``PerChannel([AGC >>]
    demod)`` behind the channelizer; ``-m`` sums the channels.  ``backend``
    picks the channelizer of -c N."""
    from ..models.receivers import channelized_fm_receiver, channelized_receiver
    from .. import blocks as B

    nch = opts.channels
    agc = [B.automatic_gain_control(agc_t)] if agc_t is not None else []
    if demod[0] in PACKET_SUFFIX:
        return _packet_graph(demod, agc, out_bw)
    if demod[0] == "DeFMS":
        from ..core.block import Tee
        from ..models.rds import rds_receiver
        from ..models.stereo import stereo_fm_decoder

        stereo = stereo_fm_decoder(out_bw, demod[1])
        tail = Tee(stereo, rds_receiver(out_bw)) if opts.rds else stereo
        return chain(B.dc_blocker(), *agc, B.fm_demodulator(0.8), tail)
    per = _demod_block(demod, out_bw, nch)
    if nch == 1:
        return chain(B.dc_blocker(), *agc, *([per] if per is not None else []))
    if demod[0] == "DeNBFM" and agc_t is None:
        return channelized_fm_receiver(nch, kf=demod[1], mix=opts.mix, backend=backend)
    if per is None:  # DeNo: the AGC alone per channel, as the JAX CLI builds it
        per = agc[0] if agc else None
        return channelized_receiver(nch, per, mix=opts.mix, backend=backend)
    return channelized_receiver(nch, per, mix=opts.mix, agc_threshold_db=agc_t,
                                backend=backend)


def _sink(opts, demod, out_bw: float):
    """The flow's sink: per-channel files for -c N, one file for -c 1 or
    ``-m`` (WAV or AU audio, raw ``.f32`` for DeNBFMSync and F32 flows);
    DeFMS writes 2-channel audio, and with ``--rds`` routes the bit branch
    to a CollectSink (returned second, else None); a packet flow collects
    its whole output (returned twice).  ``--play`` tees a single audio
    stream into a live player."""
    nch = opts.channels
    if demod[0] in PACKET_SUFFIX:
        bits = S.CollectSink()
        return bits, bits
    decim = demod[1] if demod[0] in ("DeWBFM", "DeFMS") else 1
    rate = int(round(out_bw)) // decim // nch
    channels = 2 if demod[0] == "DeFMS" else 1
    if demod[0] == "DeNo":
        make = lambda name: S.RawFileSink(f"{name}.cf32")
    elif demod[-1] in ("WAV", "AU"):
        make = lambda name: S.AudioFileSink(name, rate, channels, demod[-1].lower())
    else:
        make = lambda name: S.RawFileSink(f"{name}.f32")
    if nch > 1 and not opts.mix:
        return S.ChannelFileSinks(lambda i: make(f"{opts.output}_ch{i + 1}"), nch), None
    out = make(opts.output)
    if opts.play is not None and _plays(opts, demod):
        out = S.TeeSink(out, S.PlaybackSink(rate, channels, opts.play or None))
    if demod[0] == "DeFMS" and opts.rds:
        bits = S.CollectSink()
        return S.BranchSinks(out, bits), bits
    return out, None


def _plays(opts, demod) -> bool:
    """Whether the flow's output is one audio stream that ``--play`` takes."""
    return (demod[0] not in ("DeNo", "DeNBFMSync", *PACKET_SUFFIX)
            and (opts.channels == 1 or opts.mix))


def _report_rds(opts, bits: np.ndarray):
    """Decode the RDS bit stream, print the station and write
    ``<output>.rds.txt``."""
    from ..models.rds import decode_groups

    info = decode_groups(bits)
    pi = f"{info['pi']:04X}" if info["pi"] is not None else "----"
    print(f"RDS: PI={pi} PS={info['ps']!r} RT={info['rt']!r} ({info['groups']} groups)")
    with open(opts.output + ".rds.txt", "w") as f:
        f.write(f"PI: {pi}\nPS: {info['ps']}\nRT: {info['rt']}\ngroups: {info['groups']}\n")


def _front_end(opts):
    """The front end (``u8_to_iq`` for a cu8 file, the ``--offset`` mixer,
    the ``-b`` resampler) as a chain that streams on its own Pipeline, or
    None where the flow has no offset and no resampling."""
    from .. import blocks as B
    from ..models.receivers import front_end

    stages = front_end(opts.samplerate, opts.offset, opts.bandwidth)
    if not stages:
        return None
    return chain(*([B.u8_to_iq()] if _is_cu8(opts) else []), *stages)


def _flow(opts, demod, agc_t, backend: str | None = None):
    """(front end or None, main graph, output bandwidth) of a flow, serial
    or ``--mesh``, with ``backend`` (default ``--backend``; a ``ShardedChain``
    flow passes ``eager``, as the JAX CLI's sharded flows ignore the
    backend).  Without a front end a cu8 file puts ``u8_to_iq`` at the
    graph's head, except under ``fused``, whose kernel converts cu8 itself.
    ValueError: a bandwidth or pitch outside the channel, a packet rate."""
    from .. import blocks as B

    backend = backend or opts.backend
    out_bw = opts.bandwidth if opts.bandwidth else opts.samplerate
    graph = _graph(opts, demod, agc_t, out_bw, backend)
    fe = _front_end(opts)
    if fe is None and _is_cu8(opts) and backend != "fused":
        graph = chain(B.u8_to_iq(), graph)
    return fe, graph, out_bw


def _announce(label: str, graph, device, block_size: int):
    blocks = graph.blocks if isinstance(graph, Chain) else [graph]
    print(f"{label} (rate {graph.rate}, granule {graph.granule}, block {block_size}) "
          f"on {device}:")
    for b in blocks:
        print(f"  {b!r}")


def run_opts(opts) -> int:
    demod = parse_demod(opts.demod)
    why = _refusal(opts, demod)
    if why:
        print(why, file=sys.stderr)
        return 2
    agc_t = opts.agc if opts.agc != 0.0 else None
    nch = opts.channels
    if nch < 1:
        print(f"-c must be at least 1, got {nch}", file=sys.stderr)
        return 2
    if demod[0] in ("DeFMS", *PACKET_SUFFIX) and nch != 1:
        print(f"{demod[0]} does not support channel splitting", file=sys.stderr)
        return 1
    if opts.backend == "fused" and (nch == 1 or demod[0] != "DeNBFM" or agc_t is not None):
        print("--backend fused runs the whole channelized DeNBFM chain in one kernel, with "
              "no AGC stage, no raw channel output and no other demod; use --backend "
              "pfb_fused or eager", file=sys.stderr)
        return 2
    if opts.play is not None and not _plays(opts, demod):
        print("--play ignored: output is not a single audio stream")
    if opts.mesh:
        return _run_mesh(opts, demod, agc_t)
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu)",
              file=sys.stderr)
        return 1
    device = torch.device(opts.device)
    try:
        fe, graph, out_bw = _flow(opts, demod, agc_t)
    except ValueError as e:  # a bandwidth or pitch outside the channel, a packet rate
        print(e, file=sys.stderr)
        return 1 if demod[0] in PACKET_SUFFIX else 2
    fe_pipe = None
    if fe is not None:
        # the front end streams on its own pipeline and -n counts its output
        fe_pipe = Pipeline(fe, block_size=opts.blocksize, device=device)
        if opts.verbose:
            _announce("Front end", fe, device, fe_pipe.block_size)
    pipe = Pipeline(graph, block_size=opts.blocksize, device=device, profile=opts.profile)
    try:
        source = _open_source(opts, device, (fe_pipe or pipe).block_size)
    except ValueError as e:  # a WAV of more than one channel
        print(e, file=sys.stderr)
        return 1
    if source is None:
        print("Unable to open source", file=sys.stderr)
        return 1
    stream = _plot_taps(opts, fe_pipe.stream(source) if fe_pipe else source, out_bw)
    if opts.verbose:
        _announce("Flow", graph, device, pipe.block_size)

    t0 = time.perf_counter()
    sink, bits = _sink(opts, demod, out_bw)
    try:
        with sink:
            total = pipe.run(stream, sink, num_samples=opts.numsamples)
    finally:
        source.close()  # a device streams on past -n: hang up now
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if opts.verbose and dt > 0:
        n_in = total / graph.rate
        print(f"Throughput: {int(n_in)} samples into the flow in {dt:.3f} s "
              f"({n_in / dt / 1e6:.2f} MSPS)")
    if opts.verbose:
        print(f"Kernel launches: {json.dumps(kernel_launches())}")
    if opts.profile:
        print("Per-stage budget (device interval per stage on a card, host span on the "
              "CPU; no barriers):")
        print(pipe.profile_report())
    if demod[0] in PACKET_SUFFIX:
        _report_packet(opts, demod, bits.concat(), out_bw)
        return 0
    print(f"Wrote {total} output samples per stream ({opts.backend}, {device})")
    if bits is not None:
        _report_rds(opts, bits.concat())
    return 0


def _mesh_dims(mesh: str) -> tuple[int, int]:
    t, _, c = mesh.lower().partition("x")
    dt, dc = int(t), int(c or 1)
    if dt < 1 or dc < 1:
        raise ValueError(mesh)
    return dt, dc


def _sharded_block(dt: int, graph, blocksize: int) -> int:
    """The block size rounded down to a multiple of time ranks · the
    graph's granule (``ShardedChain``'s divisibility), at least one."""
    g = dt * graph.granule
    return max(blocksize // g, 1) * g


def _chain_graph(opts, demod, agc_t):
    """A ``ShardedChain`` flow's graph (``_flow``'s eager one, run on rank
    0's front end where there is one) and its block."""
    _, graph, _ = _flow(opts, demod, agc_t, backend="eager")
    return graph, _sharded_block(_mesh_dims(opts.mesh)[0], graph, opts.blocksize)


def _run_mesh(opts, demod, agc_t) -> int:
    """A flow over a ('time', 'ch') mesh: under torchrun this process is
    one rank of the group it finds, otherwise it starts T·C local ranks
    (``parallel.spawn``) and waits for them.  A ``ShardedChain`` graph is
    validated here first, before any rank starts."""
    from ..parallel.generic import ShardedChain
    from ..parallel.mesh import check_devices, init_distributed, spawn

    try:
        dt, dc = _mesh_dims(opts.mesh)
    except ValueError:
        print(f"--mesh takes TxC, e.g. 4x1, got {opts.mesh!r}", file=sys.stderr)
        return 2
    nch, world = opts.channels, dt * dc
    on_chain = _on_chain(opts, demod)
    if not on_chain and opts.backend == "fused" and (dc != 1 or 64 % nch):
        print(f"--backend fused shards the flagship kernel over time only and needs nch | 64: "
              f"use --mesh {dt}x1 with -c dividing 64, or --backend pfb_fused or eager for "
              "a channel axis", file=sys.stderr)
        return 2
    if not on_chain and nch % dc:
        print(f"-c {nch} does not split over {dc} channel ranks", file=sys.stderr)
        return 2
    if on_chain:
        if nch > 1 and opts.mix and opts.play is not None:
            # the JAX CLI's sharded mixes do not play either
            print("--play ignored: --mesh writes the mixed stream to its file only",
                  file=sys.stderr)
            opts.play = None
        try:
            graph, block = _chain_graph(opts, demod, agc_t)
            ShardedChain.validate(graph, dt, dc, block)
        except NotImplementedError as e:
            print(f"--mesh: this flow cannot be time-sharded ({e})", file=sys.stderr)
            return 1
        except ValueError as e:   # a block too short for a halo, a bandwidth or pitch
            print(f"--mesh: invalid configuration ({e})", file=sys.stderr)
            return 1
    try:
        check_devices(world, opts.device)
    except ValueError as e:
        print(f"mesh {opts.mesh}: {e}", file=sys.stderr)
        return 1
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            print(f"mesh {opts.mesh} needs {world} ranks, torchrun started "
                  f"{os.environ['WORLD_SIZE']}", file=sys.stderr)
            return 2
        device = init_distributed(device_type=opts.device)
        try:
            _mesh_rank(device, opts, demod, agc_t)
        finally:
            torch.distributed.destroy_process_group()
        return 0
    try:
        if world == 1:
            # one rank has no peer to wait on: run it here, sparing a process start
            with tempfile.TemporaryDirectory(prefix="csdr-mesh-") as tmp:
                device = init_distributed(0, 1, 0, f"file://{tmp}/store", opts.device)
                try:
                    _mesh_rank(device, opts, demod, agc_t)
                finally:
                    torch.distributed.destroy_process_group()
        else:
            spawn(_mesh_rank, world, opts.device, args=(opts, demod, agc_t), timeout=3600.0)
    except (RuntimeError, TimeoutError) as e:
        print(f"--mesh {opts.mesh}: {e}", file=sys.stderr)
        return 1
    return 0


def _mesh_rank(device: torch.device, opts, demod, agc_t) -> int:
    """One rank of the --mesh flow; rank 0 reads the capture (through the
    front end, on its own device) and writes the files."""
    from ..ops.cuda import pfb_fused as pf
    from ..parallel import (ShardedChain, ShardedChannelizedFM, ShardedFlagship,
                            ShardedPipeline, build_mesh)

    dt, dc = _mesh_dims(opts.mesh)
    nch = opts.channels
    rank = torch.distributed.get_rank()
    mesh = build_mesh(dt, dc, device.type)
    on_chain = _on_chain(opts, demod)
    if on_chain:
        graph, block = _chain_graph(opts, demod, agc_t)
        sh = ShardedChain(graph, mesh, block)
    elif opts.backend == "fused":
        # the largest tile up to the card's autotuned one (the kernel's default
        # without a cache entry) whose mesh granule fits the block size (halved
        # down to 16 frames, so a segment covers the (L+1)-frame halo)
        from ..utils import autotune

        tileF = autotune.lookup("flagship_fused", nch)
        while tileF > 16 and dt * nch * tileF > opts.blocksize:
            tileF //= 2
        gran = dt * nch * tileF
        sh = ShardedFlagship(mesh, nch=nch, block_size=max(opts.blocksize // gran, 1) * gran,
                             kf=demod[1], tileF=tileF)
    else:
        # at least 64 frames per time rank; whole K3/K4 tiles under pfb_fused
        frames = max(opts.blocksize // (dt * nch), 64)
        fused = opts.backend == "pfb_fused"
        if fused:
            frames -= frames % pf.DEFAULT_TILE_F
        sh = ShardedChannelizedFM(mesh=mesh, nch=nch, block_size=frames * dt * nch,
                                  kf=demod[1], agc_threshold_db=agc_t, use_fused=fused)
    runner = ShardedPipeline(sh)
    source = sink = None
    if rank == 0:
        out_bw = opts.bandwidth if opts.bandwidth else opts.samplerate
        opened = source = _open_source(opts, device, sh.block_size)
        if source is None:
            raise RuntimeError("Unable to open source")
        fe = _front_end(opts)
        if fe is not None:
            source = Pipeline(fe, block_size=opts.blocksize, device=device).stream(source)
        source = _plot_taps(opts, source, out_bw)
        sink, collected = _sink(opts, demod, out_bw)
        if opts.verbose:
            print(f"Mesh {dt}x{dc} ({opts.backend}, {device.type}): {type(sh).__name__}, "
                  f"block {sh.block_size}, {sh.block_size // dt} samples per time rank")
            if on_chain:
                _announce("Flow", sh.block, device, sh.block_size)
    t0 = time.perf_counter()
    if sink is None:
        total = runner.run(None, None)
    else:
        try:
            with sink:
                total = runner.run(source, sink, num_samples=opts.numsamples)
        finally:
            opened.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    if rank == 0:
        if opts.verbose and secs > 0:
            n_in = int(total / sh.rate)
            print(f"Throughput: {n_in} samples into the flow in {secs:.3f} s "
                  f"({n_in / secs / 1e6:.2f} MSPS)")
        per = "channel" if nch > 1 and not opts.mix else "stream"
        print(f"Wrote {total} output samples per {per} over mesh {dt}x{dc} "
              f"({'ShardedChain' if on_chain else opts.backend}, {device.type})")
        if demod[0] in PACKET_SUFFIX:
            _report_packet(opts, demod, collected.concat(), out_bw)
        elif collected is not None:
            _report_rds(opts, collected.concat())
    if opts.verbose:
        counts = kernel_launches()
        # one write, so that concurrent ranks' lines do not interleave
        sys.stdout.write(f"Kernel launches on rank {rank}: {json.dumps(counts)}\n")
        sys.stdout.flush()
    return total


def main(argv=None) -> int:
    return run_opts(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
