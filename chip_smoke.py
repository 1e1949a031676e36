#!/usr/bin/env python3
"""Check csdr_tpu_torch on one CUDA card: every kernel and flow against its
plain version, the eager graph, the CPU or the serial run.

    python3 chip_smoke.py          # from the root of a checkout

This script checks and does not time: ``portbench/`` measures the port end
to end (``python3 portbench/run.py --workload <cell> ...``) and
``chip_compare.py`` times kernels and paths alone, in turns across
checkouts.  The oracles it shares with the tier-1 tests (the sync's
either-pick rule, the scan rule, the helicopter frames, the beacons) live
in ``tests/torch_oracles.py``.

Phases, each of which asserts; any failure exits non-zero before the last
line is printed:

  1. identity: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles csdr_tpu_torch/csrc/*.cu for sm_90a (the ptxas
     report: registers, stack frame, spills);
  3. kernel vs plain: the fused CUDA kernel against its plain PyTorch twin
     and the eager graph, over 3 consecutive blocks of the main path's size,
     at nch 64, 20 and 32, for complex64, interleaved cu8 and cu8 planes;
  4. main path: the soapy-sdr CLI (channelized NBFM, 64 channels) over a
     2^25-sample cu8 capture, once fused and once eager; the kernel's launch
     count must move in the fused run, the two runs must agree, and every
     channel must demodulate its own FM tone;

and for the PFB kernels K3 (pfb_fm_fused) and K4 (pfb_channelize_fused):

  3b. kernel vs plain: 3 state-chained blocks of the main path's size at
      nch 64, 20 and 4, each kernel against its plain version (every frame)
      and the eager graph (K3 from frame 1), plus a DFT column shard
      (ncho 32 of 64) against the plain version given the same shard;
  4b. main paths through the CLI: --backend pfb_fused (K3) against phase
      4's runs; per-channel AGC + squelch (K4) on a capture with half the
      channels empty, pfb_fused against eager; the -c 4 DeNo raw split
      (K4), pfb_fused against eager.  Every kernel count is set to 0 before
      each run and read after it: a run's own kernels must have launched,
      no other kernel may have;

and for the FIR kernels K5 (fir_valid) and K6 (fft_fir):

  3c. kernel vs plain: 3 state-chained blocks through the streaming FIR
      (its hist carried), K5 at (64, 2^17) complex x 585 taps, (64, 2^17)
      real x 585, (1, 2^23) complex x 3,651 taps and, at 6b's shape, one
      real row of 1,046,400 samples x the 333-tap RDS data filter; K6 at (1, 2^23)
      complex x the 1,826-tap USB band-pass, real x real 3,651 taps and
      K5's two complex shapes (64, 2^17) x 585 and (1, 2^23) x 3,651; and
      each against the "fft" strategy;
  4c. main paths on a 2^25-sample cu8 capture with keyed CW carriers in
      the even channels of a 64-way split: -c 64 DeCW under --backend
      eager (K5) and pfb_fused (K4 + K5), held against the same flow with
      K5's plain version in its place, every occupied channel's audio on
      its 700 Hz pitch and every empty one >= 20 dB below; -c 1 --offset
      -b 48000 DeCW (front end + K5); -c 1 DeAM -a (no kernel) against the
      same flow on the CPU; K6 through the library (FIRFilter with
      strategy="pallas_fft") against strategy="fft".  Every kernel count
      is set to 0 before each run: a run's own kernels must launch, no
      other;

and for the broadcast-FM flows, the mixed sink and checkpoints (no new
kernel; every kernel count set to 0 before each run and read after it):

  6a. BASELINE config 1: -s 2560000 -b 200000 DeWBFM 8 over a cu8 capture
      of a 1 kHz FM tone at DC: exactly n/8 frames at 25 kHz, the tone at
      >= 40 dB SNR against its de-emphasised message, the card's WAV
      against the port's own --device cpu run on the first 2^22 samples;
  6b. DeFMS 8 --rds on a stereo MPX (19 kHz pilot, L and R tones, RDS
      groups): L/R separation > 20 dB both ways, PS and PI decoded, K5
      (the 333-tap RDS data filter) launched at least once per block;
  6c. BASELINE config 4: -c 16 -m DeNBFM 0.3 under eager, pfb_fused (K3)
      and fused (K1), and -c 16 -m -a (K4); each mixed WAV equals the sum
      of the same flow's per-channel files, and the per-channel runs hold
      K3's and K1's bounds against eager;
  6d. checkpoint: the fused (K1) and eager -c 64 DeNBFM paths through the
      library, run whole and run as a first half, save_pipeline, a new
      Pipeline, resume_pipeline and skip_n: the resumed output equals the
      whole run's second half bit for bit.

and for the multi-device mesh (csdr_tpu_torch/parallel, NCCL, one rank per
card, world = min(cards, 4); at one card the ranks' exchanges are trivial
and ShardedFlagship runs with force_full):

  7a. ShardedFlagship (K1 on every rank) over phase 4's capture through
      ShardedPipeline, against the serial K1 (share of |d| > 0.01 < 0.005,
      99th percentile < 1e-4, carried state < 2e-5); K1 once per sharded
      step on every rank;
  7b. ShardedChannelizedFM on mesh (W, 1) and, at 4 cards, (2, 2): eager,
      K3 and K4 with -a, against the eager single-device graphs (2e-3,
      5e-3 from frame 1, 5e-3);
  7c. the CLI's -c 64 --mesh Wx1 --backend fused in a process of its own,
      each rank's K1 launches, every channel's file against phase 4's
      fused run.
  Every rank's kernel counts are set to 0 before each run and read after
  it.  ``python3 chip_smoke.py --mesh-only`` runs identity, build, phase 4
  and phase 7 alone.

and for the packet receivers (models/ais, aprs, adsb, pocsag, rtty):

  8.  seeded 2^25-sample cu8 captures made with the port's own
      transmitters: DeADSB at -s 2000000 (4,000 DF17 ident, position and
      velocity frames spread over the capture), DeAIS at -s 1920000 --offset 25000 -b 48000
      (GMSK bursts on one channel), DeAPRS at --offset -60000 -b 48000
      (keyed NBFM with AX.25 UI frames), DePOCSAG at --offset 150000
      -b 38400 (alpha and numeric pages) and DeRTTY at --offset 300000
      -b 48000 (USB, 45.45 Bd: its two 1,056-tap bit filters run on K5,
      held against its plain version at that shape in 3c).  Each flow on
      the card must decode every injected message and nothing else, write
      the same .txt as its --device cpu run, and launch its kernels (K5 in
      DeRTTY) and no other; then the band monitor (pocsag_band_monitor, 64
      channels x 38.4 kHz, pages on four channels) through the library,
      pfb_fused (K4) against eager: 2e-3 on the envelopes and on the paged
      channels' scores, and every page decoded on its channel.

and for symbol sync, the coded modem and the beacon (K4 and the block
sync's K9 on the DeNBFMSync path):

  9.  a seeded 2^25-sample cu8 capture with helicopter 2-FSK frames (4,000
      baud, own coordinates, start phase and a clock within ±100 ppm) on 8
      of 64 channels: 9a K4 at the DeNBFMSync graph's block (8,376,320
      samples, F = 130,880) against its plain version, and
      PerChannel(fm_dem_with_sync(10)) on the card against the CPU on the
      occupied channels; 9b -c 64 "DeNBFMSync 10" under pfb_fused (K4 once
      and K9 twice per block, no other kernel) and eager (K9 alone), K9
      alone at the flow's panel against its plain version (either pick,
      τ), the occupied channels against each other, helidecode's
      coordinates on every occupied channel on both backends (the same
      count) and none on the empty ones; 9c -c 1 --offset -b 48000
      "DeNBFMSync 12" (4,000 baud at 48 kHz) on the card and the CPU; 9d
      the library: 64 coded qpsk and 64 qam16 packets through sym_tracker
      and coded_packet_demodulate on the card, 32 beacons at −13 dB through
      beacon_decode, FSKDemod against the CPU.
      The sync outputs are held to 2e-3 of the reference's output or, where
      float order picks (a phase-rounding tie, a window at an integer), of
      its output of the other pick.
      ``python3 chip_smoke.py --sync-only`` runs identity, build and 9.

and for the imagery receivers and the CLI's file surface (no new kernel; K1
on WAV input and K3 under --profile):

  10. 10a the offline decoders on the card and with --device cpu, inputs
      made by the port's own modulators: an APT pass of 1,200 lines (10 min
      at 33,280 Hz, .f32) and a 120-line .cf32 WBFM capture through the
      app's FM front, one SSTV Martin 1 image (320 × 256 at 11,025 Hz), one
      WEFAX chart of 600 lines at 120 lpm (12,000 Hz).  The card's track
      within 2e-5 of the CPU's largest value (the Hz tracks from output 180,
      the FIR's start-up), the same lines and sync positions, the images
      within 1 LSB, the error against the transmitted image within the JAX
      tests' bounds.
      10b a mono float32 WAV of 2^24 samples (an FM carrier in every channel
      of the IQ it lifts to): wav_iq_source card against CPU over the first
      2^20 outputs (2e-5), then -c 64 "DeNBFM 0.6 F32" --backend fused (K1)
      against eager at K1's bounds from frame 1.  10c -c 64 --backend
      pfb_fused --profile on a 2^24-sample cf32
      capture: the stage table, K3 once per block, the 64 files bit-equal
      to the run without --profile.  10d -c 1 --offset -b DeAM AU read back
      with read_au equal to the F32 run, and its --spectrum and
      --constellation scripts within 1e-4 of the --device cpu run's.
      ``python3 chip_smoke.py --imagery-only`` runs identity, build and 10.

and for the live-device path (no new kernel; K1 on the rtl_tcp flow and the
tile candidates, K3 on the synthetic device):

  11. 11a the port's rtl_tcp_server, a process of its own, serves a seeded
      2^25-sample cu8 capture of phase 4's kind; the CLI runs --devname
      rtl_tcp -s 2.56e6 -f 100e6 --ppm 3 -n 2^25 -c 64 "DeNBFM 0.6 F32"
      --backend fused on it: its 64 files bit-equal to the --filename run of
      the same samples as CF32 (the client's own conversion) and within
      U8_ERR of the cu8 file run, each source's two runs equal, every
      channel on its tone, the server's command log (rate, frequency, gain
      mode 0, ppm 3), K1's launches.  11b --devname synthetic
      -n 2^24 -c 64 on pfb_fused (K3) and eager, each bit-equal to the
      --filename run of the synthetic samples saved, K3 against eager on the
      four occupied channels.  11c native_cf32_source against
      cf32_file_source on a 2^25-sample CF32 file (the same bytes) and
      NativeRawFileSink's round trip.  11d K1 at every tileF candidate at
      nch 64 on cu8 2^23 (a tile the wrapper's own checks refuse is
      recorded as infeasible) within K1's bounds of the default tile.
      ``python3 chip_smoke.py --device-only`` runs identity, build and 11.

and for the generic sharded chain (csdr_tpu_torch/parallel/generic.py, the
time layout; K5 on every rank; NCCL, world = min(cards, 4), one rank per
card, trivial exchanges at one card):

  12. 12a the library ShardedChain over phase 4's capture through
      ShardedPipeline in 2^23-sample blocks (twice: the second run on the
      same communicators): u8_to_iq >> dc_blocker >>
      cw_demodulator at the -c 1 -b 48000 "DeCW 500 700" design (its
      701-tap low-pass on K5) and the -b 200000 DeWBFM 8 chain, each
      against the serial port Pipeline on rank 0's card (K5's 1e-4, 2e-3),
      K5 once per block on every rank, no other kernel.  12b the CLI's -c 1
      --offset -b 48000 --mesh Wx1 "DeCW 500 700 WAV" -v in a process of
      its own, in 2^17-sample blocks so every rank's segment holds samples,
      against the serial CLI's file (1e-4), each rank's launches (K5 once
      per block).  12c the channel layout through the library, on (W, 1)
      and, on four cards, (2, 2): u8_to_iq >> dc_blocker >>
      firpfbch_channelizer(64) >> PerChannel(cw_demodulator) at the -c 64
      "DeCW 500 700" design (585 taps on K5 in every channel; each rank
      runs K5 on its (64/C, 2^23/T/64 + 584) panel) on phase 4's capture,
      against the serial Pipeline (1e-4), K5 once per block on every rank
      and nothing else of K1-K6; and the -c 16 -m DeNBFM mixed monitor
      (>> PerChannel(fm_demodulator) >> MixChannels) on a 16-channel
      capture (2e-3, no kernel).  12d
      the CLI's -c 64 --mesh Wx1 (and 2x2 on four cards) "DeCW 500 700
      WAV" and -c 16 -m --mesh Wx1 "DeNBFM 0.6 WAV", each in a process of
      its own, against the serial --backend eager CLI's files (1e-4 and
      2e-3), K5 launches per rank.  12e the
      library ShardedChain over the inputs that phases 6b, 8 and 9 make
      (the stereo and helicopter captures at 2^25 samples, the AIS, APRS and
      RTTY ones at 2^23, each behind its front end): the DeFMS 8 --rds Tee
      (K5 once per block per rank, the 333-tap RDS filter), the AIS, APRS
      and RTTY receivers (RTTY's two 1,056-tap tone filters on K5), -c 1
      DeNBFMSync 12 at 48 kHz and the -c 64 DeNBFMSync 10 channel graph on
      (W, 1) and, on four cards, (2, 2), each against the serial Pipeline at
      the same block (K5's 1e-4, 2e-3, bits and decoded messages equal, the
      sync within 2e-3 of either pick on full blocks).  12f the CLI's
      --mesh Wx1 "DeFMS 8 WAV" --rds, DeAIS and -c 64 "DeNBFMSync 10",
      each in a process of its own, against the serial CLI's files.
      ``python3 chip_smoke.py --chain-only`` runs identity, build, phase
      4's capture and 12.

and for the serial per-sample recurrences and the bundle (K7 pll_scan and
K8 symsync_scan, the port's own kernels with no Pallas counterpart; K4, K5
and K1 on their paths):

  13. 13a K7 against its twin (one noisy pilot row of 2^16 samples, two
      state-chained blocks, then with runs of exact zeros and from carries
      of θ = ±20, freq = 0.5: 2e-3, θ within 1e-4) and K8 through
      SymSyncScan against its twin (4 rows of the JAX sync tests' signals
      with their own clocks, real k = 10 and complex k = 4, three blocks of
      2^14, and a carried η of −30 that runs τ back through the row: every
      output and τ bit for bit, the twin stepping and summing in the
      kernel's order).  13b the scan modes at full width through the
      library: DeFMS 8
      --rds with pll_mode="scan" on phase 6b's capture behind the CLI's
      front end (L/R separation > 15 dB on the second half, PI and PS,
      K7 once per block, K5 at least once, nothing else), and the -c 64
      DeNBFMSync 10 tracker with mode="scan" behind K4 on phase 9's capture
      (K8 and K4 once per block, nothing else; helidecode finds only the
      sent coordinate on each occupied channel, at least every one sent
      after the first block, nothing on the empty ones); K7/K8 alone on
      the arguments the flow's first block hands them (``kernel_inputs``;
      that block launches each once), held against their twins on the CPU
      at that shape (K7 over the first 2^16 outputs and θ at the cut,
      1e-5; K8 over every output and τ, bit for bit).  13c the port's
      bundle (apps/package_app,
      not self-contained, its kernel library removed) runs phase 4's -c 64
      --backend fused --device cuda flow through its launcher in a process
      of its own: its kernel library is built from the zipapp's sources in
      the bundle's build directory, K1 launches once per block and nothing
      else (its -v line), its files equal the repo CLI's bit for bit.
      ``python3 chip_smoke.py --scan-only`` runs identity, build, phase 4's
      capture and fused CLI run, and 13.  Every phase prints its seconds
      ({"phase": "seconds", ...}).

Prints one JSON object per result, then the nvidia-smi line, the kernels
line (per kernel: what it replaces, its launches on the flows that run it,
its largest error against its plain version, its shape; K3/K4 and K5 add
their ptxas report) and, last, {"ok": true, "device": {...}}.  Nothing
here imports JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "tests"))
from torch_oracles import (BEACON_REFUSED, BEACONS, BEACON_SNR_DB, SEED, SYNC_TIE,  # noqa: E402
                           SYNC_TOL, beacon_set, heli_coord, heli_decode, heli_levels,
                           heli_text, other_pick, record_ties, sync_rows)

BLOCK = 1 << 23          # the main path's block: 64 MB of CF32 in, 32 MB of audio out
CAPTURE = 1 << 25        # main-path capture: 64 MB of cu8, four blocks
KF = 0.6
# bounds (tests/test_flagship_fused_wide.py:66-67, tests/test_flagship_fused.py:70)
MAX_ERR, RMS_ERR, U8_ERR = 1.2e-3, 4e-5, 2e-4
# K3/K4 (tests/test_pallas_fused.py:55, tests/test_pfb_channelize_fused.py:39;
# RMS as above, the same arithmetic); the AGC flow, relative to the largest
# output (tests/test_sharding.py:208-210)
PFB_MAX_ERR, AGC_REL_ERR = 2e-3, 5e-3
AGC_T = -48.0            # squelch threshold (dB) of the half-empty capture
AGC_MARGIN = 15.0        # dB every channel must keep from it
# K5 and K6, relative to the largest output; K6 (tests/test_fftfir.py:36)
# also against the "fft" strategy (tests/test_fftfir.py:82).  K5 is held
# tighter than the JAX package's 2e-3 (tests/test_pallas_fir.py:21): its
# bf16x3 products read ~1e-5, one of them left out reads ~2e-3
# (tests/test_torch_fir.py, test_k5_bound_catches_a_dropped_product)
K5_REL_ERR, K6_REL_ERR, K6_FFT_REL_ERR = 1e-4, 2e-4, 3e-4
CW_BW, CW_PITCH = 500.0, 700.0   # Hz: "DeCW 500 700 WAV"
CW_EMPTY_DB = 20.0       # an empty channel's audio stays this far below
CW_DIT_S = 0.06          # keying unit of the CW carriers, seconds
CW_TUNE = 100.0          # Hz the -c 1 flow tunes below its carrier
AM_T = -70.0             # squelch of the DeAM -a run, far below the noise floor
FM_BW = 200000.0         # -b of the broadcast flows: the quad rate
WBFM_TONE = 1000.0       # Hz, the config 1 station's message
# the tone's modulation index is the 12th zero of J0, so the FM signal has no
# carrier line at DC for the flow's DC blocker to notch out
WBFM_BETA = 36.91709835366404
SNR_DB = 40.0            # tests/test_baseline_configs.py:59
CPU_REL_ERR = 1e-4       # the card's broadcast WAV against the CPU's
FMS_L, FMS_R = 1000.0, 2500.0    # Hz, the left and right tones of the MPX
SEP_DB = 20.0            # tests/test_symsync_stereo.py:246
RDS_PI, RDS_PS = 0xC5D7, "PORTTEST"
MIX_NCH = 16             # BASELINE config 4
MIX_REL_ERR = 1e-5       # a mixed WAV against the sum of its per-channel files


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def occupied_band(torch, dev, nch: int, n: int, seed: int, tones=None, channels=None,
                  noise: float = 0.01):
    """An FM carrier on every channel centre (channel k at (k − (nch−1)/2)/nch
    cycles/sample) plus noise, made on the device in float64 from a numpy
    seed.  Every channel is occupied, so no channel magnitude sits near zero
    where atan2 amplifies float32 rounding by 1/|d|.  ``tones[k]`` is channel
    k's modulating frequency in cycles per input sample; ``channels`` limits
    the carriers to those channels, ``noise`` is the noise's std per
    component."""
    rng = np.random.default_rng(seed)
    if tones is None:
        tones = 0.002 / nch * (1 + np.arange(nch) % 5)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    x = torch.zeros(n, dtype=torch.complex128, device=dev)
    amp = 0.6 / np.sqrt(nch)
    for k in (range(nch) if channels is None else channels):
        fc = (k - (nch - 1) / 2) / nch
        ph = (2 * np.pi * torch.remainder(fc * t, 1.0)
              + 2.0 * torch.sin(2 * np.pi * torch.remainder(float(tones[k]) * t, 1.0))
              + float(rng.uniform(0, 2 * np.pi)))
        x += amp * torch.polar(torch.ones_like(ph), ph)
    noise = rng.standard_normal((n, 2), dtype=np.float32) * np.float32(noise)
    x += torch.view_as_complex(torch.from_numpy(noise).to(dev)).to(torch.complex128)
    return x.to(torch.complex64)


def to_cu8(torch, x):
    """complex → interleaved rtl_sdr uint8 (2n,), 60 LSB per unit."""
    ri = torch.view_as_real(x) * 60.0 + 127.5
    return torch.clamp(torch.round(ri), 0, 255).to(torch.uint8).reshape(-1)


def errors(a, b) -> tuple[float, float]:
    d = (a.double() - b.double()).abs()
    return d.max().item(), d.pow(2).mean().sqrt().item()


def errors_np(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    d = np.abs(a.astype(np.float64) - b)
    return float(d.max()), float(np.sqrt((d ** 2).mean()))


def ptxas_summary(lib) -> dict:
    """Registers and spills per kernel, from the build's ``-Xptxas -v`` log."""
    log = lib.with_name(lib.name.replace("libcsdr_kernels-", "nvcc-").replace(".so", ".log"))
    out, name = {}, None
    for ln in log.read_text().splitlines():
        m = re.search(r"Compiling entry function .*?(dc_chunk|channel_tile|carry_scan|pfb_tile|"
                      r"fir_valid_tile|fft_fir_segment)"
                      r"(?:I((?:L[a-z]\d+E)+)E|I((?:f|6float2|S\d*_)+)E)?", ln)
        if m:
            targs = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
            # type arguments: f = float; 6float2, or a back-reference to it
            targs += ["float" if t == "f" else "float2"
                      for t in re.findall(r"6float2|S\d*_|f", m.group(3) or "")]
            name = m.group(1) + (f"<{','.join(targs)}>" if targs else "")
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return out


def block_len(nch: int, tileF: int) -> int:
    g = nch * tileF
    return (BLOCK // g) * g


def phase_compare(torch, ct, ff, dev, card):
    """Kernel vs twin (every frame) and vs the eager graph (frames >= 1), at
    nch 64 (64 = 16 × 4: four lanes per frame), 20 (direct DFT) and 32
    (16 × 2)."""
    result = {}
    for nch in (64, 20, 32):
        n = block_len(nch, ff.DEFAULT_TILE_F)
        x = occupied_band(torch, dev, nch, 3 * n, SEED + nch)
        u8 = to_cu8(torch, x)
        conv = (u8.to(torch.float32) - 127.5) / 127.5  # host-style conversion, on device
        x_conv = torch.complex(conv[0::2], conv[1::2])
        eager = ct.channelized_fm_receiver(nch, kf=KF, backend="eager")
        eager_u8 = ct.chain(ct.u8_to_iq(), eager)
        outs = {}
        for fmt in ("f32", "u8", "u8_planes", "f32_of_u8"):
            sk = ff.flagship_fused_init(nch, dev)
            st = ff.flagship_fused_init(nch, dev)
            g = eager_u8 if fmt.startswith("u8") else eager
            se = g.init(dev)
            ks, ts, es = [], [], []
            for b in range(3):
                if fmt == "f32":
                    xb = x[b * n:(b + 1) * n]
                elif fmt == "f32_of_u8":
                    xb = x_conv[b * n:(b + 1) * n]
                else:
                    xb = u8[2 * b * n:2 * (b + 1) * n]
                    if fmt == "u8_planes":
                        xb = (xb[0::2].contiguous(), xb[1::2].contiguous())
                sk, yk = ff.flagship_fused_step(sk, xb, nch=nch, kf=KF)
                st, yt = ff.flagship_fused_ref(st, xb, nch=nch, kf=KF)
                xe = xb if fmt.startswith("f32") else u8[2 * b * n:2 * (b + 1) * n].view(n, 2)
                se, ye = g.apply(se, xe)
                ks.append(yk), ts.append(yt), es.append(ye)
            yk, yt, ye = (torch.cat(v, dim=1) for v in (ks, ts, es))
            torch.cuda.synchronize()
            check(yk.shape == (nch, 3 * n // nch), f"nch={nch} {fmt}: shape {tuple(yk.shape)}")
            check(bool(torch.isfinite(yk).all()), f"nch={nch} {fmt}: non-finite audio")
            tw_max, tw_rms = errors(yk, yt)
            ea_max, ea_rms = errors(yk[:, 1:], ye[:, 1:])
            emit(dict(phase="compare", nch=nch, input=fmt, n_per_block=n, blocks=3,
                      vs_twin_max=tw_max, vs_twin_rms=tw_rms,
                      vs_eager_max=ea_max, vs_eager_rms=ea_rms, **card))
            check(tw_max < MAX_ERR and tw_rms < RMS_ERR,
                  f"nch={nch} {fmt}: kernel vs twin max {tw_max} rms {tw_rms}")
            check(ea_max < MAX_ERR and ea_rms < RMS_ERR,
                  f"nch={nch} {fmt}: kernel vs eager max {ea_max} rms {ea_rms}")
            outs[fmt] = yk
            result[(nch, fmt)] = tw_max
        planes_max, _ = errors(outs["u8"], outs["u8_planes"])
        conv_max, _ = errors(outs["u8"], outs["f32_of_u8"])
        emit(dict(phase="compare_u8", nch=nch, u8_vs_planes_max=planes_max,
                  u8_vs_f32_of_u8_max=conv_max, **card))
        check(planes_max < U8_ERR, f"nch={nch}: u8 interleaved vs planes {planes_max}")
        check(conv_max < U8_ERR, f"nch={nch}: u8 in-kernel vs host conversion {conv_max}")
    return result


def reset_counts():
    from csdr_tpu_torch.ops.cuda import reset_kernel_launches

    reset_kernel_launches()


def read_counts() -> dict:
    from csdr_tpu_torch.ops.cuda import kernel_launches

    return kernel_launches()


def pfb_plain_step(torch, pf, state, x, nch: int, demod: bool):
    """The K3 (demod) or K4 streaming step with the kernel's plain version in
    its place: the NCO and panels of channelized_fm_pfb_step /
    channelize_pfb_step, then pfb_fm_fused_ref / pfb_channelize_fused_ref."""
    from csdr_tpu_torch.ops.nco import mix_stream
    from csdr_tpu_torch.ops.pfb import pfb_offset

    phase, hist_x, hist_v = state if demod else (state[0], *state[1])
    phase, xs = mix_stream(phase, x, pfb_offset(nch), up=False)
    hist_x, vfull = pf.frame_panels(hist_x, hist_v, xs, nch)
    taps, W = pf.pfb_design(nch, 7, 80.0, x.device)
    fn = pf.pfb_fm_fused_ref if demod else pf.pfb_channelize_fused_ref
    y = fn(vfull, taps, W, nch=nch, L=14, **({"kf": KF} if demod else {}))
    hist_v = vfull[y.shape[1]:].clone()
    return ((phase, hist_x, hist_v) if demod else (phase, (hist_x, hist_v))), y


def block_panels(torch, pf, x, nch: int):
    """K3's panels (F + 14, nch) of one block from zero history, NCO-shifted
    as on the main path.  Without the shift every carrier sits on a channel
    edge, its demod phase step is ≈π, and atan2's ±π branch cut flips
    between two right implementations."""
    from csdr_tpu_torch.ops.nco import mix_stream
    from csdr_tpu_torch.ops.pfb import pfb_offset

    _, xs = mix_stream(torch.zeros((), device=x.device), x, pfb_offset(nch), up=False)
    return pf.frame_panels(torch.zeros(nch - 1, dtype=torch.complex64, device=x.device),
                           torch.zeros(14, nch, dtype=torch.complex64, device=x.device),
                           xs, nch)[1]


def as_real(torch, y):
    return torch.view_as_real(y) if y.is_complex() else y


def phase_compare_pfb(torch, ct, pf, dev, card):
    """3b. K3 and K4 streaming steps vs their plain versions (every frame)
    and the eager graphs (K3 from frame 1), and a DFT column shard."""
    result = {}
    for nch in (64, 20, 4):
        n = block_len(nch, pf.DEFAULT_TILE_F)
        x = occupied_band(torch, dev, nch, 3 * n, SEED + 100 + nch)
        eager = {True: ct.chain(ct.firpfbch_channelizer(nch),
                                ct.PerChannel(ct.fm_demodulator(KF), nch)),
                 False: ct.firpfbch_channelizer(nch)}
        for demod, name in ((True, "pfb_fm_fused"), (False, "pfb_channelize_fused")):
            if demod:
                sk = st = pf.channelized_fm_pfb_init(nch, dev)
                step = lambda s, xb: pf.channelized_fm_pfb_step(s, xb, nch=nch, kf=KF)
            else:
                sk = st = eager[False].init(dev)
                step = lambda s, xb: pf.channelize_pfb_step(s, xb, nch=nch)
            se = eager[demod].init(dev)
            ks, ts, es = [], [], []
            before = pf.launches[name]
            for b in range(3):
                xb = x[b * n:(b + 1) * n]
                sk, yk = step(sk, xb)
                st, yt = pfb_plain_step(torch, pf, st, xb, nch, demod)
                se, ye = eager[demod].apply(se, xb)
                ks.append(yk), ts.append(yt), es.append(ye)
            torch.cuda.synchronize()
            check(pf.launches[name] == before + 3, f"{name} nch={nch}: launch count")
            yk, yt, ye = (as_real(torch, torch.cat(v, dim=1)) for v in (ks, ts, es))
            check(yk.shape[:2] == (nch, 3 * n // nch), f"{name} nch={nch}: shape {tuple(yk.shape)}")
            check(bool(torch.isfinite(yk).all()), f"{name} nch={nch}: non-finite output")
            f0 = 1 if demod else 0  # K3's demod history starts at zeros
            tw_max, tw_rms = errors(yk, yt)
            ea_max, ea_rms = errors(yk[:, f0:], ye[:, f0:])
            emit(dict(phase="compare_pfb", kernel=name, nch=nch, n_per_block=n, blocks=3,
                      vs_plain_max=tw_max, vs_plain_rms=tw_rms, vs_eager_max=ea_max,
                      vs_eager_rms=ea_rms, eager_from_frame=f0, **card))
            check(tw_max < PFB_MAX_ERR and tw_rms < RMS_ERR,
                  f"{name} nch={nch}: kernel vs plain max {tw_max} rms {tw_rms}")
            check(ea_max < PFB_MAX_ERR and ea_rms < RMS_ERR,
                  f"{name} nch={nch}: kernel vs eager max {ea_max} rms {ea_rms}")
            result[(name, nch)] = tw_max

    # a column shard of the DFT matrix, as the channel-sharded mesh gives it
    nch, c0 = 64, 32
    n = block_len(nch, pf.DEFAULT_TILE_F)
    x = occupied_band(torch, dev, nch, n, SEED + 200)
    taps, W = pf.pfb_design(nch, 7, 80.0, dev)
    vfull = block_panels(torch, pf, x, nch)
    for name, v, fn, ref in (("pfb_fm_fused", vfull, pf.pfb_fm_fused, pf.pfb_fm_fused_ref),
                             ("pfb_channelize_fused", vfull[1:].contiguous(),
                              pf.pfb_channelize_fused, pf.pfb_channelize_fused_ref)):
        yk = fn(v, taps, W[:, c0:], nch=nch, L=14)
        yt = ref(v, taps, W[:, c0:].contiguous(), nch=nch, L=14)
        torch.cuda.synchronize()
        check(yk.shape == yt.shape == (nch - c0, n // nch), f"{name} shard: shape")
        sh_max, sh_rms = errors(as_real(torch, yk), as_real(torch, yt))
        emit(dict(phase="compare_pfb_shard", kernel=name, nch=nch, columns=[c0, nch],
                  vs_plain_max=sh_max, vs_plain_rms=sh_rms, **card))
        check(sh_max < PFB_MAX_ERR and sh_rms < RMS_ERR,
              f"{name} column shard: kernel vs plain max {sh_max} rms {sh_rms}")
    return result


def main_capture(torch, dev, tmp) -> tuple[str, np.ndarray]:
    """Phase 4's 2^25-sample cu8 capture, an FM carrier on each of 64
    channel centres, written to ``tmp``: (path, j), channel k's tone sitting
    on an exact FFT bin of its audio, j_k cycles per 1024 frames, j_k = 5 +
    3·(k mod 7)."""
    nch = 64
    j = 5 + 3 * (np.arange(nch) % 7)
    x = occupied_band(torch, dev, nch, CAPTURE, SEED, tones=j / 1024.0 / nch)
    path = os.path.join(tmp, "capture.cu8")
    to_cu8(torch, x).cpu().numpy().tofile(path)
    del x
    check(os.path.getsize(path) == 2 * CAPTURE, "capture size")
    return path, j


def phase_main_path(torch, ff, pf, dev, card, tmp):
    """The CLI's channelized NBFM flow over a cu8 capture, fused and eager."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu_torch.ops.cuda import fft_fir as fx
    from csdr_tpu_torch.ops.cuda import fir_valid as fv

    nch = 64
    frames = CAPTURE // nch
    path, j = main_capture(torch, dev, tmp)

    runs = {}
    for backend in ("fused", "eager"):
        out = os.path.join(tmp, backend)
        argv = ["--filename", path, "-n", str(CAPTURE), "-c", str(nch), "-o", out,
                "--demod", f"DeNBFM {KF} F32", "--backend", backend, "--device", "cuda",
                "--blocksize", str(BLOCK)]
        torch.cuda.synchronize()
        reset_counts()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        launches = ff.launches
        check(rc == 0, f"CLI {backend} exit code {rc}")
        check(fv.launches == fx.launches == 0, f"the {backend} CLI run launched a FIR kernel")
        files = sorted(f for f in os.listdir(tmp) if f.startswith(f"{backend}_ch"))
        check(len(files) == nch, f"CLI {backend}: {len(files)} output files, want {nch}")
        for f in files:
            size = os.path.getsize(os.path.join(tmp, f))
            check(size == frames * 4, f"CLI {backend}: {f} has {size} bytes, want {frames * 4}")
        audio = np.stack([np.fromfile(os.path.join(out + f"_ch{k + 1}.f32"), np.float32)
                          for k in range(nch)])
        check(bool(np.isfinite(audio).all()), f"CLI {backend}: non-finite audio")
        runs[backend] = audio
        emit(dict(phase="main_path", backend=backend, wire="cu8", samples=CAPTURE,
                  channels=nch, blocksize=BLOCK, flagship_fused_launches=launches, **card))
        check(not any(pf.launches.values()), f"the {backend} CLI run launched a PFB kernel")
        if backend == "fused":
            check(launches > 0, "the fused CLI run launched the kernel no time")
            fused_launches = launches
        else:
            check(launches == 0, "the eager CLI run launched the fused kernel")

    emax, erms = errors_np(runs["fused"][:, 1:], runs["eager"][:, 1:])
    # every channel demodulates its own tone: the audio's spectral peak sits
    # on bin j_k·frames/1024
    spec = np.abs(np.fft.rfft(runs["fused"] - runs["fused"].mean(axis=1, keepdims=True),
                              axis=1))
    peaks = spec[:, 1:].argmax(axis=1) + 1
    want = j * (frames // 1024)
    emit(dict(phase="main_path_check", fused_vs_eager_max=emax, fused_vs_eager_rms=erms,
              channels_on_their_tone=int((peaks == want).sum()), channels=nch, **card))
    check(emax < MAX_ERR and erms < RMS_ERR, f"CLI fused vs eager max {emax} rms {erms}")
    check(bool((peaks == want).all()),
          f"channels off their tone: {np.flatnonzero(peaks != want).tolist()}")
    return fused_launches, runs, path, want


def cli_run(torch, cli_main, argv: list[str]) -> dict:
    """One CLI run with every kernel count set to 0 just before it; returns
    the counts just after."""

    torch.cuda.synchronize()
    reset_counts()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"CLI {' '.join(argv[-8:])}: exit code {rc}")
    return read_counts()


def check_counts(counts: dict, want, what: str):
    """Every kernel named in ``want`` (a name, a tuple of names or None)
    launched, no other did."""
    want = () if want is None else (want,) if isinstance(want, str) else tuple(want)
    for k, v in counts.items():
        if k in want:
            check(v > 0, f"{what}: {k} launched no time")
        else:
            check(v == 0, f"{what}: {k} launched {v} times")


def read_channels(prefix: str, ext: str, dtype, nch: int, size: int):
    for k in range(nch):
        got = os.path.getsize(f"{prefix}_ch{k + 1}.{ext}")
        check(got == size, f"{prefix}_ch{k + 1}.{ext} has {got} bytes, want {size}")
    return np.stack([np.fromfile(f"{prefix}_ch{k + 1}.{ext}", dtype) for k in range(nch)])


def tone_peaks(audio: np.ndarray) -> np.ndarray:
    spec = np.abs(np.fft.rfft(audio - audio.mean(axis=1, keepdims=True), axis=1))
    return spec[:, 1:].argmax(axis=1) + 1


def write_agc_capture(torch, ct, dev, card, tmp) -> str:
    """The half-empty 64-channel cu8 capture of the AGC flows: even channels
    occupied, odd ones empty, each AGC_MARGIN dB or more from the squelch."""
    nch = 64
    j = 5 + 3 * (np.arange(nch) % 7)
    x = occupied_band(torch, dev, nch, CAPTURE, SEED + 300, tones=j / 1024.0 / nch,
                      channels=range(0, nch, 2), noise=0.002)
    u8 = to_cu8(torch, x)
    del x
    # every channel keeps AGC_MARGIN dB from the threshold, reckoned at the
    # channelizer's output (rssi ≈ 20·log10|d| once the loop has settled)
    g = ct.chain(ct.u8_to_iq(), ct.dc_blocker(), ct.firpfbch_channelizer(nch))
    _, d = g.apply(g.init(dev), u8[:2 * BLOCK].view(BLOCK, 2))
    settled = d[:, d.shape[1] // 8:]  # past the DC blocker's and the PFB's transients
    level = (20 * torch.log10(settled.abs().pow(2).mean(dim=1).sqrt())).cpu().numpy()
    agc_path = os.path.join(tmp, "half_empty.cu8")
    u8.cpu().numpy().tofile(agc_path)
    del u8, d, settled
    emit(dict(phase="agc_capture", threshold_db=AGC_T, occupied_min_db=float(level[0::2].min()),
              empty_max_db=float(level[1::2].max()), **card))
    check(level[0::2].min() > AGC_T + AGC_MARGIN and level[1::2].max() < AGC_T - AGC_MARGIN,
          f"half-empty capture too close to the squelch: {level.round(1).tolist()}")
    return agc_path


def phase_main_path_pfb(torch, ct, dev, card, tmp, capture, runs, want_bins):
    """4b. The K3 and K4 flows through the CLI at 64 channels."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main

    nch = 64
    frames = CAPTURE // nch
    common = ["-n", str(CAPTURE), "--device", "cuda", "--blocksize", str(BLOCK)]
    out = {}

    # K3: --backend pfb_fused against phase 4's fused and eager runs
    prefix = os.path.join(tmp, "pfb_fused")
    counts = cli_run(torch, cli_main, ["--filename", capture, "-c", str(nch), "-o", prefix,
                                       "--demod", f"DeNBFM {KF} F32", "--backend", "pfb_fused",
                                       *common])
    check_counts(counts, "pfb_fm_fused", "CLI pfb_fused")
    audio = read_channels(prefix, "f32", np.float32, nch, frames * 4)
    check(bool(np.isfinite(audio).all()), "CLI pfb_fused: non-finite audio")
    vs = {b: errors_np(audio[:, 1:], runs[b][:, 1:]) for b in ("fused", "eager")}
    on_tone = int((tone_peaks(audio) == want_bins).sum())
    emit(dict(phase="main_path_pfb", flow="DeNBFM", backend="pfb_fused", wire="cu8",
              samples=CAPTURE, channels=nch,
              launches=counts, vs_fused_max=vs["fused"][0], vs_fused_rms=vs["fused"][1],
              vs_eager_max=vs["eager"][0], vs_eager_rms=vs["eager"][1],
              channels_on_their_tone=on_tone, **card))
    for b, (mx, rms) in vs.items():
        check(mx < PFB_MAX_ERR and rms < RMS_ERR, f"CLI pfb_fused vs {b}: max {mx} rms {rms}")
    check(on_tone == nch, "CLI pfb_fused: channels off their tone")
    out["pfb_fm_fused"] = dict(launches=counts["pfb_fm_fused"])

    # K4 with AGC + squelch: even channels occupied, odd ones empty
    agc_path = write_agc_capture(torch, ct, dev, card, tmp)
    agc = {}
    for backend in ("pfb_fused", "eager"):
        prefix = os.path.join(tmp, f"agc_{backend}")
        counts = cli_run(torch, cli_main, [
            "--filename", agc_path, "-c", str(nch), "-o", prefix, "--demod", f"DeNBFM {KF} F32",
            "-a", str(AGC_T), "--backend", backend, *common])
        check_counts(counts, "pfb_channelize_fused" if backend == "pfb_fused" else None,
                     f"CLI -a {AGC_T} {backend}")
        audio = read_channels(prefix, "f32", np.float32, nch, frames * 4)
        check(bool(np.isfinite(audio).all()), f"CLI -a {backend}: non-finite audio")
        agc[backend] = (audio, counts)
    got, want = agc["pfb_fused"][0], agc["eager"][0]
    rel = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
    on_tone = int((tone_peaks(got[0::2]) == want_bins[0::2]).sum())
    closed = [int(not a[1::2].any()) for a in (got, want)]
    emit(dict(phase="main_path_pfb", flow="DeNBFM -a", backend="pfb_fused", wire="cu8",
              samples=CAPTURE, channels=nch, threshold_db=AGC_T,
              launches=agc["pfb_fused"][1], vs_eager_rel=rel,
              occupied_on_their_tone=on_tone, empty_all_zero=closed, **card))
    check(rel < AGC_REL_ERR, f"CLI AGC pfb_fused vs eager: rel {rel}")
    check(closed == [1, 1], "CLI AGC: an empty channel let audio through the squelch")
    check(on_tone == nch // 2, "CLI AGC: occupied channels off their tone")
    out["pfb_channelize_fused"] = dict(launches=agc["pfb_fused"][1]["pfb_channelize_fused"])

    # K4 raw split: -c 4 --demod DeNo, pfb_fused against eager
    split = {}
    for backend in ("pfb_fused", "eager"):
        prefix = os.path.join(tmp, f"raw_{backend}")
        counts = cli_run(torch, cli_main, [
            "--filename", capture, "-c", "4", "-o", prefix, "--demod", "DeNo",
            "--backend", backend, *common])
        check_counts(counts, "pfb_channelize_fused" if backend == "pfb_fused" else None,
                     f"CLI -c 4 DeNo {backend}")
        split[backend] = (read_channels(prefix, "cf32", np.complex64, 4, CAPTURE // 4 * 8),
                          counts)
        for k in range(4):
            os.unlink(f"{prefix}_ch{k + 1}.cf32")
    got, want = split["pfb_fused"][0], split["eager"][0]
    mx, rms = errors_np(got.view(np.float32), want.view(np.float32))
    emit(dict(phase="main_path_pfb", flow="-c 4 DeNo", backend="pfb_fused", wire="cu8",
              samples=CAPTURE, channels=4, launches=split["pfb_fused"][1],
              vs_eager_max=mx, vs_eager_rms=rms, **card))
    check(bool(np.isfinite(got).all()), "CLI DeNo: non-finite output")
    check(mx < PFB_MAX_ERR and rms < RMS_ERR, f"CLI DeNo pfb_fused vs eager: max {mx} rms {rms}")
    out["raw_split"] = dict(launches=split["pfb_fused"][1]["pfb_channelize_fused"])
    return out, agc_path


def cw_taps(rate: float):
    """The DeCW filter's taps at a channel rate (cw_demodulator's design)."""
    import csdr_tpu_torch as ct

    return ct.cw_demodulator(CW_BW / rate, CW_PITCH / rate).blocks[0].taps


def usb_taps():
    """The -c 1 DeUSB 3000 band-pass at 2.56 MS/s: 1,826 complex taps."""
    import csdr_tpu_torch as ct

    return ct.ssb_demodulator("usb", 3000.0 / 2.56e6).blocks[0].taps


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |err| relative to the largest output, max |err|)."""
    g, w = (torch.view_as_real(v) if v.is_complex() else v for v in (got, want))
    d = (g.double() - w.double()).abs().max().item()
    return d / w.double().abs().max().item(), d


def fir_cases(torch, dev):
    """3c's shapes: (name, kernel, plain, taps, rows, n, complex input)."""
    from csdr_tpu_torch.ops.cuda import fft_fir as fx
    from csdr_tpu_torch.ops.cuda import fir_valid as fv

    cw64, cw1, usb = cw_taps(2.56e6 / 64), cw_taps(2.56e6), usb_taps()
    check((len(cw64), len(cw1), len(usb)) == (585, 3651, 1826),
          f"taps {len(cw64)}, {len(cw1)}, {len(usb)}")
    g, fms_block = fms_graph()
    rds_taps = g.blocks[-1].b2.blocks[0].h_data
    check((len(rds_taps), fms_block) == (333, 1046400),
          f"RDS data filter: {len(rds_taps)} taps, {fms_block} samples per block")
    rtty = rtty_taps()
    return [
        # 8's DeRTTY at 48 kHz: each of the two 1,056-tap bit filters on one
        # complex row per block of the CLI's default 2^20 samples
        ("fir_valid", "c1_complex_rtty_1056", fv.fir_valid, fv.fir_valid_ref, rtty, 1,
         RTTY_BLOCK, True),
        # 6b's RDS data filter: one real row per DeFMS --rds block
        ("fir_valid", "c1_real_rds_333", fv.fir_valid, fv.fir_valid_ref, rds_taps, 1, fms_block,
         False),
        ("fir_valid", "c64_complex_585", fv.fir_valid, fv.fir_valid_ref, cw64, 64, BLOCK // 64,
         True),
        ("fir_valid", "c64_real_585", fv.fir_valid, fv.fir_valid_ref, cw64, 64, BLOCK // 64,
         False),
        ("fir_valid", "c1_complex_3651", fv.fir_valid, fv.fir_valid_ref, cw1, 1, BLOCK, True),
        ("fft_fir", "c1_complex_usb_1826", fx.fft_fir_valid, fx.fft_fir_valid_ref, usb, 1,
         BLOCK, True),
        ("fft_fir", "c1_real_real_3651", fx.fft_fir_valid, fx.fft_fir_valid_ref, cw1, 1, BLOCK,
         False),
        # K6 at K5's two complex shapes
        ("fft_fir", "k6_c64_complex_585", fx.fft_fir_valid, fx.fft_fir_valid_ref, cw64, 64,
         BLOCK // 64, True),
        ("fft_fir", "k6_c1_complex_3651", fx.fft_fir_valid, fx.fft_fir_valid_ref, cw1, 1, BLOCK,
         True),
    ]


RTTY_BLOCK = 1 << 20     # the CLI's default block: DeRTTY's K5 rows


def rtty_taps() -> np.ndarray:
    """DeRTTY's bit filter at 48 kHz: the 1,056-tap moving average."""
    from csdr_tpu_torch.models import rtty

    taps = rtty.rtty_receiver(48000.0).blocks[0].parts[0][1].taps
    check(len(taps) == 1056, f"RTTY bit filter: {len(taps)} taps")
    return taps


def rand_rows(torch, dev, rows: int, n: int, cplx: bool, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, n, 2 if cplx else 1, device=dev, generator=g)
    return torch.view_as_complex(x) if cplx else x[..., 0].contiguous()


def phase_compare_fir(torch, dev, card):
    """3c. K5 and K6 vs their plain versions over 3 state-chained blocks of
    the streaming FIR (hist carried as fir_stream carries it)."""
    from csdr_tpu_torch.ops.fir import conv_valid

    result = {}
    for kname, case, kernel, plain, taps, rows, n, cplx in fir_cases(torch, dev):
        K = len(taps)
        x = rand_rows(torch, dev, rows, 3 * n, cplx, SEED + K + rows)
        dt = torch.complex64 if (cplx or np.iscomplexobj(taps)) else torch.float32
        hk = hp = torch.zeros(rows, K - 1, dtype=dt, device=dev)
        yk, yp, yf = [], [], []
        for b in range(3):
            xb = x[:, b * n:(b + 1) * n]
            xk, xp = torch.cat([hk, xb], dim=-1), torch.cat([hp, xb], dim=-1)
            yk.append(kernel(xk, taps))
            yp.append(plain(xp, taps))
            yf.append(conv_valid(xp, taps, "fft"))
            hk, hp = xk[:, -(K - 1):].contiguous(), xp[:, -(K - 1):].contiguous()
        yk, yp = torch.cat(yk, dim=-1), torch.cat(yp, dim=-1)
        torch.cuda.synchronize()
        check(yk.shape == (rows, 3 * n) and yk.dtype == yp.dtype, f"{case}: shape/dtype")
        check(bool(torch.isfinite(torch.view_as_real(yk) if yk.is_complex() else yk).all()),
              f"{case}: non-finite output")
        rel, mx = rel_err(torch, yk, yp)
        out = dict(phase="compare_fir", kernel=kname, case=case, rows=rows, n_per_block=n,
                   blocks=3, taps=K, complex_in=cplx, vs_plain_rel=rel, vs_plain_max=mx)
        # K5 against the fft strategy: the complex FIR bound (tests/test_fir.py:36)
        bound, fbound = ((K5_REL_ERR, K5_REL_ERR) if kname == "fir_valid"
                         else (K6_REL_ERR, K6_FFT_REL_ERR))
        frel, _ = rel_err(torch, yk, torch.cat(yf, dim=-1))
        out["vs_fft_strategy_rel"] = frel
        emit(dict(out, **card))
        check(rel < bound, f"{case}: kernel vs plain rel {rel} (bound {bound})")
        check(frel < fbound, f"{case}: kernel vs the fft strategy rel {frel} (bound {fbound})")
        result[case] = (mx, frel)
        del x, yk, yp, yf
    return result


def keyed_cw_capture(torch, dev, nch: int, n: int, seed: int, noise: float = 0.01):
    """cu8 (2n,) bytes: CW carriers keyed on and off at the centres of the
    even channels of an nch-way split (channel k at (k − (nch−1)/2)/nch
    cycles/sample), each with its own keying phase, plus noise; made on the
    device in float64 from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    x = torch.zeros(n, dtype=torch.complex128, device=dev)
    dit = 2.56e6 * CW_DIT_S
    for k in range(0, nch, 2):
        fc = (k - (nch - 1) / 2) / nch
        key = (torch.remainder(torch.floor(t / dit) + k, 3) != 2).to(torch.float64)
        ph = 2 * np.pi * torch.remainder(fc * t, 1.0) + float(rng.uniform(0, 2 * np.pi))
        x += 0.08 * key * torch.polar(torch.ones_like(ph), ph)
    g = torch.Generator(device=dev).manual_seed(seed)
    x += noise * torch.view_as_complex(torch.randn(n, 2, device=dev, generator=g,
                                                   dtype=torch.float64))
    return to_cu8(torch, x.to(torch.complex64))


def read_wavs(prefix: str, nch: int, frames: int) -> np.ndarray:
    names = [f"{prefix}.wav"] if nch == 1 else [f"{prefix}_ch{k + 1}.wav" for k in range(nch)]
    out = []
    for f in names:
        got = os.path.getsize(f)
        check(got == 44 + 4 * frames, f"{f} has {got} bytes, want {44 + 4 * frames}")
        out.append(np.fromfile(f, "<f4", offset=44))
        os.unlink(f)
    return np.stack(out)


def pitch_check(audio: np.ndarray, rate: float) -> tuple[np.ndarray, np.ndarray]:
    """(peak frequency in Hz per stream, audio power in dB per stream)."""
    a = audio.astype(np.float64)
    spec = np.abs(np.fft.rfft(a - a.mean(axis=1, keepdims=True), axis=1))
    peak = (spec[:, 1:].argmax(axis=1) + 1) * rate / a.shape[1]
    return peak, 10 * np.log10((a ** 2).mean(axis=1) + 1e-30)


@contextlib.contextmanager
def plain_k5():
    """Run the flows inside with K5's plain version in the kernel's place."""
    from csdr_tpu_torch.ops import fir as fir_ops
    from csdr_tpu_torch.ops.cuda import fir_valid as fv

    fir_ops.fir_valid = fv.fir_valid_ref
    try:
        yield
    finally:
        fir_ops.fir_valid = fv.fir_valid


def phase_main_path_fir(torch, dev, card, tmp):
    """4c. The DeCW, DeAM and library K6 paths on a 2^25-sample capture."""
    import csdr_tpu_torch as ct
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main

    nch = 64
    frames = CAPTURE // nch
    chan_rate = 2.56e6 / nch
    u8 = keyed_cw_capture(torch, dev, nch, CAPTURE, SEED + 400)
    path = os.path.join(tmp, "keyed_cw.cu8")
    u8.cpu().numpy().tofile(path)
    common = ["-n", str(CAPTURE), "--device", "cuda", "--blocksize", str(BLOCK)]
    out = {}

    # -c 64 DeCW: eager (K5), pfb_fused (K4 + K5), and eager with K5's plain
    # version in its place
    cw = {}
    for label, backend, want in (("eager", "eager", "fir_valid"),
                                 ("pfb_fused", "pfb_fused", ("pfb_channelize_fused",
                                                             "fir_valid")),
                                 ("plain_k5", "eager", None)):
        prefix = os.path.join(tmp, f"cw_{label}")
        with plain_k5() if label == "plain_k5" else contextlib.nullcontext():
            counts = cli_run(torch, cli_main, [
                "--filename", path, "-c", str(nch), "-o", prefix, "--demod",
                f"DeCW {CW_BW:g} {CW_PITCH:g} WAV", "--backend", backend, *common])
        check_counts(counts, want, f"CLI -c 64 DeCW {label}")
        cw[label] = (read_wavs(prefix, nch, frames), counts)
    plain = cw["plain_k5"][0]
    peaks, power = pitch_check(cw["eager"][0], chan_rate)
    on_pitch = np.abs(peaks[0::2] - CW_PITCH) <= 2 * chan_rate / frames
    margin = float(power[0::2].min() - power[1::2].max())
    for label in ("eager", "pfb_fused"):
        audio, counts = cw[label]
        check(bool(np.isfinite(audio).all()), f"CLI DeCW {label}: non-finite audio")
        rel = float(np.abs(audio.astype(np.float64) - plain).max() / np.abs(plain).max())
        emit(dict(phase="main_path_fir", flow="-c 64 DeCW", backend=label, wire="cu8",
                  samples=CAPTURE, channels=nch, launches=counts, vs_plain_k5_rel=rel,
                  occupied_on_pitch=int(on_pitch.sum()), empty_margin_db=margin,
                  taps=585, **card))
        check(rel < K5_REL_ERR, f"CLI DeCW {label} vs plain K5: rel {rel}")
    check(bool(on_pitch.all()), f"DeCW channels off their pitch: {peaks[0::2].round(1)}")
    check(margin >= CW_EMPTY_DB, f"DeCW empty channels only {margin:.1f} dB below")
    out["fir_valid"] = dict(launches=cw["eager"][1]["fir_valid"],
                            launches_pfb_fused=cw["pfb_fused"][1])
    del cw, plain

    # -c 1 --offset -b 48000 DeCW: front end + K5.  Tuned CW_TUNE Hz below
    # channel 10's carrier: tuned exactly to DC, the flow's DC blocker would
    # notch the carrier and leave only its keying sidebands
    offset = (10 - (nch - 1) / 2) / nch * 2.56e6 - CW_TUNE
    n48 = CAPTURE * 3 // 160
    prefix = os.path.join(tmp, "cw1")
    single = {}
    for label in ("kernel", "plain_k5"):
        with plain_k5() if label == "plain_k5" else contextlib.nullcontext():
            counts = cli_run(torch, cli_main, [
                "--filename", path, "-c", "1", "--offset", repr(offset), "-b", "48000",
                "-o", prefix, "--demod", f"DeCW {CW_BW:g} {CW_PITCH:g} WAV", "--device",
                "cuda", "--blocksize", str(BLOCK), "-n", str(n48)])
        check_counts(counts, "fir_valid" if label == "kernel" else None, f"CLI -c 1 DeCW {label}")
        single[label] = (read_wavs(prefix, 1, n48), counts)
    audio = single["kernel"][0]
    rel = float(np.abs(audio.astype(np.float64) - single["plain_k5"][0]).max()
                / np.abs(single["plain_k5"][0]).max())
    peak, _ = pitch_check(audio, 48000.0)
    emit(dict(phase="main_path_fir", flow="-c 1 --offset -b 48000 DeCW", offset_hz=offset,
              samples_in=CAPTURE, samples_out=n48, launches=single["kernel"][1],
              vs_plain_k5_rel=rel, peak_hz=float(peak[0]), taps=701, **card))
    check(bool(np.isfinite(audio).all()), "CLI -c 1 DeCW: non-finite audio")
    check(rel < K5_REL_ERR, f"CLI -c 1 DeCW vs plain K5: rel {rel}")
    check(abs(peak[0] - CW_PITCH - CW_TUNE) <= 2 * 48000.0 / n48,
          f"CLI -c 1 DeCW peak {peak[0]} Hz, want {CW_PITCH + CW_TUNE}")
    out["fir_valid_single"] = single["kernel"][1]["fir_valid"]

    # -c 1 DeAM -a: no kernel; the CPU runs the same flow on the first 2^22
    n_cpu = min(1 << 22, CAPTURE)
    am = {}
    for device, n, block in (("cuda", CAPTURE, BLOCK), ("cpu", n_cpu, n_cpu)):
        prefix = os.path.join(tmp, f"am_{device}")
        counts = cli_run(torch, cli_main, [
            "--filename", path, "-c", "1", "-o", prefix, "--demod", "DeAM WAV",
            "-a", str(AM_T), "--device", device, "--blocksize", str(block), "-n", str(n)])
        check_counts(counts, None, f"CLI -c 1 DeAM -a {device}")
        am[device] = read_wavs(prefix, 1, n)
    got, want = am["cuda"][:, :n_cpu], am["cpu"]
    rel = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
    emit(dict(phase="main_path_fir", flow="-c 1 DeAM -a", threshold_db=AM_T, samples=CAPTURE,
              launches={}, vs_cpu_rel=rel, cpu_samples=n_cpu, **card))
    check(bool(np.isfinite(am["cuda"]).all()), "CLI DeAM: non-finite audio")
    check(rel < AGC_REL_ERR, f"CLI DeAM card vs CPU: rel {rel}")
    del am, got, want

    # K6 through the library: u8 → IQ → FIRFilter(USB band-pass) → real
    taps = usb_taps()
    lib = {}
    for strategy, want in (("pallas_fft", "fft_fir"), ("fft", None)):
        g = ct.chain(ct.u8_to_iq(), ct.fir_filter(taps, True, strategy=strategy),
                     ct.Lambda(lambda x: x.real.contiguous(), name="re"))
        pipe = ct.Pipeline(g, block_size=BLOCK, device=dev)
        sink = ct.CollectSink()
        torch.cuda.synchronize()
        reset_counts()
        total = pipe.run(ct.cu8_file_source(path, BLOCK), sink)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, want, f"library FIRFilter {strategy}")
        check(total == CAPTURE, f"library FIRFilter {strategy}: {total} samples")
        lib[strategy] = (sink.concat(), counts)
    got, want = lib["pallas_fft"][0], lib["fft"][0]
    rel = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
    emit(dict(phase="main_path_fir", flow="library FIRFilter pallas_fft", samples=CAPTURE,
              taps=len(taps), launches=lib["pallas_fft"][1], vs_fft_strategy_rel=rel, **card))
    check(got.shape == (CAPTURE,) and bool(np.isfinite(got).all()), "library K6: output")
    check(rel < K6_FFT_REL_ERR, f"library K6 vs fft strategy: rel {rel}")
    out["fft_fir"] = dict(launches=lib["pallas_fft"][1]["fft_fir"])
    os.unlink(path)
    return out


def cli_flow(torch, cli_main, argv: list[str], want, what: str) -> dict:
    """One CLI flow with every kernel count set to 0 just before it and read
    just after: its kernels in ``want`` launched, no other."""
    counts = cli_run(torch, cli_main, argv)
    check_counts(counts, want, what)
    return dict(launches=counts)


def read_wav(path: str, channels: int, frames: int, rate: int) -> np.ndarray:
    """A float32 WAV of the port's writer as (channels, frames); checks its
    size and sample rate, and deletes it."""
    got = os.path.getsize(path)
    check(got == 44 + 4 * channels * frames,
          f"{path} has {got} bytes, want {44 + 4 * channels * frames}")
    with open(path, "rb") as f:
        head = f.read(44)
    sr = int(np.frombuffer(head[24:28], "<u4")[0])
    check(sr == rate, f"{path}: sample rate {sr}, want {rate}")
    a = np.fromfile(path, "<f4", offset=44).reshape(frames, channels).T
    os.unlink(path)
    return a


def tone_fit(a: np.ndarray, f: float, rate: float) -> tuple[float, float]:
    """(amplitude, SNR in dB) of the tone f in a: the least-squares fit of
    a sine, a cosine and a constant, the rest counted as error."""
    k = np.arange(len(a), dtype=np.float64)
    M = np.stack([np.sin(2 * np.pi * f / rate * k), np.cos(2 * np.pi * f / rate * k),
                  np.ones_like(k)], 1)
    coef, *_ = np.linalg.lstsq(M, a.astype(np.float64), rcond=None)
    amp = float(np.hypot(coef[0], coef[1]))
    err = a - M @ coef
    return amp, float(10 * np.log10(amp ** 2 / 2 / np.mean(err ** 2)))


def phase_wbfm(torch, dev, card, tmp) -> dict:
    """6a. BASELINE config 1 through the CLI: a 1 kHz FM tone at DC of a
    2.56 MS/s cu8 capture, resampled to 200 kHz, WBFM-demodulated,
    de-emphasised and decimated by 8 into a mono WAV."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu_torch.utils import iirdes
    import scipy.signal as sig

    fs, decim = 2.56e6, 8
    A = WBFM_BETA * WBFM_TONE / (0.6 * FM_BW)  # message amplitude: the demod's kf is 0.6
    w = 2 * np.pi * WBFM_TONE / fs
    t = torch.arange(CAPTURE, dtype=torch.float64, device=dev)
    # phase = 2π·0.6·(FM_BW/fs)·Σ A·sin(w·k), integrated in closed form
    ph = 2 * np.pi * 0.6 * (FM_BW / fs) * A * (1 - torch.cos(w * t)) / w + 0.3
    path = os.path.join(tmp, "wbfm.cu8")
    to_cu8(torch, torch.polar(torch.ones_like(ph), ph).to(torch.complex64)).cpu().numpy().tofile(
        path)
    del t, ph
    n = CAPTURE * 5 // 64  # 200 kHz samples after the front end
    rate = int(FM_BW) // decim
    prefix = os.path.join(tmp, "wbfm")
    argv = lambda n, device: ["--filename", path, "-s", "2560000", "-b", str(int(FM_BW)),  # noqa: E731
                              "-n", str(n), "--demod", f"DeWBFM {decim} WAV", "-o", prefix,
                              "--device", device]
    flow = cli_flow(torch, cli_main, argv(n, "cuda"), None, "CLI DeWBFM")
    audio = read_wav(prefix + ".wav", 1, n // decim, rate)[0]
    check(bool(np.isfinite(audio).all()), "CLI DeWBFM: non-finite audio")
    # the de-emphasised message is the tone scaled by the de-emphasis gain
    _, h = sig.sosfreqz(iirdes.butter_sos(2, 5000.0 / FM_BW), [WBFM_TONE], fs=FM_BW)
    want_amp = A * abs(h[0])
    amp, snr = tone_fit(audio[rate // 10:], WBFM_TONE, rate)
    # the same flow on the CPU over the first 2^22 capture samples
    n_cpu = min(1 << 22, CAPTURE) * 5 // 64
    cli_run(torch, cli_main, argv(n_cpu, "cpu"))
    cpu = read_wav(prefix + ".wav", 1, n_cpu // decim, rate)[0]
    rel = float(np.abs(audio[:len(cpu)].astype(np.float64) - cpu).max() / np.abs(cpu).max())
    emit(dict(phase="wbfm", flow="-s 2560000 -b 200000 DeWBFM 8 WAV", wire="cu8",
              samples=CAPTURE, frames=len(audio), rate=rate, tone_hz=WBFM_TONE,
              snr_db=snr, amplitude=amp, deemph_amplitude=want_amp, vs_cpu_rel=rel,
              cpu_samples=n_cpu * 64 // 5, **flow, **card))
    check(snr >= SNR_DB, f"CLI DeWBFM: tone SNR {snr:.1f} dB")
    check(abs(amp / want_amp - 1) < 0.01, f"CLI DeWBFM: tone amplitude {amp}, want {want_amp}")
    check(rel < CPU_REL_ERR, f"CLI DeWBFM card vs CPU: rel {rel}")
    os.unlink(path)
    return flow


def stereo_capture(torch, dev, n: int, seed: int):
    """cu8 (2n,) at 2.56 MS/s: an FM broadcast (60 kHz per unit of MPX) of
    L = FMS_L and R = FMS_R tones, the 19 kHz pilot, and RDS groups 0A
    carrying RDS_PS and RDS_PI on the pilot's third harmonic."""
    from csdr_tpu_torch.models import rds

    fs = 2.56e6
    rng = np.random.default_rng(seed)
    groups = [rds.make_group_0a(RDS_PI, s, RDS_PS[2 * s:2 * s + 2]) for s in range(4)]
    tx = torch.from_numpy(rds.bits_from_groups(groups).astype(np.float64)).to(dev)
    t = torch.arange(n, dtype=torch.float64, device=dev) / fs
    pil = 2 * np.pi * torch.remainder(19000.0 * t, 1.0) + float(rng.uniform(0, 2 * np.pi))
    left = 0.6 * torch.sin(2 * np.pi * torch.remainder(FMS_L * t, 1.0))
    right = 0.6 * torch.sin(2 * np.pi * torch.remainder(FMS_R * t, 1.0))
    bit = tx[torch.remainder(torch.floor(t * rds.RDS_BAUD).long(), len(tx))]
    half = torch.remainder(torch.floor(t * 2 * rds.RDS_BAUD), 2)
    level = (2 * bit - 1) * (1 - 2 * half)  # biphase
    mpx = (0.45 * (left + right) + 0.1 * torch.cos(pil)
           + 0.45 * (left - right) * torch.cos(2 * pil) + 0.05 * level * torch.cos(3 * pil))
    del t, pil, left, right, bit, half, level
    ph = torch.cumsum(mpx * (2 * np.pi * 60000.0 / fs), 0)
    return to_cu8(torch, torch.polar(torch.ones_like(ph), ph).to(torch.complex64))


def fms_graph(decim: int = 8, pll_mode: str = "closed_form"):
    """The graph of the CLI's DeFMS --rds behind its front end (its stereo
    decoder's subcarrier from ``pll_mode``), and the samples per block its
    Pipeline runs at the CLI's default block size."""
    import csdr_tpu_torch as ct
    from csdr_tpu_torch.apps.soapy_sdr_cli import build_parser
    from csdr_tpu_torch.models.rds import rds_receiver
    from csdr_tpu_torch.models.stereo import stereo_fm_decoder

    g = ct.chain(ct.dc_blocker(), ct.fm_demodulator(0.8),
                 ct.Tee(stereo_fm_decoder(FM_BW, decim, pll_mode=pll_mode), rds_receiver(FM_BW)))
    return g, (build_parser().get_default("blocksize") // g.granule) * g.granule


def phase_stereo_rds(torch, dev, card, tmp) -> dict:
    """6b. DeFMS 8 --rds: one Pipeline, the composite into a Tee of the
    stereo decoder and the RDS receiver, whose data filter runs on K5 (held
    against its plain version at this shape in 3c)."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main

    decim = 8
    path = os.path.join(tmp, "stereo.cu8")
    stereo_capture(torch, dev, CAPTURE, SEED + 500).cpu().numpy().tofile(path)
    n = CAPTURE * 5 // 64
    rate = int(FM_BW) // decim
    prefix = os.path.join(tmp, "stereo")
    argv = ["--filename", path, "-b", str(int(FM_BW)), "-n", str(n), "--demod",
            f"DeFMS {decim} WAV", "--rds", "-o", prefix, "--device", "cuda"]
    flow = cli_flow(torch, cli_main, argv, "fir_valid", "CLI DeFMS --rds")
    # the CLI's graph behind the front end, for its block count and flush
    g, block = fms_graph(decim)
    total = n + g.flush_len()
    blocks = -(-total // block)
    frames = total // decim
    audio = read_wav(prefix + ".wav", 2, frames, rate)
    with open(prefix + ".rds.txt") as f:
        report = dict(ln.split(": ", 1) for ln in f.read().splitlines() if ": " in ln)
    check(bool(np.isfinite(audio).all()), "CLI DeFMS: non-finite audio")
    sep = []
    for ch, (fw, fo) in enumerate(((FMS_L, FMS_R), (FMS_R, FMS_L))):
        y = audio[ch, rate // 10:].astype(np.float64)
        spec = np.abs(np.fft.rfft(y * np.hanning(len(y)))) ** 2
        f = np.fft.rfftfreq(len(y), 1.0 / rate)
        band = lambda f0: spec[(f > f0 - 100) & (f < f0 + 100)].max()  # noqa: E731
        sep.append(float(10 * np.log10(band(fw) / band(fo))))
    emit(dict(phase="stereo_rds", flow="-b 200000 DeFMS 8 WAV --rds", wire="cu8",
              samples=CAPTURE, frames=frames, rate=rate, separation_db=sep, rds=report,
              blocks=blocks, fir_valid_per_block=flow["launches"]["fir_valid"] / blocks,
              **flow, **card))
    check(min(sep) > SEP_DB, f"CLI DeFMS: L/R separation {sep} dB")
    check(report.get("PI") == f"{RDS_PI:04X}" and report.get("PS") == RDS_PS,
          f"CLI DeFMS --rds: decoded {report}")
    check(flow["launches"]["fir_valid"] >= blocks,
          f"CLI DeFMS --rds: K5 launched {flow['launches']['fir_valid']} times in {blocks} blocks")
    os.unlink(path)
    return flow


def phase_mix(torch, dev, card, tmp) -> dict:
    """6c. BASELINE config 4: -c 16 -m DeNBFM 0.3 on every backend, and with
    -a (K4); each mixed WAV against the sum of the same flow's per-channel
    files, the per-channel runs against eager."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main

    nch = MIX_NCH
    frames, rate = CAPTURE // nch, 2560000 // nch
    j = 5 + 3 * (np.arange(nch) % 7)
    path = os.path.join(tmp, "mix.cu8")
    to_cu8(torch, occupied_band(torch, dev, nch, CAPTURE, SEED + 600,
                                tones=j / 1024.0 / nch)).cpu().numpy().tofile(path)
    runs = {
        "eager": ([], None),
        "pfb_fused": ([], "pfb_fm_fused"),
        "fused": ([], "flagship_fused"),
        "pfb_fused -a": (["-a", str(AGC_T)], "pfb_channelize_fused"),
        "eager -a": (["-a", str(AGC_T)], None),
    }
    out, split = {}, {}
    for label, (extra, want) in runs.items():
        backend = label.split()[0]
        common = ["--filename", path, "-n", str(CAPTURE), "-c", str(nch), "--demod",
                  "DeNBFM 0.3 WAV", "--backend", backend, "--device", "cuda", "--blocksize",
                  str(BLOCK), *extra]
        prefix = os.path.join(tmp, "mix")
        counts = cli_run(torch, cli_main, common + ["-o", prefix])
        check_counts(counts, want, f"CLI -c {nch} {label}")
        per = read_wavs(prefix, nch, frames).astype(np.float64)
        flow = cli_flow(torch, cli_main, common + ["-m", "-o", prefix], want,
                        f"CLI -c {nch} -m {label}")
        mixed = read_wav(prefix + ".wav", 1, frames, rate)[0].astype(np.float64)
        check(bool(np.isfinite(mixed).all()), f"CLI -m {label}: non-finite audio")
        if label == "eager -a":
            out[label] = dict(flow, mixed=mixed)
            continue
        total = per.sum(axis=0)
        rel = float(np.abs(mixed - total).max() / np.abs(total).max())
        check(rel < MIX_REL_ERR, f"CLI -m {label}: mixed vs the per-channel sum, rel {rel}")
        split[label] = per
        out[label] = dict(flow, mixed=mixed, vs_channel_sum_rel=rel)
    for label, bound in (("pfb_fused", PFB_MAX_ERR), ("fused", MAX_ERR)):
        mx, rms = errors_np(split[label][:, 1:], split["eager"][:, 1:])
        out[label].update(per_channel_vs_eager_max=mx, per_channel_vs_eager_rms=rms)
        check(mx < bound and rms < RMS_ERR, f"CLI -c {nch} {label} vs eager: max {mx} rms {rms}")
    agc_rel = float(np.abs(out["pfb_fused -a"]["mixed"] - out["eager -a"]["mixed"]).max()
                    / np.abs(out["eager -a"]["mixed"]).max())
    out["pfb_fused -a"]["mixed_vs_eager_rel"] = agc_rel
    check(agc_rel < AGC_REL_ERR, f"CLI -m -a pfb_fused vs eager: rel {agc_rel}")
    for label, r in out.items():
        r.pop("mixed")
        emit(dict(phase="mix", flow=f"-c {nch} -m DeNBFM 0.3 WAV", backend=label, wire="cu8",
                  samples=CAPTURE, frames=frames, rate=rate, **r, **card))
    os.unlink(path)
    return out


def checkpoint_pipeline(ct, backend: str, dev):
    """6d's library path: -c 64 DeNBFM on cu8 blocks of BLOCK samples."""
    g = ct.channelized_fm_receiver(64, kf=KF, backend=backend)
    return ct.Pipeline(g if backend == "fused" else ct.chain(ct.u8_to_iq(), g),
                       block_size=BLOCK, device=dev)


def phase_checkpoint(torch, ct, dev, card, capture) -> dict:
    """6d. Checkpoint and resume through the library, -c 64 DeNBFM, fused
    (K1) and eager, on phase 4's capture: the whole run, then the first
    half, save_pipeline, a new Pipeline, resume_pipeline and skip_n.  The
    resumed output must equal the whole run's second half bit for bit."""

    nch, half = 64, CAPTURE // 2
    out = {}
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "resume.npz")
        for backend, want in (("fused", "flagship_fused"), ("eager", None)):
            make = lambda: checkpoint_pipeline(ct, backend, dev)  # noqa: E731
            src = lambda: ct.cu8_file_source(capture, BLOCK)  # noqa: E731
            whole = ct.CollectSink()
            torch.cuda.synchronize()
            reset_counts()
            total = make().run(src(), whole)
            torch.cuda.synchronize()
            counts = read_counts()
            check_counts(counts, want, f"library -c 64 {backend}")
            first = ct.CollectSink()
            p1 = make()
            p1.run(ct.take_n(src(), half), first)
            ct.save_pipeline(ck, p1, position=half)
            p2 = make()
            pos = ct.resume_pipeline(ck, p2)
            rest = ct.CollectSink()
            p2.run(ct.skip_n(src(), pos), rest)
            want_all = whole.concat()
            got = np.concatenate([first.concat(), rest.concat()], axis=-1)
            check(total == CAPTURE // nch and got.shape == want_all.shape == (nch, total),
                  f"checkpoint {backend}: shapes {got.shape} {want_all.shape}")
            same = bool(np.array_equal(rest.concat(), want_all[:, pos // nch:]))
            mx = float(np.abs(got.astype(np.float64) - want_all).max())
            out[backend] = dict(launches=counts, position=pos, bit_identical=same,
                                resumed_vs_whole_max=mx)
            emit(dict(phase="checkpoint", path=f"-c 64 DeNBFM {backend}", wire="cu8",
                      samples=CAPTURE, **out[backend], **card))
            check(same, f"checkpoint {backend}: resumed run differs by {mx}")
    return out


# ---- 8. packet receivers -----------------------------------------------------

PKT_FS = 1920000             # -s of the AIS, APRS, POCSAG and RTTY captures
ADSB_FS = 2000000            # -s of the ADS-B capture: 2 samples per µs
AIS_OFFSET = 25000.0         # AIS 2 at 162.025 MHz, tuned to 162.000
APRS_OFFSET = -60000.0       # the APRS carrier 60 kHz below the tuning
POCSAG_OFFSET = 150000.0
RTTY_OFFSET = 300000.0       # the RTTY signal's suppressed carrier (USB)
BAND_NCH, BAND_RATE = 64, 38400.0   # the band monitor: 64 × 38.4 kHz = 2.4576 MS/s
BAND_PAGES = {5: 3, 17: 3, 40: 2, 58: 3}    # channel → pages sent on it
RTTY_TEXT = ("CQ CQ CQ DE N0CALL N0CALL K RYRYRYRYRY THE QUICK BROWN FOX JUMPS OVER "
             "THE LAZY DOG 0123456789 73")


def write_cu8(path: str, x: np.ndarray, scale: float = 60.0):
    """complex → interleaved rtl_sdr uint8 on disk, in pieces of 2^22."""
    with open(path, "wb") as f:
        for i in range(0, len(x), 1 << 22):
            p = x[i:i + (1 << 22)]
            ri = np.stack([p.real, p.imag], 1) * scale + 127.5
            np.clip(np.round(ri), 0, 255).astype(np.uint8).tofile(f)


def host_noise(n: int, seed: int, sigma: float) -> np.ndarray:
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 2), dtype=np.float32) * np.float32(sigma)).view(
        np.complex64)[:, 0]


def carrier(start: int, n: int, f: float, fs: float) -> np.ndarray:
    """e^{j2π·f·t/fs} at the absolute sample indices start .. start + n."""
    t = np.arange(start, start + n, dtype=np.float64)
    return np.exp(2j * np.pi * np.mod(f / fs * t, 1.0))


def front_end_delay(ct, fs: float, bw: float) -> float:
    """The front end's group delay in output samples (the centroid of its
    impulse response, on the CPU): the AIS bursts are placed so that it
    lands their symbols on the GMSK slicer's grid."""
    g = ct.chain(*ct.front_end(fs, 0.0, bw))
    n = 1 << 16
    x = np.zeros(n, np.complex64)
    x[n // 4] = 1.0
    sink = ct.CollectSink()
    ct.Pipeline(g, block_size=g.granule * 64, device="cpu").run(iter([x]), sink, num_samples=n)
    y = sink.concat().real.astype(np.float64)
    return float((np.arange(len(y)) * y).sum() / y.sum() - n // 4 * float(g.rate))


ADSB_FRAMES = 4000           # the JAX decoder stops at 4,096 messages per call
                             # (detect_frames' max_candidates, ROADMAP Queue C)


def adsb_capture(n: int, seed: int):
    """ADSB_FRAMES DF17 ident, even and odd position and velocity frames of
    250 aircraft, evenly spread (±100 µs) over the capture at 2 MS/s (~240
    frames per second over 2^25 samples); returns (IQ, the messages the
    protocol layer gives the clean frames)."""
    from csdr_tpu_torch.models import adsb

    rng = np.random.default_rng(seed)
    icaos = rng.choice(np.arange(0x400000, 0xC00000), 250, replace=False)
    lat = rng.uniform(40.0, 55.0, 250)
    lon = rng.uniform(-5.0, 15.0, 250)
    mag = np.zeros(n, np.float32)
    step = (n - 4000) // ADSB_FRAMES
    want, pos, i = [], 2000, 0
    while i < ADSB_FRAMES:
        a, kind = i % 250, (i // 250) % 4
        icao = int(icaos[a])
        if kind == 0:
            bits = adsb.make_es_ident(icao, f"TPU{a:04d}")
        elif kind in (1, 2):
            bits = adsb.make_es_position(icao, lat[a], lon[a], 1000 + 25 * (a * 37 % 1500),
                                         odd=kind == 2)
        else:
            bits = adsb.make_es_velocity(icao, float(a % 300) - 150.0, 200.0, 64 * (a % 20))
        mag[pos:pos + 240] = adsb.adsb_modulate(bits, ADSB_FS)
        msg = adsb.decode_frame(bits)
        msg["sample"] = pos + 16
        want.append(msg)
        pos = 2000 + (i + 1) * step + int(rng.integers(-200, 200))
        i += 1
    iq = adsb.to_iq(mag).astype(np.complex64) + host_noise(n, seed + 1, 0.02)
    return iq, adsb.pair_positions(want)


def ais_capture(ct, n: int, seed: int):
    """GMSK bursts of class-A position reports on one AIS channel, 0.2 s
    apart, at PKT_FS with the channel AIS_OFFSET above the tuning; each
    burst placed so that the front end's delay puts its symbols on the
    slicer's grid (k = 5 at 48 kHz)."""
    from csdr_tpu_torch.models import ais

    rng = np.random.default_rng(seed)
    k_in = PKT_FS // 9600                    # 200 samples per bit
    dec = PKT_FS // 48000                    # 40 input samples per output sample
    shift = int(round(-front_end_delay(ct, PKT_FS, 48000.0) * dec)) % (5 * dec)
    x = np.zeros(n, np.complex64)
    want, start = [], 20000
    while True:
        mmsi = int(rng.integers(200000000, 780000000))
        pb = ais.make_position_report(mmsi, float(rng.uniform(-80, 80)),
                                      float(rng.uniform(-179, 179)),
                                      round(float(rng.uniform(0, 30)), 1),
                                      round(float(rng.uniform(0, 359)), 1), int(rng.integers(1, 4)))
        lv = np.concatenate([np.array([0, 1] * 4, np.uint8), ais.ais_burst_bits(pb),
                             np.array([0, 1] * 4, np.uint8)])
        s = start - start % (5 * dec) + shift
        if s + len(lv) * k_in + 20000 > n:
            break
        x[s:s + len(lv) * k_in] = 0.5 * ais.ais_modulate(lv, k_in) * carrier(
            s, len(lv) * k_in, AIS_OFFSET, PKT_FS)
        want.append(ais.parse_payload(pb))
        start = s + int(0.2 * PKT_FS)
    return x + host_noise(n, seed + 1, 0.02), want


def aprs_capture(n: int, seed: int):
    """Keyed NBFM carriers (3 kHz deviation) with AX.25 UI frames, one per
    0.4 s, APRS_OFFSET from the tuning at PKT_FS; every frame starts on the
    same bit phase (the decoder's open-loop bit clock is one per stream)."""
    from csdr_tpu_torch.models import aprs

    rng = np.random.default_rng(seed)
    bit = PKT_FS // 1200                     # 1,600 samples per bit
    x = np.zeros(n, np.complex64)
    want, start, i = [], 16000, 0
    while True:
        frame = aprs.make_ax25_ui(f"N{i % 10}CALL-{i % 16}", "APRS",
                                  f"!{4000 + i:04d}.50N/0{7000 + i:04d}.75W-seq {i}",
                                  via=("WIDE1-1",) if i % 3 == 0 else ())
        audio = aprs.afsk_modulate(aprs.aprs_burst_bits(frame), PKT_FS).astype(np.float64)
        if start + len(audio) + 16000 > n:
            break
        ph = 2 * np.pi * 3000.0 / PKT_FS * np.cumsum(audio) + rng.uniform(0, 2 * np.pi)
        x[start:start + len(audio)] = 0.5 * np.exp(1j * ph) * carrier(
            start, len(audio), APRS_OFFSET, PKT_FS)
        want.append(aprs.parse_ax25(frame))
        start += int(0.4 * PKT_FS) // bit * bit
        i += 1
    return x + host_noise(n, seed + 1, 0.02), want


POCSAG_PAGES = ["FIRE ALARM ZONE 3", "0123456789", "CALL OPS 2200", "55 12 -(0)",
                "PAGER TEST OK", "1234 5678", "NEED ASSIST BAY 7", "911"]


def pocsag_capture(n: int, seed: int):
    """Alpha and numeric pages (1200 baud, ±4.5 kHz, inverted polarity)
    back to back POCSAG_OFFSET from the tuning at PKT_FS, on the bit grid."""
    from csdr_tpu_torch.models import pocsag

    rng = np.random.default_rng(seed)
    bit = PKT_FS // 1200
    x = np.zeros(n, np.complex64)
    want, start, i = [], 16000, 0
    while True:
        ric = int(rng.integers(8, 1 << 21))
        lv = pocsag.make_transmission(ric, POCSAG_PAGES[i % len(POCSAG_PAGES)])
        m = len(lv) * bit
        if start + m + 16000 > n:
            break
        x[start:start + m] = 0.5 * pocsag.pocsag_modulate(lv, PKT_FS) * carrier(
            start, m, POCSAG_OFFSET, PKT_FS)
        want += pocsag.decode_bits(lv)
        start += m + int(0.1 * PKT_FS) // bit * bit
        i += 1
    return x + host_noise(n, seed + 1, 0.02), want


def rtty_capture(n: int, seed: int, text: str = RTTY_TEXT):
    """``text`` at 45.45 Bd, 170 Hz shift, between idle marks that fill the
    capture, as USB audio on a carrier RTTY_OFFSET above the tuning at
    PKT_FS (the real audio's image sideband is what the USB filter
    rejects)."""
    from csdr_tpu_torch.models import rtty

    # idle mark fills the capture on both sides of the text: noise alone
    # would frame random characters
    k = PKT_FS / rtty.RTTY_BAUD
    idle = (n / k - 7.5 * len(rtty.ita2_encode(text))) / 2 - 1
    check(idle >= 2, f"RTTY text needs more than the capture's {n} samples")
    audio = rtty.rtty_modulate(text, PKT_FS, idle_bits=idle)
    x = np.zeros(n, np.complex64)
    x[:len(audio)] = 0.5 * audio * carrier(0, len(audio), RTTY_OFFSET, PKT_FS)
    return x + host_noise(n, seed + 1, 0.02), [rtty.ita2_decode(rtty.ita2_encode(text))]


def band_capture(n: int, seed: int):
    """A paging band: 64 channels of 38.4 kHz, pages (FSK synthesized at
    the band's rate on the channel centre) on the channels of BAND_PAGES,
    staggered in time; returns (IQ, [(channel, ric, text)] in the order
    decode_channels gives them)."""
    from csdr_tpu_torch.models import pocsag

    fs = BAND_NCH * BAND_RATE
    rng = np.random.default_rng(seed)
    x = host_noise(n, seed + 1, 0.01)
    want = []
    for ch, count in BAND_PAGES.items():
        fc = (ch - (BAND_NCH - 1) / 2) / BAND_NCH * fs
        start = int(rng.integers(20000, 400000))
        for j in range(count):
            ric = int(rng.integers(8, 1 << 21))
            text = POCSAG_PAGES[(ch + j) % len(POCSAG_PAGES)]
            lv = pocsag.make_transmission(ric, text)
            bb = pocsag.pocsag_modulate(lv, fs)
            check(start + len(bb) < n, f"band page on channel {ch} runs past the capture")
            x[start:start + len(bb)] += 0.5 * bb * carrier(start, len(bb), fc, fs)
            want += [dict(m, channel=ch) for m in pocsag.decode_bits(lv)]
            start += len(bb) + int(rng.integers(10000, 200000))
    return x, want


def on_air_mask(env: np.ndarray, k: float, level: float = 0.1) -> np.ndarray:
    """Samples whose envelope, and that of the k samples before (the bit
    filter's window and the discriminator's previous sample), is above
    ``level``: where a page is on the air."""
    k = int(round(k))
    on = (env > level).astype(np.float64)
    run = np.apply_along_axis(lambda r: np.convolve(r, np.ones(k + 1))[:len(r)], -1, on)
    return run > k + 0.5


def band_pipeline(ct, backend: str, dev):
    """8's library path: u8 → IQ → pocsag_band_monitor(64, 38.4 kHz)."""
    from csdr_tpu_torch.models import pocsag

    g = pocsag.pocsag_band_monitor(BAND_NCH, BAND_RATE, backend=backend)
    return ct.Pipeline(ct.chain(ct.u8_to_iq(), g), block_size=BLOCK, device=dev)


def packet_flows(ct) -> dict:
    """The five CLI flows of 8: kind → (capture writer, -s, extra argv,
    output rate, expected messages)."""
    return {
        "DeADSB": (lambda n, s: adsb_capture(n, s), ADSB_FS, [], ADSB_FS),
        "DeAIS": (lambda n, s: ais_capture(ct, n, s), PKT_FS,
                  ["--offset", f"{AIS_OFFSET:g}", "-b", "48000"], 48000),
        "DeAPRS": (lambda n, s: aprs_capture(n, s), PKT_FS,
                   ["--offset", f"{APRS_OFFSET:g}", "-b", "48000"], 48000),
        "DePOCSAG": (lambda n, s: pocsag_capture(n, s), PKT_FS,
                     ["--offset", f"{POCSAG_OFFSET:g}", "-b", "38400"], 38400),
        "DeRTTY": (lambda n, s: rtty_capture(n, s), PKT_FS,
                   ["--offset", f"{RTTY_OFFSET:g}", "-b", "48000"], 48000),
    }


PACKET_DEMOD = {"DeADSB": "DeADSB", "DeAIS": "DeAIS", "DeAPRS": "DeAPRS 0.5",
                "DePOCSAG": "DePOCSAG 1200", "DeRTTY": "DeRTTY"}
PACKET_KERNELS = {"DeRTTY": "fir_valid"}     # the kernels each flow must launch


def phase_packet(torch, ct, dev, card, tmp, samples: int = CAPTURE) -> dict:
    """8. The packet receivers: each CLI flow on a seeded cu8 capture on the
    card, every injected message decoded and nothing else, its .txt equal
    to the same flow's --device cpu run's, its kernels' launches (K5 in
    DeRTTY, none elsewhere); then the band monitor through the library on
    K4 against eager.  DeRTTY's capture is ``samples`` long (its text at
    45.45 Bd needs ~32 M samples), the others' and the band's half that
    (their messages fill any length; the band's pages need ~8 M)."""
    from csdr_tpu_torch.apps import soapy_sdr_cli as cli

    out = {}
    for i, (kind, (make, fs, extra, rate)) in enumerate(packet_flows(ct).items()):
        n = samples if kind == "DeRTTY" else samples // 2
        x, msgs = make(n, SEED + 800 + 10 * i)
        path = os.path.join(tmp, f"{kind}.cu8")
        write_cu8(path, x)
        del x
        n_out = n * rate // fs
        want = cli.packet_lines(kind, msgs)
        common = ["--filename", path, "-s", str(fs), *extra, "-n", str(n_out),
                  "--demod", PACKET_DEMOD[kind]]
        prefix = {d: os.path.join(tmp, f"{kind}_{d}") for d in ("cuda", "cpu")}
        suffix = cli.PACKET_SUFFIX[kind]
        # the CLI prints every decoded message: thousands of lines
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            counts = cli_run(torch, cli.main, common + ["-o", prefix["cuda"], "--device", "cuda"])
            check_counts(counts, PACKET_KERNELS.get(kind), f"CLI {kind}")
            cli_run(torch, cli.main, common + ["-o", prefix["cpu"], "--device", "cpu"])
        with open(prefix["cuda"] + suffix) as f:
            got = f.read()
        with open(prefix["cpu"] + suffix) as f:
            got_cpu = f.read()
        lines = got.splitlines()
        missing = list((Counter(want) - Counter(lines)).elements())
        extra_lines = list((Counter(lines) - Counter(want)).elements())
        out[kind] = dict(launches=counts, messages=len(lines), injected=len(want),
                         equal_to_cpu=got == got_cpu)
        emit(dict(phase="packet", flow=f"-s {fs} {' '.join(extra)} {PACKET_DEMOD[kind]}",
                  wire="cu8", samples=n, output_rate=rate,
                  missing=missing[:3], unexpected=extra_lines[:3], **out[kind], **card))
        check(lines == want, f"CLI {kind}: {len(missing)} injected messages missing, "
                             f"{len(extra_lines)} unexpected, of {len(want)}")
        check(got == got_cpu, f"CLI {kind}: the card's {suffix} differs from --device cpu's")
        os.unlink(path)

    # the band monitor through the library: K4 against eager
    n = samples // 2
    x, want = band_capture(n, SEED + 900)
    band_path = os.path.join(tmp, "band.cu8")
    write_cu8(band_path, x)
    del x
    from csdr_tpu_torch.models import pocsag

    res = {}
    for backend, kern in (("pfb_fused", "pfb_channelize_fused"), ("eager", None)):
        sink = ct.CollectSink()
        torch.cuda.synchronize()
        reset_counts()
        band_pipeline(ct, backend, dev).run(ct.cu8_file_source(band_path, BLOCK), sink)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, kern, f"band monitor {backend}")
        score, env = sink.concat()
        check(score.shape == env.shape == (BAND_NCH, n // BAND_NCH),
              f"band monitor {backend}: leaves {score.shape} {env.shape}")
        msgs = pocsag.decode_channels((score, env), BAND_RATE)
        res[backend] = dict(launches=counts, msgs=msgs, score=score, env=env)
    os.unlink(band_path)
    paged = sorted(BAND_PAGES)
    (k, e) = res["pfb_fused"], res["eager"]
    env_max = float(np.abs(k["env"] - e["env"]).max())
    # the score where a page is on the air: the discriminator's atan2 turns
    # K4's rounding on a noise-only sample into a ±2π branch flip (±1/(kf·k)
    # after the bit filter), as K3's demod (tests/test_torch_cuda.py)
    on_air = on_air_mask(e["env"][paged], BAND_RATE / 1200.0)
    score_max = float(np.abs(k["score"][paged] - e["score"][paged])[on_air].max())
    key = lambda m: (m["channel"], m["ric"], m["fn"], m["text"])  # noqa: E731
    for backend, r in res.items():
        out[f"band monitor {backend}"] = dict(
            launches=r["launches"], messages=len(r["msgs"]), injected=len(want),
            decoded_as_injected=[key(m) for m in r["msgs"]] == [key(m) for m in want])
    emit(dict(phase="packet", flow=f"library pocsag_band_monitor({BAND_NCH}, {BAND_RATE:g})",
              wire="cu8", samples=n, blocks=-(-n // BLOCK),
              on_air_share=float(on_air.mean()),
              k4_vs_eager_env_max=env_max, k4_vs_eager_score_max_paged=score_max,
              **{f"{b}": out[f"band monitor {b}"] for b in res}, **card))
    for backend, r in res.items():
        check(out[f"band monitor {backend}"]["decoded_as_injected"],
              f"band monitor {backend}: decoded {[key(m) for m in r['msgs']][:4]}…, "
              f"injected {[key(m) for m in want][:4]}…")
    check(env_max < PFB_MAX_ERR and score_max < PFB_MAX_ERR,
          f"band monitor K4 vs eager: envelope {env_max}, score {score_max}")
    out["band monitor pfb_fused"].update(k4_vs_eager_env_max=env_max,
                                         k4_vs_eager_score_max_paged=score_max)
    return out


# ---- 9. symbol sync, the coded modem and the beacon ---------------------------

SYNC_NCH, SYNC_K = 64, 10      # 64 × 40 kHz channels; k = 10: 4,000 baud
SYNC_CHANNELS = (3, 11, 19, 27, 35, 43, 51, 59)   # helicopter 2-FSK; the rest noise
SYNC_PPM = 100e-6              # each channel's symbol clock within ±100 ppm
SYNC_FE_RATE, SYNC_FE_K = 48000, 12   # -c 1 -b 48000: 4,000 baud at 12 samples/symbol
SYNC_FE_BLOCK = 1 << 16        # the -c 1 flow's --blocksize; the CPU run takes 2 blocks
TRACK_K, TRACK_M = 4, 3        # the tracker's RRC-shaped packets (tests/test_modem.py)
TRACK_SNR = {"qpsk": 20.0, "qam16": 26.0}
TRACK_PACKETS, TRACK_BITS, TRACK_TRAIN = 64, 512, 2048
TRACK_BLOCK = 1 << 16          # the tracker's Pipeline block, in samples


def sync_capture(torch, dev, n: int, seed: int):
    """SYNC_NCH channels of 2.56 MS/s: helicopter 2-FSK (±0.1 cycles/sample
    at the channel rate) on SYNC_CHANNELS, each with its own coordinates,
    start phase and symbol clock (±SYNC_PPM), over noise.  The levels,
    clocks and noise are numpy's from the seed; the per-sample phase is
    made on the device in float64.  Returns (IQ complex64 on the device,
    {channel: text}, {channel: clock offset})."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(host_noise(n, seed + 1, 0.02)).to(dev)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    spb = SYNC_K * SYNC_NCH                    # input samples per symbol
    dev_c = 0.02 * SYNC_K * 0.5 / SYNC_NCH     # deviation, cycles per input sample
    texts, eps_of = {}, {}
    for ch in SYNC_CHANNELS:
        eps, d0, c0 = rng.uniform(-SYNC_PPM, SYNC_PPM), rng.uniform(0, spb), rng.uniform(0, 1)
        texts[ch], eps_of[ch] = heli_text(ch), eps
        lv = torch.from_numpy(heli_levels(texts[ch], int(n / spb) + 4)).to(dev)
        sym = torch.floor((t + d0) / (spb * (1 + eps))).to(torch.int64)
        fc = (ch - (SYNC_NCH - 1) / 2) / SYNC_NCH
        cyc = c0 + torch.cumsum(lv[sym] * dev_c, 0) + fc * t
        cyc -= torch.floor(cyc)
        x += (0.3 * torch.polar(torch.ones_like(cyc), 2 * np.pi * cyc)).to(torch.complex64)
        del sym, cyc
    return x, texts, eps_of


def sync_close(got: np.ndarray, want: np.ndarray, rec: tuple) -> list:
    """[max error, outputs that matched only the other pick, outputs at a
    phase tie, outputs at a window crossing, outputs]: ``got`` against
    ``want`` or, where float order picks, ``want``'s output of the other
    pick (``rec``: ``other_pick``'s (codes, other) for ``want``), relative
    to the largest of ``want``."""
    codes, other = rec
    want = want.astype(np.float64)
    scale = np.abs(want).max() + 1e-12
    e0 = np.abs(got - want) / scale
    err = np.minimum(e0, np.abs(got - other) / scale)
    return [float(err.max()), int(((e0 >= SYNC_TOL) & (err < SYNC_TOL)).sum()),
            int((codes == 1).sum()), int((codes == 2).sum()), int(err.size)]


def sync_agree(parts: list) -> list:
    """sync_close over several rows: [the worst error, the sums of the
    counts]."""
    return [max(p[0] for p in parts)] + [sum(p[i] for p in parts) for i in range(1, 5)]


def sync_graph(ct, backend: str):
    """The CLI's -c 64 DeNBFMSync graph behind the cu8 reader."""
    from csdr_tpu_torch.models.receivers import channelized_receiver
    from csdr_tpu_torch.models.symsync import fm_dem_with_sync

    return ct.chain(ct.u8_to_iq(), channelized_receiver(SYNC_NCH, fm_dem_with_sync(SYNC_K),
                                                        backend=backend))


def phase_sync(torch, ct, pf, dev, card, tmp) -> dict:
    """9. DeNBFMSync, the coded modem and the beacon (K4; K9, the block sync).

    9a. K4 at the DeNBFMSync graph's block (its granule nch·tileF·k/… rounds
        2^23 down to 8,376,320 samples, F = 130,880 frames) against its plain
        version over 3 state-chained blocks; then
        PerChannel(fm_dem_with_sync(10)) on K4's output on the card against
        the same graph on the CPU, on the occupied channels.
    9b. -c 64 "DeNBFMSync 10" on a 2^25-sample cu8 capture with helicopter
        frames on 8 channels, pfb_fused (K4 once and K9 twice per block, no
        other kernel) and eager (K9 alone): occupied channels against each
        other, helidecode's coordinates on both (every occupied channel, the
        same count, nothing on the empty ones), and K9 alone at the flow's
        panel against its plain version on the card.
    9c. -c 1 --offset F -b 48000 "DeNBFMSync 12" on one of those channels,
        on the card and on the CPU (2 blocks): samples and coordinates.
    9d. The library: coded qpsk and qam16 packets through sym_tracker →
        coded_packet_demodulate on the card, every payload decoded; 32
        beacons at −13 dB through beacon_decode; FSKDemod against the CPU."""
    from csdr_tpu_torch.apps import soapy_sdr_cli as cli
    from csdr_tpu_torch.core.block import PerChannel
    from csdr_tpu_torch.models import symsync
    from csdr_tpu_torch.ops.cuda import symsync_block as k9

    out = {}
    graph = sync_graph(ct, "pfb_fused")
    block = BLOCK // graph.granule * graph.granule
    F = block // SYNC_NCH
    nblocks = -(-CAPTURE // block)
    x, texts, eps_of = sync_capture(torch, dev, CAPTURE, SEED + 1000)
    path = os.path.join(tmp, "heli.cu8")
    to_cu8(torch, x).cpu().numpy().tofile(path)
    emit(dict(phase="sync_capture", samples=CAPTURE, granule=graph.granule, block=block,
              frames_per_block=F, blocks=nblocks, channels=list(SYNC_CHANNELS),
              clock_ppm={ch: e * 1e6 for ch, e in eps_of.items()}, **card))

    # 9a. K4 at F frames, and the sync on the card against the CPU
    sk = st = ct.firpfbch_channelizer(SYNC_NCH).init(dev)
    ks, ts = [], []
    before = pf.launches["pfb_channelize_fused"]
    for b in range(3):
        xb = x[b * block:(b + 1) * block]
        sk, yk = pf.channelize_pfb_step(sk, xb, nch=SYNC_NCH)
        st, yt = pfb_plain_step(torch, pf, st, xb, SYNC_NCH, False)
        ks.append(yk), ts.append(yt)
    torch.cuda.synchronize()
    check(pf.launches["pfb_channelize_fused"] == before + 3, "9a: K4 launch count")
    check(ks[0].shape == (SYNC_NCH, F), f"9a: K4 output {tuple(ks[0].shape)}")
    k4_max, k4_rms = errors(as_real(torch, torch.cat(ks, 1)), as_real(torch, torch.cat(ts, 1)))
    del ts
    sync = PerChannel(symsync.fm_dem_with_sync(SYNC_K), SYNC_NCH)
    sg, sc = sync.init(dev), sync.init(torch.device("cpu"))
    occ = list(SYNC_CHANNELS)
    parts = []
    for b in range(3):
        sg, yg = sync.apply(sg, ks[b])
        with record_ties(SYNC_TIE) as rec:
            sc, yc = sync.apply(sc, ks[b].cpu())
        yg = yg.cpu().numpy()
        check(yg.shape == (SYNC_NCH, F // SYNC_K * 2) and bool(np.isfinite(yg).all()),
              f"9a: sync output {yg.shape}")
        parts += [sync_close(yg[ch], yc.numpy()[ch], (rec[0][0][ch], rec[0][1][ch]))
                  for ch in occ]
    worst = sync_agree(parts)
    del ks, sg, sc
    out["9a"] = dict(k4_vs_plain_max=k4_max, k4_vs_plain_rms=k4_rms, sync_card_vs_cpu=worst)
    emit(dict(phase="sync_kernel", shape=f"({F + 13}, {SYNC_NCH}) -> ({SYNC_NCH}, {F})",
              blocks=3, **out["9a"], **card))
    check(k4_max < PFB_MAX_ERR and k4_rms < RMS_ERR, f"9a: K4 vs plain max {k4_max} rms {k4_rms}")
    check(worst[0] < SYNC_TOL, f"9a: sync card vs CPU {worst} (max, other pick, ties, "
                               "crossings, of)")

    # 9b. the main path through the CLI, both backends at pfb_fused's block
    # (eager's granule, 640, would take 8,388,480: the sync's line fits, one
    # per block, then see other blocks)
    prefix = {b: os.path.join(tmp, f"sync_{b}") for b in ("pfb_fused", "eager")}
    argv = lambda b: ["--filename", path, "-n", str(CAPTURE), "-c", str(SYNC_NCH),  # noqa: E731
                      "--demod", f"DeNBFMSync {SYNC_K}", "--backend", b,
                      "--blocksize", str(block), "-o", prefix[b], "--device", "cuda"]
    # K4 on pfb_fused; K9, the sync, twice a block on both
    kern = {"pfb_fused": ("pfb_channelize_fused", "symsync_block"), "eager": "symsync_block"}
    runs = {b: {} for b in kern}
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        counts = cli_run(torch, cli.main, argv("pfb_fused"))
        check_counts(counts, kern["pfb_fused"], "9b pfb_fused")
        check(counts["pfb_channelize_fused"] == nblocks,
              f"9b: K4 launched {counts['pfb_channelize_fused']} times for {nblocks} blocks")
        runs["pfb_fused"]["launches"] = counts
        with record_ties(SYNC_TIE) as rec:
            counts = cli_run(torch, cli.main, argv("eager"))
        check_counts(counts, kern["eager"], "9b eager")
        runs["eager"]["launches"] = counts
        for b in kern:
            got = runs[b]["launches"]["symsync_block"]
            check(got == 2 * nblocks, f"9b {b}: K9 launched {got} times for {nblocks} blocks")
    nout = CAPTURE * 2 // (SYNC_NCH * SYNC_K)
    # sample by sample on the full blocks: the last block is zero-padded past
    # the capture's end, where the channels hold only the DC blocker's decay
    # and FM demod reads atan2 of rounding, which enters that block's line fit
    full = CAPTURE // block * (block * 2 // (SYNC_NCH * SYNC_K))
    codes, other = (np.concatenate([r[i] for r in rec], axis=-1)[:, :full] for i in (0, 1))
    chans = {b: read_channels(prefix[b], "f32", np.float32, SYNC_NCH, 4 * nout) for b in kern}
    worst = sync_agree([sync_close(chans["pfb_fused"][ch][:full], chans["eager"][ch][:full],
                                   (codes[ch], other[ch])) for ch in occ])
    last = float(max(np.abs(chans["pfb_fused"][ch][full:] - chans["eager"][ch][full:]).max(
        initial=0.0) / np.abs(chans["eager"][ch]).max() for ch in occ))
    del chans
    coords = {b: [heli_decode(f"{prefix[b]}_ch{ch + 1}.f32") for ch in range(SYNC_NCH)]
              for b in kern}
    frames = CAPTURE // (SYNC_K * SYNC_NCH) // 730
    for b, r in runs.items():
        r["coords_per_channel"] = {ch: len(coords[b][ch]) for ch in occ}
        r["coords_on_empty_channels"] = sum(len(coords[b][ch]) for ch in range(SYNC_NCH)
                                            if ch not in occ)
    # K9 alone on the panel the main path's sync hands it (the first block,
    # no carried τ), held to its plain version's eager ops on the card on
    # the occupied channels
    u8 = torch.from_numpy(np.fromfile(path, np.uint8, count=2 * block).reshape(block, 2)).to(dev)
    chan = ct.chain(ct.u8_to_iq(), ct.dc_blocker(), ct.firpfbch_channelizer(SYNC_NCH))
    _, panel = chan.apply(chan.init(dev), u8)
    with kernel_inputs(k9, "symsync_block") as seen:
        sync.apply(sync.init(dev), panel)
    x9, bank9, rot9, st9, c9 = seen[0]
    (_, tau9, _), y9 = k9.symsync_block(x9, bank9, rot9, st9, c9)
    line9: list = []
    (_, tau9_plain, _), y9_plain = k9.symsync_block_ref(x9, bank9, rot9, st9, c9, line9)
    codes9, other9 = other_pick(c9, bank9, torch.cat([st9[0], x9], dim=-1), y9.shape[-1],
                                *line9[0], SYNC_TIE)
    y9, y9_plain = y9.cpu().numpy(), y9_plain.cpu().numpy()
    k9_run = dict(
        shape=f"{tuple(x9.shape)} {str(x9.dtype)[6:]} -> {tuple(y9.shape)}",
        vs_plain=sync_agree([sync_close(y9[ch], y9_plain[ch], (codes9[ch], other9[ch]))
                             for ch in occ]),
        tau_err=float((tau9 - tau9_plain)[occ].abs().max()))
    del u8, panel, seen, x9, st9, y9, y9_plain, other9
    out["9b"] = dict(runs=runs, pfb_vs_eager_occupied=worst,
                     pfb_vs_eager_occupied_padded_block=last, block=block, k9=k9_run)
    emit(dict(phase="sync_main_path", flow=f"-c {SYNC_NCH} DeNBFMSync {SYNC_K}", wire="cu8",
              samples=CAPTURE, block=block, blocks=nblocks,
              pfb_fused_vs_eager_occupied=worst, compared_outputs_per_channel=full,
              pfb_fused_vs_eager_occupied_padded_block=last, frames_per_channel=frames,
              k9=k9_run, **runs, **card))
    check(k9_run["vs_plain"][0] < SYNC_TOL and k9_run["tau_err"] < 1e-3,
          f"9b: K9 vs its plain version {k9_run['vs_plain']} (max, other pick, ties, "
          f"crossings, of), tau {k9_run['tau_err']}")
    check(worst[0] < SYNC_TOL, f"9b: pfb_fused vs eager on the occupied channels {worst} "
                               "(max, other pick, ties, crossings, of)")
    for ch in occ:
        want = heli_coord(texts[ch])
        for b in kern:
            got = coords[b][ch]
            check(len(got) >= 2 * frames * 9 // 10 and set(got) == {want},
                  f"9b {b} channel {ch}: {len(got)} coordinates {set(got)}, want {want} "
                  f"from ~{2 * frames - 1}")
        check(len(coords["pfb_fused"][ch]) == len(coords["eager"][ch]),
              f"9b channel {ch}: {len(coords['pfb_fused'][ch])} coordinates on pfb_fused, "
              f"{len(coords['eager'][ch])} on eager")
    for b in kern:
        check(runs[b]["coords_on_empty_channels"] == 0,
              f"9b {b}: {runs[b]['coords_on_empty_channels']} coordinates on empty channels")
    for b in kern:
        for ch in range(SYNC_NCH):
            os.unlink(f"{prefix[b]}_ch{ch + 1}.f32")

    # 9c. one channel through the front end, on the card and on the CPU
    ch = SYNC_CHANNELS[2]
    offset = (ch - (SYNC_NCH - 1) / 2) / SYNC_NCH * 2.56e6
    n_out = CAPTURE * SYNC_FE_RATE // 2560000
    n_cpu = 2 * (SYNC_FE_BLOCK // SYNC_FE_K * SYNC_FE_K)
    fe_prefix = {d: os.path.join(tmp, f"sync_fe_{d}") for d in ("cuda", "cpu")}
    fe_argv = lambda d, n: ["--filename", path, "-s", "2560000", "--offset", str(offset),  # noqa: E731
                            "-b", str(SYNC_FE_RATE), "-n", str(n), "--demod",
                            f"DeNBFMSync {SYNC_FE_K}", "--blocksize", str(SYNC_FE_BLOCK),
                            "-o", fe_prefix[d], "--device", d]
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        counts = cli_run(torch, cli.main, fe_argv("cuda", n_out))
        check_counts(counts, "symsync_block", "9c")
        with record_ties(SYNC_TIE) as rec:
            cli_run(torch, cli.main, fe_argv("cpu", n_cpu))
    card_y = np.fromfile(fe_prefix["cuda"] + ".f32", np.float32)
    cpu_y = np.fromfile(fe_prefix["cpu"] + ".f32", np.float32)
    check(card_y.shape == (n_out * 2 // SYNC_FE_K,) and cpu_y.shape == (n_cpu * 2 // SYNC_FE_K,),
          f"9c: {card_y.shape} {cpu_y.shape} samples")
    fe_err = sync_close(card_y[:len(cpu_y)], cpu_y,
                        tuple(np.concatenate([r[i] for r in rec], -1)[:len(cpu_y)]
                              for i in (0, 1)))
    fe_coords = {d: heli_decode(fe_prefix[d] + ".f32") for d in fe_prefix}
    out["9c"] = dict(flow=f"-c 1 --offset {offset:g} -b {SYNC_FE_RATE} DeNBFMSync {SYNC_FE_K}",
                     card_vs_cpu=fe_err, coords={d: len(v) for d, v in fe_coords.items()})
    emit(dict(phase="sync_front_end", channel=ch, samples=CAPTURE, cpu_output_samples=n_cpu,
              **out["9c"], **card))
    check(fe_err[0] < SYNC_TOL, f"9c: card vs CPU {fe_err} (max, other pick, ties, crossings, "
                                "of)")
    want = heli_coord(texts[ch])
    check(set(fe_coords["cuda"]) == {want} and len(fe_coords["cuda"]) >= 2 * frames * 9 // 10,
          f"9c: {len(fe_coords['cuda'])} coordinates {set(fe_coords['cuda'])}, want {want}")
    check(len(fe_coords["cpu"]) > 0 and fe_coords["cpu"] == fe_coords["cuda"][
        :len(fe_coords["cpu"])], f"9c: the CPU's {len(fe_coords['cpu'])} coordinates differ")
    for d in fe_prefix:
        os.unlink(fe_prefix[d] + ".f32")
    os.unlink(path)
    del x

    out["9d"] = phase_sync_library(torch, ct, dev, card)
    return out


def track_stream(ms: str, seed: int):
    """TRACK_TRAIN random training symbols, then TRACK_PACKETS coded packets
    of TRACK_BITS random bits, 32 random symbols apart, then random symbols
    to whole TRACK_BLOCKs, RRC-shaped at
    TRACK_K samples/symbol with gain 0.31, a 0.3 rad carrier phase, a 1.7
    sample delay and AWGN at TRACK_SNR (tests/test_modem.py:129-153);
    returns (IQ, tx indices, [(first symbol, payload)])."""
    from csdr_tpu_torch.models import modem
    from csdr_tpu_torch.utils import firdes

    rng = np.random.default_rng(seed)
    bps = modem.bits_per_symbol(ms)
    parts = [modem.modulate(rng.integers(0, 2, TRACK_TRAIN * bps), ms)]
    packets, pos = [], TRACK_TRAIN
    for _ in range(TRACK_PACKETS):
        bits = rng.integers(0, 2, TRACK_BITS)
        sym = modem.coded_packet_modulate(bits, ms)
        packets.append((pos, len(sym), bits))
        gap = modem.modulate(rng.integers(0, 2, 32 * bps), ms)
        parts += [sym, gap]
        pos += len(sym) + len(gap)
    # random filler to whole tracker blocks: a zero-padded block would skew
    # the block's power normalization
    fill = -pos % (TRACK_BLOCK // TRACK_K)
    parts.append(modem.modulate(rng.integers(0, 2, fill * bps), ms))
    syms = np.concatenate(parts).astype(np.complex128)
    h = firdes.rrc(TRACK_K, TRACK_M, 0.25)
    h = h / np.sqrt(np.sum(h ** 2))
    up = np.zeros(len(syms) * TRACK_K, np.complex128)
    up[::TRACK_K] = syms
    x = np.convolve(up, h)[: len(up)] * np.sqrt(TRACK_K) * 0.31 * np.exp(0.3j)
    t = np.arange(61) - 30
    x = np.convolve(x, np.sinc(t - 0.7) * np.hamming(61))[31:][: len(x)]   # 1.7 samples late
    n0 = 10 ** (-TRACK_SNR[ms] / 10.0) * np.mean(np.abs(x) ** 2)
    x = x + np.sqrt(n0 / 2) * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
    C = modem.constellation(ms)
    idx = np.abs(syms[:, None] - C[None, :]).argmin(1)
    return x.astype(np.complex64), idx, packets


def phase_sync_library(torch, ct, dev, card) -> dict:
    """9d: the tracker and the coded packet link, the beacon, FSKDemod."""
    from csdr_tpu_torch.blocks import fsk_demodulator
    from csdr_tpu_torch.models import beacon, modem, symsync

    out = {}
    for i, ms in enumerate(("qpsk", "qam16")):
        x, tx, packets = track_stream(ms, SEED + 1100 + i)
        tracker = symsync.sym_tracker(TRACK_M, TRACK_K, ms=ms)
        sink = ct.CollectSink()
        torch.cuda.synchronize()
        reset_counts()
        ct.Pipeline(tracker, block_size=TRACK_BLOCK, device=dev).run(iter([x]), sink)
        torch.cuda.synchronize()
        check_counts(read_counts(), "symsync_block", f"9d tracker {ms}")
        y = sink.concat()
        check(y.shape == (len(x) // TRACK_K,) and bool(np.isfinite(y).all()),
              f"9d tracker {ms}: output {y.shape}")
        # the tracker's delay, from the training symbols
        dec = modem.hard_decision(torch.from_numpy(y), ms)[0].numpy()
        acc, lag = max((float(np.mean(dec[1000 + L:TRACK_TRAIN - 16 + L]
                                      == tx[1000:TRACK_TRAIN - 16])), L) for L in range(0, 33))
        check(acc > 0.98, f"9d tracker {ms}: {acc} of the training symbols at lag {lag}")
        yd = torch.from_numpy(y).to(dev)
        ok = 0
        nv = 10 ** (-TRACK_SNR[ms] / 10.0)
        for pos, n, bits in packets:
            got = modem.coded_packet_demodulate(yd[pos + lag:pos + lag + n], ms, noise_var=nv)
            ok += got is not None and np.array_equal(got, bits)
        out[ms] = dict(symbols=len(y), lag=lag, training_accuracy=acc, packets=len(packets),
                       decoded=ok)
        emit(dict(phase="sync_library", what=f"sym_tracker -> coded_packet_demodulate {ms}",
                  **out[ms], **card))
        check(ok == len(packets), f"9d {ms}: {ok} of {len(packets)} payloads decoded")

    ok, refused, wrong = [], [], []
    for i, (m, xb) in enumerate(beacon_set()):
        got, info = beacon.beacon_decode(xb, spsym=64)
        (refused if got is None else ok if np.array_equal(got, m) else wrong).append(i)
    te = beacon.tone_energies_device(torch.from_numpy(xb).to(dev), 64).cpu().numpy()
    te_rel = float(np.abs(te - beacon.tone_energies(xb, 64)).max() / np.abs(te).max())
    out["beacon"] = dict(beacons=BEACONS, snr_db=BEACON_SNR_DB, decoded=len(ok),
                         refused=refused, wrong=wrong, tone_energies_device_rel=te_rel)
    emit(dict(phase="sync_library", what="beacon_decode", **out["beacon"], **card))
    # the mode's own limit: at −13 dB the JAX package refuses the same
    # beacons of this set (tests/test_torch_modem.py holds the port to it)
    check(not wrong and refused == BEACON_REFUSED,
          f"9d beacons: refused {refused} (want {BEACON_REFUSED}), wrong {wrong}")
    check(te_rel < 1e-5, f"9d: tone_energies_device vs host {te_rel}")

    rng = np.random.default_rng(SEED + 1300)
    syms = rng.integers(0, 4, 1 << 16)
    f = 0.25 * (2.0 * syms - 3) / 3
    xf = np.exp(2j * np.pi * np.concatenate([[0.0], np.cumsum(np.repeat(f, 16))[:-1]]))
    xf = (xf + 0.3 * (rng.normal(size=len(xf)) + 1j * rng.normal(size=len(xf)))).astype(
        np.complex64)
    res = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        sink = ct.CollectSink()
        ct.Pipeline(ct.chain(fsk_demodulator(2, 16, 0.25)), block_size=1 << 18,
                    device=d).run(iter([xf]), sink)
        res[label] = sink.concat()
    out["fsk"] = dict(symbols=len(syms), dtype=str(res["card"].dtype),
                      equal_to_cpu=bool(np.array_equal(res["card"], res["cpu"])),
                      symbol_accuracy=float(np.mean(res["card"] == syms)))
    emit(dict(phase="sync_library", what="FSKDemod(2, 16, 0.25)", **out["fsk"], **card))
    check(out["fsk"]["equal_to_cpu"] and res["card"].dtype == np.uint32
          and out["fsk"]["symbol_accuracy"] > 0.99, f"9d FSKDemod: {out['fsk']}")
    return out


# ---- 10. the imagery receivers and the file surface ------------------------------

APT_FS = 33280.0             # 8 × the 4,160 Hz word rate
APT_LINES = 1200             # a 10 min pass at two lines per second
APT_CF32_LINES = 120         # the .cf32 WBFM capture through the app's FM front
APT_KF = 0.6                 # apt_decode's default WBFM deviation
SSTV_FS = 11025.0            # one Martin 1 image, 320 × 256
WEFAX_FS, WEFAX_LINES = 12000.0, 600   # one chart at 120 lpm
IMG_WARMUP = 180             # the 161-tap FIR's start-up (tests/test_sstv.py:97-102)
GOLDEN_REL = 2e-5            # tests/test_golden.py
WAV_SAMPLES = 1 << 24        # the mono WAV of 10b: 2^23 IQ samples
WAV_CARRIERS = 55            # channels 0..54 loaded; 55..63 hold the images of 8..0
WAV_FIRST = 1 << 20          # wav_iq_source outputs compared, card against CPU
PROFILE_SAMPLES = 1 << 24    # the cf32 capture of 10c and 10d
AM_SAMPLES = 1 << 20         # 10d's -n, at the front end's 256 kS/s
PLOT_REL = 1e-4              # the plot scripts, card against CPU


@contextlib.contextmanager
def recording_tracks(app):
    """Keep the device track an offline decoder collects (its
    ``collect``, the Pipeline run of its chain) while it runs: a test
    helper, as ``record_ties``."""
    tracks, collect = [], app.collect

    def rec(*args, **kw):
        out = collect(*args, **kw)
        tracks.append(np.asarray(out))
        return out

    app.collect = rec
    try:
        yield tracks
    finally:
        app.collect = collect


def app_run(torch, app, argv: list[str]) -> dict:
    """One offline-decoder run (``app.main(argv)``) with every kernel count
    set to 0 just before it; the counts, the track it decoded and what it
    printed."""

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with recording_tracks(app) as tracks, contextlib.redirect_stdout(buf):
        rc = app.main(argv)
        torch.cuda.synchronize()
    check(rc == 0, f"{app.__name__} {' '.join(argv)}: exit code {rc}: {buf.getvalue()}")
    return dict(counts=read_counts(), track=tracks[0], out=buf.getvalue().strip())


def read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    magic, dims, _maxval, payload = raw.split(b"\n", 3)
    w, h = (int(v) for v in dims.split())
    img = np.frombuffer(payload, np.uint8)
    return img.reshape(h, w, 3) if magic == b"P6" else img.reshape(h, w)


def apt_pass(lines: int, seed: int) -> np.ndarray:
    """(lines, 2080) APT rows: sync A and B at spec levels, black spaces,
    smooth video that changes from line to line (a cloud field), telemetry
    wedges that step every eight lines."""
    from csdr_tpu_torch.models import apt

    rng = np.random.default_rng(seed)
    t = np.arange(909) / 909
    ln = np.arange(lines)[:, None] / lines
    rows = np.zeros((lines, apt.LINE_WORDS))
    rows[:, :39] = apt.SYNC_A * 233 + 11
    rows[:, 39:86] = 11
    ph = rng.uniform(0, 2 * np.pi, 3)
    rows[:, 86:995] = 128 + 60 * np.sin(2 * np.pi * (3 * t + 2 * ln) + ph[0]) + 40 * np.cos(
        2 * np.pi * (7 * t - 5 * ln) + ph[1])
    rows[:, 995:1040] = 40 + 25 * ((np.arange(lines) // 8) % 8)[:, None]
    rows[:, 1040:1079] = apt.SYNC_B * 233 + 11
    rows[:, 1079:1126] = 11
    rows[:, 1126:2035] = 128 + 90 * np.cos(2 * np.pi * (2 * t + 3 * ln) + ph[2])
    rows[:, 2035:] = 200
    return np.asarray(np.rint(rows), np.uint8)


def sstv_picture(seed: int) -> np.ndarray:
    """(256, 320, 3) smooth RGB content (tests/test_sstv.py's kind)."""
    rng = np.random.default_rng(seed)
    t = np.arange(320) / 320
    ln = np.arange(256)[:, None] / 256
    img = np.stack([128 + 100 * np.sin(2 * np.pi * (t + 2 * ln) + rng.uniform(0, 6)),
                    np.broadcast_to(255 * t, (256, 320)) * (0.5 + 0.5 * ln),
                    128 + 90 * np.cos(2 * np.pi * (2 * t - ln) + rng.uniform(0, 6))], axis=-1)
    return np.asarray(np.rint(img), np.uint8)


def wefax_chart(lines: int, seed: int) -> np.ndarray:
    """(lines, 1810) chart content: isobars as slow sinusoids
    (tests/test_wefax.py's kind)."""
    from csdr_tpu_torch.models import wefax

    rng = np.random.default_rng(seed)
    t = np.arange(wefax.PX_PER_LINE) / wefax.PX_PER_LINE
    ln = np.arange(lines)[:, None] / lines
    img = 200 - 150 * (0.5 + 0.5 * np.sin(2 * np.pi * (4 * t + 3 * ln) + rng.uniform(0, 6)))
    return np.asarray(np.rint(img), np.uint8)


def image_error(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    err = np.abs(got.astype(np.float64) - want)
    return float(np.median(err)), float(np.quantile(err, 0.95))


def imagery_case(torch, tmp, card, name, app, path, argv, samples, first,
                 info_of, want_img) -> dict:
    """One app on the card and on the CPU over the same file: the tracks
    within GOLDEN_REL of the CPU's largest value (from output ``first``),
    the same lines and sync positions (``info_of(track)``), the images
    within 1 LSB, the card's image against the transmitted one
    (``want_img(image, info) -> (median, q95, bounds)``)."""
    runs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"{name}_{dev}")
        r = app_run(torch, app, [path, *argv, "-o", out, "--device", dev])
        check_counts(r["counts"], None, f"10a {name} --device {dev}")
        r["image"] = read_pnm(out)
        os.unlink(out)
        runs[dev] = r
    c, p = runs["cuda"], runs["cpu"]
    check(c["track"].shape == p["track"].shape,
          f"10a {name}: track {c['track'].shape} vs {p['track'].shape}")
    rel = float(np.abs(c["track"][first:].astype(np.float64) - p["track"][first:]).max()
                / np.abs(p["track"]).max())
    ic, ip = info_of(c["track"]), info_of(p["track"])
    same_shape = c["image"].shape == p["image"].shape
    diff = (np.abs(c["image"].astype(np.int16) - p["image"]) if same_shape else None)
    med, q95, (bmed, bq95) = want_img(c["image"], ic)
    res = dict(samples=samples, lines=ic["lines"], image_shape=list(c["image"].shape),
               card_vs_cpu_track_rel=rel, pixels_differing=int((diff > 0).sum()) if same_shape
               else None, max_lsb=int(diff.max()) if same_shape else None,
               error_median=med, error_q95=q95, report=c["out"])
    emit(dict(phase="imagery", app=name, **res, **card))
    check(rel < GOLDEN_REL, f"10a {name}: card vs CPU track {rel}")
    check(ic == ip, f"10a {name}: lines/syncs differ: card {ic} cpu {ip}")
    check(same_shape and res["max_lsb"] <= 1, f"10a {name}: images differ: {res}")
    check(med <= bmed and q95 <= bq95, f"10a {name}: error vs transmitted {med}, {q95}")
    return res


def phase_imagery(torch, dev, card, tmp) -> dict:
    """10a. The imagery apps on the card and on the CPU at the sizes users
    decode, inputs made by the port's own modulators."""
    from csdr_tpu_torch.apps import apt_decode, sstv_decode, wefax_decode
    from csdr_tpu_torch.models import apt, sstv, wefax

    out = {}
    img = apt_pass(APT_LINES, SEED + 100)

    def apt_info(track):
        _, info = apt.decode_words(track)
        return dict(lines=info["lines"], syncs=info["syncs"])

    def apt_error(got, info, img=img):
        s = np.asarray(info["syncs"])
        check(len(s) >= len(img) // 10 and bool(np.all(np.diff(s) == apt.LINE_WORDS)),
              f"10a APT: syncs not one line apart ({len(s)} lines)")
        first = int(s[0]) // apt.LINE_WORDS + (1 if int(s[0]) % apt.LINE_WORDS > 39 else 0)
        n = min(len(got), len(img) - first)
        va_got, _ = apt.split_channels(got[:n])
        va_want, _ = apt.split_channels(img[first:first + n])
        return (*image_error(va_got, va_want), (3.0, 12.0))  # tests/test_apt.py:68-69

    audio = apt.apt_modulate(img, APT_FS)
    part = audio[:APT_CF32_LINES * apt.LINE_WORDS * 8]
    iq = np.exp(1j * 2 * np.pi * APT_KF * np.cumsum(part, dtype=np.float64)).astype(np.complex64)
    path = os.path.join(tmp, "apt.cf32")
    iq.tofile(path)
    out["apt_cf32"] = imagery_case(
        torch, tmp, card, "apt_cf32", apt_decode, path, ["-s", str(APT_FS)], len(iq), 0,
        apt_info, lambda got, info: apt_error(got, info, img[:APT_CF32_LINES]))
    os.unlink(path)
    path = os.path.join(tmp, "apt.f32")
    audio.tofile(path)
    out["apt"] = imagery_case(torch, tmp, card, "apt", apt_decode, path,
                              ["-s", str(APT_FS)], len(audio), 0, apt_info, apt_error)
    os.unlink(path)
    del audio, part, iq

    pic = sstv_picture(SEED + 101)

    def sstv_info(track):
        mode, start = sstv.decode_vis(track, SSTV_FS)
        _, info = sstv.decode_freq(track, SSTV_FS)
        return dict(mode=mode, lines=info["lines"],
                    syncs=sstv.find_syncs(track, SSTV_FS, start).tolist())

    def sstv_error(got, info):
        n = min(len(got), len(pic))
        return (*image_error(got[:n], pic[:n]), (4.0, 16.0))  # tests/test_sstv.py:52-53

    audio = sstv.sstv_modulate(pic, SSTV_FS, mode="martin1")
    path = os.path.join(tmp, "sstv.f32")
    audio.tofile(path)
    out["sstv"] = imagery_case(torch, tmp, card, "sstv", sstv_decode, path,
                               ["-s", str(SSTV_FS)], len(audio), IMG_WARMUP, sstv_info,
                               sstv_error)
    os.unlink(path)

    chart = wefax_chart(WEFAX_LINES, SEED + 102)

    def wefax_info(track):
        start, score = wefax.find_phasing(track, WEFAX_FS)
        _, info = wefax.decode_freq(track, WEFAX_FS)
        return dict(lines=info["lines"], line_start=start, phasing_ok=score >= 0.9)

    def wefax_error(got, info):
        n = min(len(got), len(chart))
        return (*image_error(got[:n], chart[:n]), (4.0, 16.0))  # tests/test_wefax.py:52-53

    audio = wefax.wefax_modulate(chart, WEFAX_FS)
    path = os.path.join(tmp, "wefax.f32")
    audio.tofile(path)
    out["wefax"] = imagery_case(torch, tmp, card, "wefax", wefax_decode, path,
                                ["-s", str(WEFAX_FS)], len(audio), IMG_WARMUP, wefax_info,
                                wefax_error)
    os.unlink(path)
    return out


def wav_if_capture(torch, dev, n: int, seed: int) -> np.ndarray:
    """(n,) float32 WAV samples (a sound-card IF recording) that lift to an
    FM carrier in every channel of a 64-way split of the IQ: the Hilbert
    2:1 and the mix by π put WAV frequency f at IQ frequency 2f − 1/2, so
    channel k's centre is f = (k + 1/2)/128.  The converter's 21-tap
    band edges pass a carrier near f = 0 or 1/2 also as an image in the
    mirrored channel 63 − k, so channels 0..54 carry a carrier each and
    55..63 hold the images of 8..0 alone: one carrier per channel, none
    near zero where atan2 amplifies rounding."""
    rng = np.random.default_rng(seed)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    x = torch.zeros(n, dtype=torch.float64, device=dev)
    for k in range(WAV_CARRIERS):
        tone = 0.002 / 64 * (1 + k % 5) / 2   # cycles per WAV sample
        ph = (2 * np.pi * torch.remainder((k + 0.5) / 128 * t, 1.0)
              + 2.0 * torch.sin(2 * np.pi * torch.remainder(tone * t, 1.0))
              + float(rng.uniform(0, 2 * np.pi)))
        x += 0.075 * torch.cos(ph)
    x += torch.from_numpy(rng.standard_normal(n) * 1e-3).to(dev)
    return x.to(torch.float32).cpu().numpy()


def phase_wav(torch, dev, card, tmp) -> dict:
    """10b. A mono WAV through wav_iq_source, card against CPU, then the
    CLI's -c 64 DeNBFM on it under fused (K1) against eager."""
    import csdr_tpu_torch as ct
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu_torch.io.wav import write_wav

    path = os.path.join(tmp, "if.wav")
    write_wav(path, wav_if_capture(torch, dev, WAV_SAMPLES, SEED + 110), 96000)
    first = {}
    for d in ("cuda", "cpu"):
        gen = ct.wav_iq_source(path, 2 * WAV_FIRST, device=d)
        first[d] = next(gen)
        gen.close()
    check(first["cuda"].shape == first["cpu"].shape == (WAV_FIRST,),
          f"10b wav_iq_source: first block {first['cuda'].shape}")
    src_rel = float(np.abs(first["cuda"] - first["cpu"]).max() / np.abs(first["cpu"]).max())
    n_iq = WAV_SAMPLES // 2
    frames = n_iq // 64
    runs = {}
    for backend in ("fused", "eager"):
        prefix = os.path.join(tmp, f"wav_{backend}")
        argv = ["--filename", path, "-s", "48000", "-n", str(n_iq), "-c", "64", "--demod",
                "DeNBFM 0.6 F32", "--backend", backend, "--blocksize", str(BLOCK // 2),
                "-o", prefix]
        counts = cli_run(torch, cli_main, argv)
        check_counts(counts, "flagship_fused" if backend == "fused" else None,
                     f"10b -c 64 WAV {backend}")
        runs[backend] = dict(launches=counts)
        runs[backend]["audio"] = read_channels(prefix, "f32", np.float32, 64, frames * 4)
        for k in range(64):
            os.unlink(f"{prefix}_ch{k + 1}.f32")
    d = runs["fused"]["audio"][:, 1:].astype(np.float64) - runs["eager"]["audio"][:, 1:]
    mx, rms = float(np.abs(d).max()), float(np.sqrt((d ** 2).mean()))
    finite = bool(np.isfinite(runs["fused"]["audio"]).all())
    for r in runs.values():
        del r["audio"]
    res = dict(wav_samples=WAV_SAMPLES, iq_samples=n_iq, source_card_vs_cpu_rel=src_rel,
               fused_vs_eager_max=mx, fused_vs_eager_rms=rms, runs=runs)
    emit(dict(phase="wav_input", flow="-c 64 DeNBFM 0.6 F32 on a mono WAV", **res, **card))
    os.unlink(path)
    check(src_rel < GOLDEN_REL, f"10b wav_iq_source card vs CPU: {src_rel}")
    check(finite, "10b: non-finite audio")
    check(mx < 1.2e-3 and rms < 4e-5, f"10b fused vs eager: max {mx}, RMS {rms}")
    return res


def plot_arrays(path: str) -> list[np.ndarray]:
    """The arrays of a --spectrum (f, p) or --constellation (v) script."""
    with open(path) as f:
        txt = f.read()
    check("print -dpng" in txt, f"{path}: no plot command")
    if "f = [" in txt:
        return [np.array(txt.split(f"{k} = [")[1].split("];")[0].split(), float)
                for k in ("f", "p")]
    pts = re.findall(r"v\(end\+1\) = *(\S+) \+ j\* *(\S+);", txt)
    return [np.array(pts, float)]


def phase_file_surface(torch, dev, card, tmp) -> dict:
    """10c. -c 64 --backend pfb_fused --profile on a cf32 capture (K3 once
    per block, the stage table printed, the files bit-equal to the run
    without --profile); 10d. -c 1 DeAM AU behind a device front end, read
    back equal to the F32 run's samples, and its --spectrum and
    --constellation scripts against the CPU run's."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu_torch.io.wav import read_au

    path = os.path.join(tmp, "prof.cf32")
    occupied_band(torch, dev, 64, PROFILE_SAMPLES, SEED + 120).cpu().numpy().tofile(path)
    frames = PROFILE_SAMPLES // 64
    blocks = PROFILE_SAMPLES // BLOCK
    res = {}
    outs = {}
    for prof in (True, False):
        prefix = os.path.join(tmp, f"prof_{prof}")
        argv = ["--filename", path, "-n", str(PROFILE_SAMPLES), "-c", "64", "--demod",
                "DeNBFM 0.6 F32", "--backend", "pfb_fused", "--blocksize", str(BLOCK),
                "-o", prefix] + (["--profile"] if prof else [])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            counts = cli_run(torch, cli_main, argv)
        check_counts(counts, "pfb_fm_fused", f"10c --profile={prof}")
        check(counts["pfb_fm_fused"] == blocks,
              f"10c --profile={prof}: pfb_fm_fused launched {counts['pfb_fm_fused']} times, "
              f"want {blocks}")
        outs[prof] = read_channels(prefix, "f32", np.float32, 64, frames * 4)
        for k in range(64):
            os.unlink(f"{prefix}_ch{k + 1}.f32")
        res["profile" if prof else "plain"] = dict(launches=counts["pfb_fm_fused"])
        if prof:
            table = buf.getvalue()
    check("Per-stage budget" in table and "pfb_fused_fm(64)" in table and "TOTAL" in table,
          f"10c: no stage table in {table[-2000:]}")
    lines = table.splitlines()
    top = max(i for i, ln in enumerate(lines) if ln.startswith("Per-stage budget"))
    res["table"] = lines[top + 1:top + 2 + next(i for i, ln in enumerate(lines[top + 1:])
                                                if ln.startswith("TOTAL"))]
    res["bit_equal"] = bool(np.array_equal(outs[True], outs[False]))
    emit(dict(phase="profile", flow="-c 64 --backend pfb_fused --profile", **res, **card))
    check(res["bit_equal"], "10c: --profile changed the output")
    del outs

    n = AM_SAMPLES
    fe = ["--filename", path, "-s", "2560000", "--offset", "100000", "-b", "256000",
          "-n", str(n), "-c", "1"]
    runs = {}
    for name, dev_, fmt, plots in (("au", "cuda", "AU", True), ("f32", "cuda", "F32", False),
                                   ("cpu", "cpu", "AU", True)):
        prefix = os.path.join(tmp, f"am_{name}")
        argv = fe + ["--demod", f"DeAM {fmt}", "-o", prefix, "--device", dev_] + (
            ["--spectrum", "--constellation"] if plots else [])
        counts = cli_run(torch, cli_main, argv)
        check_counts(counts, None, f"10d DeAM {fmt} on {dev_}")
        if fmt == "AU":
            audio, rate = read_au(prefix + ".au")
            check(rate == 256000, f"10d: AU rate {rate}")
        else:
            audio = np.fromfile(prefix + ".f32", np.float32)
        runs[name] = dict(audio=audio,
                          plots=[plot_arrays(f"{prefix}_{k}.m") for k in ("spectrum",
                                                                           "constellation")]
                          if plots else None)
    au, f32, cpu = runs["au"], runs["f32"], runs["cpu"]
    plot_rel = max(float(np.abs(g - w).max() / np.abs(w).max())
                   for gs, ws in zip(au["plots"], cpu["plots"]) for g, w in zip(gs, ws))
    shapes_ok = all(g.shape == w.shape and w.size > 0
                    for gs, ws in zip(au["plots"], cpu["plots"]) for g, w in zip(gs, ws))
    res2 = dict(samples=n, au_equals_f32=bool(au["audio"].shape == f32["audio"].shape == (n,)
                                              and np.array_equal(au["audio"], f32["audio"])),
                card_vs_cpu_audio_rel=float(np.abs(au["audio"] - cpu["audio"]).max()
                                            / np.abs(cpu["audio"]).max()),
                plot_card_vs_cpu_rel=plot_rel, plots_parse=shapes_ok)
    emit(dict(phase="au_and_plots", flow="-s 2560000 --offset 100000 -b 256000 -c 1 DeAM AU "
              "--spectrum --constellation", **res2, **card))
    os.unlink(path)
    check(res2["au_equals_f32"], "10d: the AU samples differ from the F32 run's")
    check(shapes_ok and plot_rel < PLOT_REL, f"10d: plot scripts card vs CPU {plot_rel}")
    res["au"] = res2
    return res


def phase_imagery_and_files(torch, dev, card, tmp) -> dict:
    """Phase 10: 10a, 10b, then 10c and 10d."""
    return {name: timed(name, fn, torch, dev, card, tmp)
            for name, fn in (("imagery", phase_imagery), ("wav", phase_wav),
                             ("files", phase_file_surface))}


# ---- 11. the live-device path ------------------------------------------------

RTL_RATE, RTL_FREQ, RTL_PPM = 2_560_000, 100_000_000, 3
SYN_SAMPLES = 1 << 24    # 11b's synthetic device run
TILES = (8, 16, 32, 64, 128, 256, 512)   # 11d: K1's tileF candidates at nch 64


@contextlib.contextmanager
def rtl_server(capture: str, tmp: str, clients: int):
    """The port's rtl_tcp_server serving ``capture`` in a process of its own
    (``--port 0 -v``, ``--clients``; 0 = until killed); yields (port, the
    process, its log's path).  The process is killed on every way out."""
    log = os.path.join(tmp, f"rtl_server_{time.monotonic_ns()}.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "csdr_tpu_torch.apps.rtl_tcp_server", "--filename", capture,
             "--port", "0", "--clients", str(clients), "-v"],
            stdout=out, stderr=subprocess.STDOUT, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE))
    try:
        end = time.monotonic() + 60
        while not (m := re.search(r"rtl_tcp server on [\d.]+:(\d+)", open(log).read())):
            check(proc.poll() is None,
                  f"rtl_tcp_server exited {proc.returncode}: {open(log).read()[-2000:]}")
            check(time.monotonic() < end, "rtl_tcp_server printed no port in 60 s")
            time.sleep(0.05)
        yield int(m.group(1)), proc, log
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


@contextlib.contextmanager
def env_var(name: str, value: str):
    """``os.environ[name] = value`` for the block (a child process inherits
    it), the old value back after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def phase_device_rtl(torch, dev, card, tmp) -> dict:
    """11a. The slice's main path: the port's rtl_tcp_server (a process of
    its own) serves a 2^25-sample cu8 capture of phase 4's kind; the CLI
    reads it with --devname rtl_tcp and runs -c 64 DeNBFM on K1.  Its 64
    files equal the --filename run of the same samples as CF32 (the
    client's own conversion, ``iq_from_u8``) bit for bit and the cu8 file
    run's within U8_ERR; each source's two runs are equal; every channel
    sits on its tone; the server's command log holds the tuning."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu_torch.io.rtl_tcp import iq_from_u8

    nch, frames = 64, CAPTURE // 64
    j = 5 + 3 * (np.arange(nch) % 7)
    x = occupied_band(torch, dev, nch, CAPTURE, SEED + 1100, tones=j / 1024.0 / nch)
    u8 = to_cu8(torch, x).cpu().numpy()
    del x
    cu8_path, cf32_path = os.path.join(tmp, "live.cu8"), os.path.join(tmp, "live.cf32")
    u8.tofile(cu8_path)
    iq_from_u8(u8).tofile(cf32_path)
    del u8
    common = ["-n", str(CAPTURE), "-c", str(nch), "--demod", f"DeNBFM {KF} F32",
              "--backend", "fused", "--device", "cuda"]
    dev_argv = ["--devname", "rtl_tcp", "-s", str(RTL_RATE), "-f", str(RTL_FREQ),
                "--ppm", str(RTL_PPM), *common]
    want_log = [["set_sample_rate", RTL_RATE], ["set_frequency", RTL_FREQ],
                ["set_gain_mode", 0], ["set_freq_correction", RTL_PPM]]
    audio, launches = {}, {}
    for turn, src in enumerate(("rtl_tcp", "cf32", "cf32", "rtl_tcp")):
        out = os.path.join(tmp, f"live_{turn}")
        if src == "rtl_tcp":
            with rtl_server(cu8_path, tmp, 1) as (port, proc, log), \
                    env_var("CSDR_RTLTCP_ADDR", f"127.0.0.1:{port}"):
                counts = cli_run(torch, cli_main, dev_argv + ["-o", out])
                proc.wait(timeout=60)
                text = open(log).read()
            check(proc.returncode == 0, f"11a: rtl_tcp_server exit code {proc.returncode}")
            cmds = [json.loads(ln.removeprefix("commands: ")) for ln in text.splitlines()
                    if ln.startswith("commands: ")]
            check(cmds == [want_log], f"11a: the server's command log {cmds}, want {want_log}")
            check("served 1 client(s)" in text, f"11a: server log {text[-500:]}")
        else:
            counts = cli_run(torch, cli_main, ["--filename", cf32_path, *common, "-o", out])
        check_counts(counts, "flagship_fused", f"11a {src} run")
        got = read_channels(out, "f32", np.float32, nch, frames * 4)
        for k in range(nch):
            os.unlink(f"{out}_ch{k + 1}.f32")
        if src in audio:
            check(np.array_equal(got, audio[src]), f"11a: two {src} runs differ")
        else:
            audio[src], launches[src] = got, counts["flagship_fused"]
    check(np.array_equal(audio["rtl_tcp"], audio["cf32"]),
          "11a: the rtl_tcp run differs from the CF32 file run of the same samples")
    out = os.path.join(tmp, "live_cu8")
    counts = cli_run(torch, cli_main, ["--filename", cu8_path, *common, "-o", out])
    check_counts(counts, "flagship_fused", "11a cu8 run")
    cu8_max, cu8_rms = errors_np(read_channels(out, "f32", np.float32, nch, frames * 4),
                                 audio["rtl_tcp"])
    for k in range(nch):
        os.unlink(f"{out}_ch{k + 1}.f32")
    peaks = tone_peaks(audio["rtl_tcp"])
    on_tone = int((peaks == j * (frames // 1024)).sum())
    del audio
    for f in (cu8_path, cf32_path):
        os.unlink(f)
    res = dict(phase="device_rtl_tcp", flow=" ".join(dev_argv), samples=CAPTURE,
               launches=launches["rtl_tcp"], bit_equal_to_cf32_run=True,
               vs_cu8_run_max=cu8_max, vs_cu8_run_rms=cu8_rms, channels_on_their_tone=on_tone,
               server_commands=want_log, **card)
    emit(res)
    check(cu8_max < U8_ERR, f"11a: rtl_tcp run vs the cu8 file run max {cu8_max}")
    check(on_tone == nch, f"11a: channels off their tone: {np.flatnonzero(peaks != j * (frames // 1024)).tolist()}")
    return res


def phase_device_synthetic(torch, dev, card, tmp) -> dict:
    """11b. --devname synthetic -s 2.56e6 -n 2^24 -c 64 DeNBFM on pfb_fused
    (K3) and eager: each run's files equal the --filename run of the
    synthetic samples saved as CF32 bit for bit; K3 against eager within
    PFB_MAX_ERR and RMS_ERR from frame 1 on the channels that carry the
    device's four tones (the other 60 hold noise alone, where atan2 of a
    near-zero sample makes any two float orders part)."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu_torch.io.sources import SyntheticSdrSource

    nch, n = 64, SYN_SAMPLES
    src = SyntheticSdrSource(2.56e6, 100e6, 0.0, total_samples=n)
    occupied = np.rint(np.array(src.tones) * nch + (nch - 1) / 2).astype(int)
    path = os.path.join(tmp, "synthetic.cf32")
    np.concatenate(list(src)).tofile(path)
    common = ["-n", str(n), "-c", str(nch), "--demod", f"DeNBFM {KF} F32", "--device", "cuda"]
    runs = {}
    for backend, kern in (("pfb_fused", "pfb_fm_fused"), ("eager", None)):
        got = {}
        for how, argv in (("device", ["--devname", "synthetic", "-s", "2.56e6"]),
                          ("file", ["--filename", path])):
            out = os.path.join(tmp, f"syn_{backend}_{how}")
            counts = cli_run(torch, cli_main, argv + common + ["--backend", backend, "-o", out])
            check_counts(counts, kern, f"11b {backend} {how} run")
            got[how] = read_channels(out, "f32", np.float32, nch, n // nch * 4)
            for k in range(nch):
                os.unlink(f"{out}_ch{k + 1}.f32")
            runs[backend, how] = dict(launches=counts)
        check(np.array_equal(got["device"], got["file"]),
              f"11b {backend}: the synthetic device run differs from its file run")
        runs[backend] = got["device"]
    os.unlink(path)
    occ_max, occ_rms = errors_np(runs["pfb_fused"][occupied, 1:], runs["eager"][occupied, 1:])
    all_max, _ = errors_np(runs["pfb_fused"][:, 1:], runs["eager"][:, 1:])
    res = dict(phase="device_synthetic", samples=n, channels=nch, occupied=occupied.tolist(),
               runs={f"{b} {h}": runs[b, h] for b in ("pfb_fused", "eager")
                     for h in ("device", "file")},
               k3_vs_eager_occupied_max=occ_max, k3_vs_eager_occupied_rms=occ_rms,
               k3_vs_eager_all_channels_max=all_max, bit_equal_to_file_runs=True, **card)
    emit(res)
    check(occ_max < PFB_MAX_ERR and occ_rms < RMS_ERR,
          f"11b: K3 vs eager on the occupied channels max {occ_max} rms {occ_rms}")
    return res


def phase_native(torch, card, tmp) -> dict:
    """11c. native_cf32_source against cf32_file_source on a 2^25-sample CF32
    file: the same bytes; NativeRawFileSink writes it back equal."""
    from csdr_tpu_torch.io import native
    from csdr_tpu_torch.io.sources import cf32_file_source

    native.load_lib()
    path = os.path.join(tmp, "native.cf32")
    data = np.random.default_rng(SEED + 1102).standard_normal(2 * CAPTURE, dtype=np.float32)
    data.tofile(path)
    readers = {"python": lambda: cf32_file_source(path, 1 << 18),
               "native": lambda: native.native_cf32_source(path, 1 << 18)}
    for name, read in readers.items():
        got = sum(len(c) for c in read())
        check(got == CAPTURE, f"11c: the {name} reader gave {got} samples")
    for a, b in zip(readers["python"](), readers["native"]()):
        check(a.tobytes() == b.tobytes(), "11c: the native reader's bytes differ")
    out = os.path.join(tmp, "native_out.cf32")
    with native.NativeRawFileSink(out) as sink:
        for c in native.native_cf32_source(path, 1 << 18):
            sink(c)
    check(np.array_equal(np.fromfile(out, np.float32), data), "11c: NativeRawFileSink round trip")
    for f in (path, out):
        os.unlink(f)
    res = dict(phase="native_io", samples=CAPTURE, bytes_equal=True, **card)
    emit(res)
    return res


def phase_tiles(torch, ff, dev, card) -> dict:
    """11d. K1 at every tileF of TILES at nch 64 on one cu8 2^23-sample
    block: a tile the wrapper's own checks refuse (ValueError) is recorded
    as infeasible; every other tile's output stays within MAX_ERR and
    RMS_ERR of the default tile's."""
    u8 = to_cu8(torch, occupied_band(torch, dev, 64, BLOCK, SEED + 1103))
    _, y_def = ff.flagship_fused_step(ff.flagship_fused_init(64, dev), u8, nch=64, kf=KF)
    errs, infeasible = {}, {}
    for t in TILES:
        try:
            _, y = ff.flagship_fused_step(ff.flagship_fused_init(64, dev), u8, nch=64, kf=KF,
                                          tileF=t)
        except ValueError as e:  # a tile the wrapper's checks refuse
            infeasible[t] = str(e)[:200]
            continue
        errs[t] = errors(y, y_def)
    res = dict(phase="tiles", kernel="flagship_fused", nch=64, input="cu8", n=BLOCK,
               default_tileF=ff.DEFAULT_TILE_F, vs_default={t: list(e) for t, e in errs.items()},
               infeasible=infeasible, **card)
    emit(res)
    check(ff.DEFAULT_TILE_F in errs, f"11d: the default tile {ff.DEFAULT_TILE_F} is refused")
    for t, (mx, rms) in errs.items():
        check(mx < MAX_ERR and rms < RMS_ERR, f"11d: tile {t} vs default max {mx} rms {rms}")
    return res


def phase_device(torch, ff, dev, card, tmp) -> dict:
    """Phase 11: 11a–11d."""
    return {"11a": timed("device_rtl", phase_device_rtl, torch, dev, card, tmp),
            "11b": timed("device_synthetic", phase_device_synthetic, torch, dev, card, tmp),
            "11c": timed("native", phase_native, torch, card, tmp),
            "11d": timed("tiles", phase_tiles, torch, ff, dev, card)}


MESH_MAX = 4                 # ranks of the mesh phase: min(cards, MESH_MAX)
MESH_BLOCKS = 2              # blocks of each ShardedChannelizedFM run


def mesh_rank(device, capture: str, agc_path: str, world: int) -> dict:
    """One NCCL rank of phase 7 (``parallel.spawn`` runs it on every card;
    every collective below is called by every rank in the same order).

    7a. ShardedFlagship on mesh (world, 1), force_full at one rank: the
        main-path capture through ShardedPipeline with every kernel count set
        to 0 just before and read just after; rank 0 holds the audio and
        the carried state against the serial K1 (FlagshipFused) on the same
        card; then 5 sharded steps on every rank of its segment of one
        device-resident block, K1's launches counted over them.
    7b. ShardedChannelizedFM on mesh (world, 1) and, at 4 ranks, (2, 2):
        eager, use_fused (K3) and use_fused with -a (K4), MESH_BLOCKS
        blocks each, held on rank 0 against the eager single-device graphs."""
    import torch
    import torch.distributed as dist

    import csdr_tpu_torch as ct
    from csdr_tpu_torch.ops.cuda import flagship_fused as ff
    from csdr_tpu_torch.parallel import (ShardedChannelizedFM, ShardedFlagship,
                                         ShardedPipeline, build_mesh)

    rank, nch = dist.get_rank(), 64
    out = dict(rank=rank, device=str(device))

    def sharded_run(sh, path, n):
        """The sharded receiver over the first n samples of a capture
        through ShardedPipeline.stream; rank 0 returns the audio; every rank
        its kernel counts of the run."""
        sink = ct.CollectSink() if rank == 0 else None
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        pipe = ShardedPipeline(sh)
        for out in pipe.stream(ct.cu8_file_source(path, BLOCK) if rank == 0 else None, n):
            if out is not None:
                sink(out)
        torch.cuda.synchronize()
        counts = read_counts()
        audio = sink.concat() if sink else None
        return audio, pipe.state, counts, 0 if audio is None else audio.shape[1]

    # 7a. ShardedFlagship over the main-path capture
    mesh = build_mesh(world, 1, device.type)
    sf = ShardedFlagship(mesh, nch=nch, block_size=BLOCK, kf=KF, force_full=world == 1)
    audio, state, counts, total = sharded_run(sf, capture, CAPTURE)
    flag = dict(mesh=[world, 1], force_full=world == 1, launches=counts)
    if rank == 0:
        from csdr_tpu_torch.blocks.fused_blocks import FlagshipFused

        pipe = ct.Pipeline(FlagshipFused(nch, KF), block_size=BLOCK, device=device)
        serial = ct.CollectSink()
        pipe.run(ct.cu8_file_source(capture, BLOCK), serial)
        want = serial.concat()
        d = np.abs(audio.astype(np.float64) - want)
        flag.update(total=total, shape=list(audio.shape), finite=bool(np.isfinite(audio).all()),
                    share_over_0_01=float(np.mean(d > 0.01)), q99=float(np.quantile(d, 0.99)),
                    max_abs_err=float(d.max()),
                    state_err={k: float((state[k] - pipe.state[k]).abs().max())
                               for k in ("hist", "x_last", "y_dc_last", "phase")})
        del audio, want, d, serial, pipe
    # 5 sharded steps, every rank stepping its segment of one device-resident
    # block: one K1 launch a step
    seg = to_cu8(torch, occupied_band(torch, device, nch, BLOCK, SEED + 1)).view(BLOCK, 2)
    seg = seg[rank * (BLOCK // world):][:BLOCK // world].contiguous()
    st = sf.init()
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    for _ in range(5):
        st, _ = sf.step(st, seg)
    torch.cuda.synchronize()
    flag["k1_launches_per_step"] = ff.launches / 5
    del seg, st
    out["flagship"] = flag

    # 7b. ShardedChannelizedFM, eager / K3 / K4 + AGC
    n = MESH_BLOCKS * BLOCK
    refs = {}
    if rank == 0:
        u8_iq = ct.u8_to_iq()
        for label, graph, path in (
                ("plain", ct.channelized_fm_receiver(nch, kf=KF, backend="eager"), capture),
                ("agc", ct.channelized_receiver(nch, ct.fm_demodulator(KF),
                                                agc_threshold_db=AGC_T), agc_path)):
            sink = ct.CollectSink()
            ct.Pipeline(ct.chain(u8_iq, graph), block_size=BLOCK, device=device).run(
                ct.take_n(ct.cu8_file_source(path, BLOCK), n), sink)
            refs[label] = sink.concat()
    shapes = [(world, 1)] + ([(2, world // 2)] if world == 4 else [])
    out["channelized"] = []
    for shape in shapes:
        cmesh = build_mesh(*shape, device.type)
        for label, kw, path, ref, bound, f0 in (
                ("eager", {}, capture, "plain", 2e-3, 0),
                ("pfb_fused", {"use_fused": True}, capture, "plain", 5e-3, 1),
                ("pfb_fused -a", {"use_fused": True, "agc_threshold_db": AGC_T}, agc_path,
                 "agc", 5e-3, 0)):
            sh = ShardedChannelizedFM(cmesh, nch=nch, block_size=BLOCK, kf=KF, **kw)
            audio, _, counts, total = sharded_run(sh, path, n)
            r = dict(mesh=list(shape), backend=label, launches=counts, blocks=MESH_BLOCKS,
                     bound=bound, from_frame=f0)
            if rank == 0:
                want = refs[ref]
                r.update(total=total, shape=list(audio.shape),
                         finite=bool(np.isfinite(audio).all()),
                         vs_eager_rel=float(np.abs(audio[:, f0:].astype(np.float64)
                                                   - want[:, f0:]).max()
                                            / np.abs(want).max()))
                if ref == "agc":
                    r["empty_all_zero"] = bool(not audio[1::2].any())
            out["channelized"].append(r)
    dist.barrier()
    return out


def phase_mesh(torch, card, tmp, capture, agc_path, fused_cli) -> dict:
    """7. The multi-device mesh on NCCL, world = min(cards, MESH_MAX): the
    library paths of 7a/7b in ``mesh_rank`` (every rank's kernel counts from
    0), then 7c, the CLI's -c 64 --mesh Wx1 --backend fused in a process of
    its own (it starts its own ranks; -v prints its rate and each rank's
    kernel launches), each channel's file against phase 4's fused run."""
    from csdr_tpu_torch.parallel import spawn

    world = min(torch.cuda.device_count(), MESH_MAX)
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    ranks = spawn(mesh_rank, world, "cuda", args=(capture, agc_path, world), timeout=600.0)
    r0 = ranks[0]
    flag = r0["flagship"]
    emit(dict(phase="mesh", part="flagship", world=world, nccl=nccl,
              launches_per_rank=[r["flagship"]["launches"] for r in ranks],
              **{k: v for k, v in flag.items() if k != "launches"}, **card))
    check(flag["finite"] and flag["shape"] == [64, CAPTURE // 64] and flag["total"] == CAPTURE // 64,
          f"mesh flagship: shape {flag['shape']}, total {flag['total']}")
    check(flag["share_over_0_01"] < 0.005 and flag["q99"] < 1e-4,
          f"mesh flagship vs serial K1: share {flag['share_over_0_01']}, q99 {flag['q99']}")
    check(max(flag["state_err"].values()) < 2e-5, f"mesh flagship state: {flag['state_err']}")
    for r in ranks:
        check_counts(r["flagship"]["launches"], "flagship_fused",
                     f"mesh flagship run on rank {r['rank']}")
        check(r["flagship"]["k1_launches_per_step"] == 1,
              f"mesh flagship steps on rank {r['rank']}: "
              f"{r['flagship']['k1_launches_per_step']} K1 launches per step")
    want_k = {"eager": None, "pfb_fused": "pfb_fm_fused", "pfb_fused -a": "pfb_channelize_fused"}
    channelized = []
    for i, c in enumerate(r0["channelized"]):
        per_rank = [r["channelized"][i]["launches"] for r in ranks]
        emit(dict(phase="mesh", part="channelized", world=world,
                  launches_per_rank=per_rank, **{k: v for k, v in c.items() if k != "launches"},
                  **card))
        what = f"mesh {c['mesh']} {c['backend']}"
        check(c["finite"] and c["shape"] == [64, MESH_BLOCKS * BLOCK // 64], f"{what}: output")
        check(c["vs_eager_rel"] < c["bound"], f"{what}: rel {c['vs_eager_rel']} vs eager")
        if "empty_all_zero" in c:
            check(c["empty_all_zero"], f"{what}: an empty channel passed the squelch")
        for counts in per_rank:
            check_counts(counts, want_k[c["backend"]], what)
        channelized.append(dict(c, launches_per_rank=per_rank))

    # 7c. the CLI
    prefix = os.path.join(tmp, "mesh")
    argv = [sys.executable, "-m", "csdr_tpu_torch.apps.soapy_sdr_cli", "--filename", capture,
            "-n", str(CAPTURE), "-c", "64", "--mesh", f"{world}x1", "--backend", "fused",
            "--demod", f"DeNBFM {KF} F32", "--device", "cuda", "--blocksize", str(BLOCK),
            "-v", "-o", prefix]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=HERE)
    check(r.returncode == 0, f"CLI --mesh: exit code {r.returncode}: {r.stderr.strip()[-2000:]}")
    m = re.search(r"\(([\d.]+) MSPS\)", r.stdout)
    cli_counts = [json.loads(c) for c in re.findall(r"Kernel launches on rank \d+: (\{[^}]*\})",
                                                    r.stdout)]
    check(m is not None and len(cli_counts) == world, f"CLI --mesh output: {r.stdout[-2000:]}")
    for counts in cli_counts:
        check_counts(counts, "flagship_fused", "CLI --mesh")
    audio = read_channels(prefix, "f32", np.float32, 64, CAPTURE // 64 * 4).astype(np.float64)
    d = np.abs(audio - fused_cli)
    cli = dict(launches_per_rank=cli_counts,
               vs_serial_cli_max=float(d.max()), share_over_0_01=float(np.mean(d > 0.01)),
               q99=float(np.quantile(d, 0.99)), bit_equal=bool(np.array_equal(audio, fused_cli)))
    emit(dict(phase="mesh", part="cli", world=world, flow=f"-c 64 --mesh {world}x1 --backend fused",
              samples=CAPTURE, **cli, **card))
    check(cli["share_over_0_01"] < 0.005 and cli["q99"] < 1e-4,
          f"CLI --mesh vs the serial CLI: share {cli['share_over_0_01']}, q99 {cli['q99']}")
    return dict(world=world, nccl=nccl, flagship=flag, channelized=channelized, cli=cli,
                flagship_launches_per_rank=[r["flagship"]["launches"] for r in ranks])


CHAIN_MAX = 4                # ranks of the sharded-chain phase: min(cards, CHAIN_MAX)
# 12b's block: the 48 kHz stream's 629,145 samples in 5 blocks, every
# rank's segment (32,768 samples at 4 ranks) holding data and covering
# the CW filter's 700-sample halo
CHAIN_CLI_BLOCK = 1 << 17
CHAIN_REL_ERR = 2e-3         # tests/test_sharding_generic.py:60


def chain_graphs(ct) -> dict:
    """Phase 12's library graphs on cu8 rows: the -c 1 -b 48000 "DeCW 500
    700" design (dc_blocker >> cw_demodulator, its 701-tap low-pass on K5)
    and the -b 200000 "DeWBFM 8" one, each behind u8_to_iq as the CLI puts
    it on a cu8 file with no front end; with their bounds against serial."""
    return {"DeCW": (ct.chain(ct.u8_to_iq(), ct.dc_blocker(),
                              ct.cw_demodulator(CW_BW / 48000.0, CW_PITCH / 48000.0)),
                     K5_REL_ERR, "fir_valid"),
            "DeWBFM": (ct.chain(ct.u8_to_iq(), ct.dc_blocker(), ct.wbfm_demodulator(FM_BW, 8)),
                       CHAIN_REL_ERR, None)}


def channel_graphs(ct) -> dict:
    """Phase 12c's library graphs in the channel layout, behind u8_to_iq as
    the CLI puts it on a cu8 file: the -c 64 "DeCW 500 700" design
    (dc_blocker >> firpfbch_channelizer(64) >> PerChannel(cw_demodulator),
    its 585-tap low-pass on K5 in every channel) on phase 4's capture, and
    the -c 16 -m DeNBFM mixed monitor (>> PerChannel(fm_demodulator) >>
    MixChannels) on a 16-channel capture (on phase 4's 64 carriers a
    16-channel FM demod would sit on four carriers per channel, its phase
    steps at atan2's branch cut, where two right float orders differ by
    2π); with their bounds against serial, their kernel and capture."""
    rate = 2.56e6 / 64
    return {"-c 64 DeCW": (ct.chain(ct.u8_to_iq(), ct.dc_blocker(), ct.firpfbch_channelizer(64),
                                    ct.PerChannel(ct.cw_demodulator(CW_BW / rate,
                                                                    CW_PITCH / rate), 64)),
                           K5_REL_ERR, "fir_valid", "capture"),
            "-c 16 -m DeNBFM": (ct.chain(ct.u8_to_iq(), ct.dc_blocker(),
                                         ct.firpfbch_channelizer(MIX_NCH),
                                         ct.PerChannel(ct.fm_demodulator(KF), MIX_NCH),
                                         ct.MixChannels()),
                                CHAIN_REL_ERR, None, "mix")}


def mix_capture(torch, dev, tmp) -> str:
    """A 2^25-sample cu8 capture with an FM carrier on each of 16 channel
    centres (6c's kind), written to ``tmp``."""
    j = 5 + 3 * (np.arange(MIX_NCH) % 7)
    path = os.path.join(tmp, "chain_mix.cu8")
    to_cu8(torch, occupied_band(torch, dev, MIX_NCH, CAPTURE, SEED + 1200,
                                tones=j / 1024.0 / MIX_NCH)).cpu().numpy().tofile(path)
    return path


def channel_layout_rank(torch, ct, device, world: int, captures: dict) -> dict:
    """12c on one NCCL rank, on (W, 1) and, on four cards, (2, 2), for each
    graph of ``channel_graphs`` (every rank calls every collective in the
    same order): the ShardedChain over the 2^25-sample capture through
    ShardedPipeline twice (the second run on the same communicators) with
    every kernel count set to 0 just before each run and read just after;
    rank 0 holds the output against the serial port Pipeline of the same
    graph on its card."""
    import torch.distributed as dist

    from csdr_tpu_torch.parallel import ShardedChain, ShardedPipeline, build_mesh

    rank = dist.get_rank()
    out, serial_out = {}, {}
    for shape in [(world, 1)] + ([(2, 2)] if world == 4 else []):
        dt, dc = shape
        mesh = build_mesh(dt, dc, device.type)
        for label, (graph, bound_rel, kernel, cap) in channel_graphs(ct).items():
            nch = graph.blocks[2].nch
            sh = ShardedChain(graph, mesh, BLOCK)
            r = dict(mesh=list(shape), bound=bound_rel, kernel=kernel, nch=nch,
                     blocks=CAPTURE // BLOCK, panel_per_rank=[nch // dc, BLOCK // dt // nch])
            if kernel:
                taps = len(graph.blocks[3].inner.blocks[0].taps)
                r.update(taps=taps, k5_shape_per_rank=(
                    f"({nch // dc}, {BLOCK // dt // nch + taps - 1}) complex64 x {taps} "
                    f"real taps"))
            runs = []
            for _ in range(2):
                sink = ct.CollectSink() if rank == 0 else None
                torch.cuda.synchronize()
                dist.barrier()
                reset_counts()
                total = ShardedPipeline(sh).run(
                    ct.cu8_file_source(captures[cap], BLOCK) if rank == 0 else None, sink)
                torch.cuda.synchronize()
                runs.append((read_counts(), sink))
            (counts, _), (second_counts, sink) = runs
            r.update(launches=counts, second_launches=second_counts)
            del runs
            if rank == 0:
                got = sink.concat()
                if label not in serial_out:
                    serial = ct.CollectSink()
                    ct.Pipeline(graph, block_size=BLOCK, device=device).run(
                        ct.cu8_file_source(captures[cap], BLOCK), serial)
                    serial_out[label] = serial.concat()
                want = serial_out[label]
                r.update(total=total, shape=list(got.shape), want_shape=list(want.shape),
                         finite=bool(np.isfinite(got).all()),
                         vs_serial_rel=float(np.abs(got.astype(np.float64) - want).max()
                                             / np.abs(want).max()))
                del got, want
            del sink
            dist.barrier()
            out[f"{label} {dt}x{dc}"] = r
    return out


def chain_rank(device, capture: str, world: int, mix_path: str, specs: list) -> dict:
    """One NCCL rank of phases 12a, 12c and 12e (``parallel.spawn`` runs it
    on every card; every collective below is called by every rank in the
    same order).  12c, the channel layout, is ``channel_layout_rank`` (its
    mixed monitor reads ``mix_path``); 12e, the stereo, RDS, packet and
    sync graphs, is ``flow_rank`` over ``specs``.

    For each graph of ``chain_graphs``: the ShardedChain on mesh (world, 1)
    over phase 4's capture through ShardedPipeline, twice (the second run
    on the same communicators), with every kernel count set to 0 just
    before each run and read just after, rank 0 holding its output against
    the serial port Pipeline of the same graph on its card."""
    import torch
    import torch.distributed as dist

    import csdr_tpu_torch as ct
    from csdr_tpu_torch.parallel import ShardedChain, ShardedPipeline, build_mesh

    rank = dist.get_rank()
    mesh = build_mesh(world, 1, device.type)
    out = dict(rank=rank, device=str(device))
    for label, (graph, bound_rel, kernel) in chain_graphs(ct).items():
        sh = ShardedChain(graph, mesh, BLOCK)
        r = dict(blocks=CAPTURE // BLOCK, bound=bound_rel, kernel=kernel,
                 taps=len(graph.blocks[2].taps) if label == "DeCW" else None)
        runs = []
        for _ in range(2):
            sink = ct.CollectSink() if rank == 0 else None
            torch.cuda.synchronize()
            dist.barrier()
            reset_counts()
            total = ShardedPipeline(sh).run(
                ct.cu8_file_source(capture, BLOCK) if rank == 0 else None, sink)
            torch.cuda.synchronize()
            runs.append((read_counts(), sink))
        (counts, _), (second_counts, sink) = runs
        r.update(launches=counts, second_launches=second_counts)
        del runs
        if rank == 0:
            got = sink.concat()
            serial = ct.CollectSink()
            ct.Pipeline(graph, block_size=BLOCK, device=device).run(
                ct.cu8_file_source(capture, BLOCK), serial)
            want = serial.concat()
            r.update(total=total, shape=list(got.shape), want_shape=list(want.shape),
                     finite=bool(np.isfinite(got).all()),
                     vs_serial_rel=float(np.abs(got.astype(np.float64) - want).max()
                                         / np.abs(want).max()))
            del got, want, serial
        dist.barrier()
        out[label] = r
    out["channels"] = channel_layout_rank(torch, ct, device, world,
                                          {"capture": capture, "mix": mix_path})
    out["flows"] = flow_rank(torch, ct, device, world, specs)
    return out


# ---- 12e/12f: the stereo, RDS, packet and symbol-sync graphs on the mesh -------

FLOW_SAMPLES = 1 << 23       # 12e's packet captures at PKT_FS: ~210 k samples at 48 kHz
FLOW_BLOCK = 1 << 16         # 12e's blocks at 48 kHz (several per capture)
FLOW_RTTY_TEXT = "RYRY DE N0CALL 599"   # fits FLOW_SAMPLES (RTTY_TEXT needs ~32 M)
FMS_DECIM = 8


def round_block(n: int, quantum: int) -> int:
    """The largest multiple of ``quantum`` not above n (at least one)."""
    return max(n // quantum, 1) * quantum


def flow_graph(ct, label: str):
    """12e's graphs, each as the CLI composes it behind its front end: the
    DeFMS --rds Tee (its 333-tap RDS data filter on K5), the AIS, APRS and
    RTTY receivers (RTTY's two 1,056-tap tone filters on K5), -c 1
    DeNBFMSync 12 at 48 kHz and the -c 64 DeNBFMSync 10 channel graph
    behind the cu8 reader."""
    from csdr_tpu_torch.apps import soapy_sdr_cli as cli
    from csdr_tpu_torch.models.symsync import fm_dem_with_sync

    if label == "DeFMS --rds":
        return fms_graph(FMS_DECIM)[0]
    if label in PACKET_DEMOD:
        return cli._packet_graph(cli.parse_demod(PACKET_DEMOD[label]), [], 48000.0)
    if label == "-c 1 DeNBFMSync":
        return ct.chain(ct.dc_blocker(), fm_dem_with_sync(SYNC_FE_K))
    return sync_graph(ct, "eager")


def front_end_cf32(ct, dev, path: str, fs: float, offset: float, bw: float, out: str):
    """A cu8 capture through the CLI's front end (``--offset``, ``-b``) on
    its own Pipeline on ``dev``, written as CF32 to ``out``: (out, samples)."""
    g = ct.chain(ct.u8_to_iq(), *ct.front_end(fs, offset, bw))
    sink = ct.CollectSink()
    ct.Pipeline(g, block_size=round_block(BLOCK, g.granule), device=dev).run(
        ct.cu8_file_source(path, BLOCK), sink)
    y = sink.concat()
    y.astype(np.complex64).tofile(out)
    return out, len(y)


def flow_specs(torch, ct, dev, tmp, world: int) -> list[dict]:
    """12e's cases and their inputs, made as phases 6, 8 and 9 make theirs:
    the stereo capture (6b) and the helicopter capture (9) at 2^25 samples,
    the AIS, APRS and RTTY captures (8) at FLOW_SAMPLES.  A graph behind a
    front end reads that front end's output, run once here on the card and
    written as CF32 (the CLI runs it on rank 0's own Pipeline); the -c 64
    sync reads the cu8 file.  Each block is a multiple of 4 · the graph's
    granule (and for the sync of its 8 timing windows), so every mesh and
    the serial reference step the same blocks."""
    from csdr_tpu_torch.apps import soapy_sdr_cli as cli

    def front(path, fs, offset, bw, name):
        return front_end_cf32(ct, dev, path, fs, offset, bw, os.path.join(tmp, f"{name}.cf32"))

    specs = []
    stereo = os.path.join(tmp, "flow_stereo.cu8")
    stereo_capture(torch, dev, CAPTURE, SEED + 500).cpu().numpy().tofile(stereo)
    fe, n = front(stereo, 2.56e6, 0.0, FM_BW, "flow_stereo_fe")
    g = flow_graph(ct, "DeFMS --rds")
    specs.append(dict(label="DeFMS --rds", path=fe, wire="cf32", samples=n, rate=FM_BW,
                      block=round_block(1 << 20, 4 * g.granule), bound=K5_REL_ERR,
                      kernel="fir_valid", per_block=1, cu8=stereo,
                      meshes=[[world, 1]]))
    for i, kind in enumerate(("DeAIS", "DeAPRS", "DeRTTY")):
        make = {"DeAIS": lambda n, s: ais_capture(ct, n, s), "DeAPRS": aprs_capture,
                "DeRTTY": lambda n, s: rtty_capture(n, s, FLOW_RTTY_TEXT)}[kind]
        x, msgs = make(FLOW_SAMPLES, SEED + 1210 + 10 * i)
        path = os.path.join(tmp, f"flow_{kind}.cu8")
        write_cu8(path, x)
        del x
        extra = packet_flows(ct)[kind][2]
        offset = float(extra[extra.index("--offset") + 1])
        fe, n = front(path, PKT_FS, offset, 48000.0, f"flow_{kind}_fe")
        g = flow_graph(ct, kind)
        rtty = kind == "DeRTTY"
        specs.append(dict(label=kind, path=fe, wire="cf32", samples=n, rate=48000.0,
                          block=round_block(FLOW_BLOCK, 4 * g.granule),
                          bound=K5_REL_ERR if rtty else CHAIN_REL_ERR,
                          kernel="fir_valid" if rtty else None, per_block=2 if rtty else 0,
                          cu8=path, want=cli.packet_lines(kind, msgs), extra=extra,
                          meshes=[[world, 1]]))
    heli = os.path.join(tmp, "flow_heli.cu8")
    x, texts, _ = sync_capture(torch, dev, CAPTURE, SEED + 1000)
    to_cu8(torch, x).cpu().numpy().tofile(heli)
    del x
    ch = SYNC_CHANNELS[2]
    offset = (ch - (SYNC_NCH - 1) / 2) / SYNC_NCH * 2.56e6
    fe, n = front(heli, 2.56e6, offset, float(SYNC_FE_RATE), "flow_heli_fe")
    g = flow_graph(ct, "-c 1 DeNBFMSync")
    specs.append(dict(label="-c 1 DeNBFMSync", path=fe, wire="cf32", samples=n,
                      rate=float(SYNC_FE_RATE), block=round_block(FLOW_BLOCK, 4 * 8 * g.granule),
                      bound=SYNC_TOL, kernel="symsync_block", per_block=2, sync=True,
                      channels=[0],
                      meshes=[[world, 1]]))
    g = flow_graph(ct, "-c 64 DeNBFMSync")
    specs.append(dict(label="-c 64 DeNBFMSync", path=heli, wire="cu8", samples=CAPTURE,
                      rate=2.56e6, block=round_block(BLOCK, 4 * 8 * g.granule),
                      bound=SYNC_TOL, kernel="symsync_block", per_block=2, sync=True,
                      channels=list(SYNC_CHANNELS), texts=texts,
                      meshes=[[world, 1]] + ([[2, 2]] if world == 4 else [])))
    emit(dict(phase="chain", part="flow_captures",
              cases={s["label"]: dict(samples=s["samples"], block=s["block"],
                                      rate=s["rate"]) for s in specs}))
    return specs


def flow_serial(torch, ct, device, spec) -> dict:
    """The serial port Pipeline of a 12e graph over its input on this card,
    at the spec's block: the collected output (and for the sync the other
    picks of ``record_ties``) and kernel launches."""

    graph = flow_graph(ct, spec["label"])
    src = (ct.cu8_file_source if spec["wire"] == "cu8" else ct.cf32_file_source)(
        spec["path"], spec["block"])
    sink = ct.CollectSink()
    torch.cuda.synchronize()
    reset_counts()
    with record_ties(SYNC_TIE) as rec:
        ct.Pipeline(graph, block_size=spec["block"], device=device).run(src, sink)
    torch.cuda.synchronize()
    out = dict(launches=read_counts(), y=sink.concat())
    if rec:
        out["codes"], out["other"] = (np.concatenate([r[i] for r in rec], axis=-1)
                                      for i in (0, 1))
    return out


def flow_compare(spec, got, want: dict) -> dict:
    """A 12e output against the serial one: bits equal, the float leaves'
    error relative to their largest sample, the sync by ``sync_close`` on
    its channels' full blocks (the last, zero-padded block apart), and the
    decoded messages (RDS fields, packet lines) equal."""
    from csdr_tpu_torch.apps import soapy_sdr_cli as cli
    from csdr_tpu_torch.models import rds

    w = want["y"]
    got_l = list(got) if isinstance(got, tuple) else [got]
    want_l = list(w) if isinstance(w, tuple) else [w]
    r = dict(shape=[list(a.shape) for a in got_l], want_shape=[list(a.shape) for a in want_l],
             finite=bool(all(np.isfinite(a).all() for a in got_l)))
    if r["shape"] != r["want_shape"]:
        return r
    if spec.get("sync"):
        got2, want2 = np.atleast_2d(got_l[0]), np.atleast_2d(want_l[0])
        other, codes = np.atleast_2d(want["other"]), np.atleast_2d(want["codes"])
        per = spec["block"] // (64 if spec["wire"] == "cu8" else 1) // (
            SYNC_K if spec["wire"] == "cu8" else SYNC_FE_K) * 2
        full = spec["samples"] // spec["block"] * per
        r["vs_serial"] = sync_agree([sync_close(got2[c][:full], want2[c][:full],
                                                (codes[c][:full], other[c][:full]))
                                     for c in spec["channels"]])
        r["vs_serial_padded_block"] = float(max(
            np.abs(got2[c][full:] - want2[c][full:]).max(initial=0.0)
            / np.abs(want2[c]).max() for c in spec["channels"]))
        r["ok"] = r["finite"] and r["vs_serial"][0] < SYNC_TOL
        return r
    errs = []
    for a, b in zip(got_l, want_l):
        if a.dtype == np.uint8:
            errs.append(0.0 if np.array_equal(a, b) else float("inf"))
        else:
            errs.append(float(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max()))
    r["vs_serial_rel"] = errs
    r["ok"] = r["finite"] and max(errs) < spec["bound"]
    if spec["label"] == "DeFMS --rds":
        r["rds"], r["rds_serial"] = rds.decode_groups(got_l[1]), rds.decode_groups(want_l[1])
        r["ok"] = r["ok"] and r["rds"] == r["rds_serial"] and r["rds"]["ps"] == RDS_PS
    elif spec["label"] in PACKET_DEMOD:
        demod = cli.parse_demod(PACKET_DEMOD[spec["label"]])
        lines = cli.packet_lines(demod[0], cli.packet_messages(demod, got_l[0], spec["rate"]))
        r.update(messages=len(lines), injected=len(spec["want"]),
                 equal_to_injected=lines == spec["want"])
        r["ok"] = r["ok"] and r["equal_to_injected"]
    return r


def flow_rank(torch, ct, device, world: int, specs: list) -> dict:
    """12e on one NCCL rank: for each case of ``flow_specs`` and mesh, the
    ShardedChain over the case's input through ShardedPipeline with every
    kernel count set to 0 just before and read just after; rank 0 holds
    the output against the serial port Pipeline at the same block
    (``flow_serial``, once per case) by ``flow_compare``."""
    import torch.distributed as dist

    from csdr_tpu_torch.parallel import ShardedChain, ShardedPipeline, build_mesh

    rank = dist.get_rank()
    out, serial = {}, {}
    for spec in specs:
        block, label = spec["block"], spec["label"]
        source = ct.cu8_file_source if spec["wire"] == "cu8" else ct.cf32_file_source
        first = next(iter(source(spec["path"], block)))
        check(len(first) == block, f"12e {label}: input shorter than one block")
        for dt, dc in spec["meshes"]:
            if dt * dc > world:
                continue
            mesh = build_mesh(dt, dc, device.type)
            graph = flow_graph(ct, label)
            sh = ShardedChain(graph, mesh, block)
            r = dict(mesh=[dt, dc], block=block, nloc=block // dt,
                     blocks=-(-(spec["samples"] + graph.flush_len()) // block))
            if rank == 0 and label not in serial:
                serial[label] = flow_serial(torch, ct, device, spec)
            sink = ct.CollectSink() if rank == 0 else None
            torch.cuda.synchronize()
            dist.barrier()
            reset_counts()
            total = ShardedPipeline(sh).run(source(spec["path"], block) if rank == 0 else None,
                                            sink)
            torch.cuda.synchronize()
            r.update(launches=read_counts(), total=total)
            if rank == 0:
                want = serial[label]
                r.update(flow_compare(spec, sink.concat(), want),
                         serial_launches=want["launches"])
            del sink, sh
            dist.barrier()
            out[f"{label} {dt}x{dc}"] = r
    return out


def phase_chain_flows(torch, card, tmp, world: int, specs: list, ranks: list) -> dict:
    """12e, the ranks' results of ``flow_rank`` checked, each against the
    serial Pipeline; 12f, the CLI's --mesh Wx1 DeFMS 8 --rds, DeAIS and -c 64
    DeNBFMSync 10, each mesh run in a process of its own, against the serial
    CLI's files (the WAV within K5's 1e-4 and .rds.txt equal; .ais.txt equal
    and every injected message; the 64 .f32 files within the sync rule on
    full blocks, helidecode's coordinates equal).  Deletes 12e's inputs."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main

    thru = r"Throughput: \d+ samples into the flow in ([\d.]+) s"
    res = {"flows": {}}
    # 12e. the stereo, RDS, packet and sync graphs through the library
    for key, r0 in ranks[0]["flows"].items():
        spec = next(sp for sp in specs if key.startswith(sp["label"] + " "))
        per_rank = [r["flows"][key]["launches"] for r in ranks]
        emit(dict(phase="chain", part="flow_library", flow=key, world=world,
                  samples=spec["samples"], rate=spec["rate"], launches_per_rank=per_rank,
                  **{k: v for k, v in r0.items() if not k.endswith("launches")}, **card))
        what = f"sharded flow {key}"
        seen = {k: r0.get(k) for k in ("shape", "want_shape", "finite", "vs_serial_rel",
                                       "vs_serial", "rds", "rds_serial", "messages",
                                       "injected")}
        check(r0.get("ok", False), f"{what}: {seen}")
        kernel, want_n = spec["kernel"], spec["per_block"] * r0["blocks"]
        for counts in per_rank + [r0["serial_launches"]]:
            check_counts(counts, kernel, what)
            if kernel:
                check(counts[kernel] == want_n,
                      f"{what}: {counts[kernel]} {kernel} launches, want {want_n}")
        res["flows"][key] = dict(r0, launches_per_rank=per_rank)

    # 12f. three CLI runs over the mesh against the serial CLI's files, each
    # mesh run in a process of its own
    res["flow_cli"] = {}
    by = {sp["label"]: sp for sp in specs}
    fms, ais_sp, heli = by["DeFMS --rds"], by["DeAIS"], by["-c 64 DeNBFMSync"]
    cases = [
        ("DeFMS --rds", CAPTURE, ["--filename", fms["cu8"], "-b", str(int(FM_BW)),
                                  "-n", str(fms["samples"]), "--demod", f"DeFMS {FMS_DECIM} WAV",
                                  "--rds", "--blocksize", str(fms["block"])], "fir_valid"),
        ("DeAIS", FLOW_SAMPLES, ["--filename", ais_sp["cu8"], "-s", str(PKT_FS), *ais_sp["extra"],
                   "-n", str(ais_sp["samples"]), "--demod", "DeAIS",
                   "--blocksize", str(ais_sp["block"])], None),
        ("-c 64 DeNBFMSync", CAPTURE, ["--filename", heli["path"], "-n", str(CAPTURE),
                                       "-c", str(SYNC_NCH), "--demod", f"DeNBFMSync {SYNC_K}",
                                       "--backend", "eager", "--blocksize", str(heli["block"])],
         "symsync_block")]
    for label, samples_in, common, kernel in cases:
        prefix = {k: os.path.join(tmp, f"flow_cli_{k}") for k in ("serial", "mesh")}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), record_ties(SYNC_TIE) as rec:
            serial_counts = cli_run(torch, cli_main, common + [
                "-o", prefix["serial"], "--device", "cuda", "-v"])
        m = re.search(thru, buf.getvalue())
        check(m is not None, f"serial CLI {label} output: {buf.getvalue()[-2000:]}")
        check_counts(serial_counts, kernel, f"serial CLI {label}")
        mesh = f"{world}x1"
        argv = [sys.executable, "-m", "csdr_tpu_torch.apps.soapy_sdr_cli", *common,
                "--mesh", mesh, "--device", "cuda", "-v", "-o", prefix["mesh"]]
        r = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=HERE)
        what = f"CLI {label} --mesh {mesh}"
        check(r.returncode == 0, f"{what}: exit code {r.returncode}: {r.stderr.strip()[-2000:]}")
        mm = re.search(thru, r.stdout)
        cli_counts = [json.loads(c) for c in re.findall(
            r"Kernel launches on rank \d+: (\{[^}]*\})", r.stdout)]
        check(mm is not None and len(cli_counts) == world and "ShardedChain" in r.stdout,
              f"{what} output: {r.stdout[-2000:]}")
        for counts in cli_counts:
            check_counts(counts, kernel, what)
            if kernel:
                check(counts[kernel] == serial_counts[kernel],
                      f"{what}: {counts[kernel]} {kernel} launches, the serial CLI "
                      f"{serial_counts[kernel]}")
        c = dict(samples_in=samples_in, launches_per_rank=cli_counts,
                 serial_launches=serial_counts)
        if label == "DeFMS --rds":
            got, want = (np.fromfile(prefix[k] + ".wav", "<f4", offset=44) for k in prefix)
            txt = {k: open(prefix[k] + ".rds.txt").read() for k in prefix}
            c.update(samples=int(got.size), vs_serial_cli_rel=float(
                np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
                if got.shape == want.shape else float("inf"),
                finite=bool(np.isfinite(got).all()), rds_txt_equal=txt["mesh"] == txt["serial"],
                rds=txt["mesh"])
            ok = (c["finite"] and c["vs_serial_cli_rel"] < K5_REL_ERR and c["rds_txt_equal"]
                  and f"PS: {RDS_PS}" in txt["mesh"])
            for k in prefix:
                for ext in (".wav", ".rds.txt"):
                    os.unlink(prefix[k] + ext)
        elif label == "DeAIS":
            txt = {k: open(prefix[k] + ".ais.txt").read() for k in prefix}
            lines = txt["mesh"].splitlines()
            c.update(txt_equal=txt["mesh"] == txt["serial"], messages=len(lines),
                     injected=len(ais_sp["want"]))
            ok = c["txt_equal"] and lines == ais_sp["want"]
            for k in prefix:
                os.unlink(prefix[k] + ".ais.txt")
        else:
            nout = CAPTURE * 2 // (SYNC_NCH * SYNC_K)
            full = CAPTURE // heli["block"] * (heli["block"] * 2 // (SYNC_NCH * SYNC_K))
            codes, other = (np.concatenate([x[i] for x in rec], axis=-1) for i in (0, 1))
            chans = {k: read_channels(prefix[k], "f32", np.float32, SYNC_NCH, 4 * nout)
                     for k in prefix}
            occ = list(SYNC_CHANNELS)
            c["vs_serial_cli"] = sync_agree([sync_close(
                chans["mesh"][ch][:full], chans["serial"][ch][:full],
                (codes[ch][:full], other[ch][:full])) for ch in occ])
            c["vs_serial_cli_padded_block"] = float(max(
                np.abs(chans["mesh"][ch][full:] - chans["serial"][ch][full:]).max(initial=0.0)
                / np.abs(chans["serial"][ch]).max() for ch in occ))
            coords = {k: {ch: heli_decode(f"{prefix[k]}_ch{ch + 1}.f32") for ch in occ}
                      for k in prefix}
            c["coords_per_channel"] = {ch: len(coords["mesh"][ch]) for ch in occ}
            ok = c["vs_serial_cli"][0] < SYNC_TOL and all(
                coords["mesh"][ch] == coords["serial"][ch]
                and set(coords["mesh"][ch]) == {heli_coord(heli["texts"][ch])} for ch in occ)
            for k in prefix:
                for ch in range(SYNC_NCH):
                    os.unlink(f"{prefix[k]}_ch{ch + 1}.f32")
        emit(dict(phase="chain", part="flow_cli", world=world, flow=f"{label} --mesh {mesh}",
                  **c, **card))
        check(ok, f"{what} vs the serial CLI: {c}")
        res["flow_cli"][label] = c
    for sp in specs:
        for f in {sp["path"], sp.get("cu8", sp["path"])}:
            os.unlink(f)
    return res


def phase_chain(torch, card, tmp, capture) -> dict:
    """12. The generic sharded chain (ShardedChain) on NCCL, world =
    min(cards, CHAIN_MAX), over phase 4's capture: 12a the time-layout
    library graphs in ``chain_rank`` (every rank's kernel counts from 0);
    12b the CLI's -c 1 --offset -b 48000 --mesh Wx1 "DeCW 500 700 WAV" in a
    process of its own (it starts its own ranks; -v prints its rate and
    each rank's kernel launches) against the serial CLI's file; 12c the
    channel-layout library graphs (``channel_layout_rank``) on (W, 1) and,
    on four cards, (2, 2); 12d the CLI's -c 64 "DeCW 500 700 WAV" (--mesh
    Wx1, and 2x2 on four cards) and -c 16 -m "DeNBFM 0.6 WAV" (--mesh Wx1)
    against the serial --backend eager CLI's files."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main
    from csdr_tpu_torch.parallel import spawn

    import csdr_tpu_torch as ct

    world = min(torch.cuda.device_count(), CHAIN_MAX)
    mix_path = mix_capture(torch, torch.device("cuda", 0), tmp)
    specs = flow_specs(torch, ct, torch.device("cuda", 0), tmp, world)
    ranks = spawn(chain_rank, world, "cuda", args=(capture, world, mix_path, specs),
                  timeout=900.0)
    res = {"world": world}
    for label, (_, _, kernel) in chain_graphs(ct).items():
        r0 = ranks[0][label]
        per_rank = [r[label]["launches"] for r in ranks]
        emit(dict(phase="chain", part="library", flow=label, world=world, mesh=[world, 1],
                  samples=CAPTURE, launches_per_rank=per_rank,
                  **{k: v for k, v in r0.items() if not k.endswith("launches")}, **card))
        what = f"sharded chain {label} on {world}x1"
        n_out = CAPTURE // 8 if label == "DeWBFM" else CAPTURE
        check(r0["finite"] and r0["shape"] == r0["want_shape"] == [n_out]
              and r0["total"] == n_out, f"{what}: output {r0['shape']} vs {r0['want_shape']}")
        check(r0["vs_serial_rel"] < r0["bound"], f"{what}: rel {r0['vs_serial_rel']} vs serial")
        for counts in per_rank + [r[label]["second_launches"] for r in ranks]:
            check_counts(counts, kernel, what)
            if kernel:
                check(counts[kernel] == CAPTURE // BLOCK,
                      f"{what}: {counts[kernel]} {kernel} launches, want one per block")
        res[label] = dict(r0, launches_per_rank=per_rank)

    # 12b. the CLI, serial in this process, then over the mesh in its own
    offset = (10 - 31.5) / 64 * 2.56e6 - CW_TUNE
    n48 = CAPTURE * 3 // 160
    common = ["--filename", capture, "-c", "1", "--offset", repr(offset), "-b", "48000",
              "--demod", f"DeCW {CW_BW:g} {CW_PITCH:g} WAV",
              "--blocksize", str(CHAIN_CLI_BLOCK), "-n", str(n48)]
    prefix = os.path.join(tmp, "chain_serial")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counts = cli_run(torch, cli_main, common + ["-o", prefix, "--device", "cuda", "-v"])
    # -v's Throughput line ends each CLI's run
    thru = r"Throughput: \d+ samples into the flow in ([\d.]+) s"
    m = re.search(thru, buf.getvalue())
    check(m is not None, f"serial CLI -c 1 DeCW output: {buf.getvalue()[-2000:]}")
    check_counts(counts, "fir_valid", "serial CLI -c 1 DeCW")
    check(counts["fir_valid"] == -(-n48 // CHAIN_CLI_BLOCK),
          f"serial CLI -c 1 DeCW: {counts['fir_valid']} K5 launches")
    serial = read_wavs(prefix, 1, n48)
    prefix = os.path.join(tmp, "chain_mesh")
    argv = [sys.executable, "-m", "csdr_tpu_torch.apps.soapy_sdr_cli", *common,
            "--mesh", f"{world}x1", "--device", "cuda", "-v", "-o", prefix]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=HERE)
    check(r.returncode == 0, f"CLI -c 1 --mesh: exit code {r.returncode}: "
                             f"{r.stderr.strip()[-2000:]}")
    m = re.search(thru, r.stdout)
    cli_counts = [json.loads(c) for c in re.findall(r"Kernel launches on rank \d+: (\{[^}]*\})",
                                                    r.stdout)]
    check(m is not None and len(cli_counts) == world and "ShardedChain" in r.stdout,
          f"CLI -c 1 --mesh output: {r.stdout[-2000:]}")
    blocks = -(-n48 // CHAIN_CLI_BLOCK)
    for counts in cli_counts:
        check_counts(counts, "fir_valid", "CLI -c 1 --mesh DeCW")
        check(counts["fir_valid"] == blocks,
              f"CLI -c 1 --mesh DeCW: {counts['fir_valid']} K5 launches, want {blocks}")
    audio = read_wavs(prefix, 1, n48)
    rel = float(np.abs(audio.astype(np.float64) - serial).max() / np.abs(serial).max())
    cli = dict(launches_per_rank=cli_counts, serial_launches=counts["fir_valid"],
               vs_serial_cli_rel=rel, finite=bool(np.isfinite(audio).all()),
               bit_equal=bool(np.array_equal(audio, serial)), samples_in=CAPTURE,
               samples_out=n48, offset_hz=offset)
    emit(dict(phase="chain", part="cli", world=world,
              flow=f"-c 1 --offset -b 48000 --mesh {world}x1 DeCW", **cli, **card))
    check(cli["finite"] and rel < K5_REL_ERR, f"CLI -c 1 --mesh DeCW vs serial CLI: rel {rel}")
    res["cli"] = cli

    # 12c. the channel layout through the library, per mesh and graph
    res["channels"] = {}
    for key, r0 in ranks[0]["channels"].items():
        per_rank = [r["channels"][key]["launches"] for r in ranks]
        second = [r["channels"][key]["second_launches"] for r in ranks]
        emit(dict(phase="chain", part="channel_library", flow=key, world=world, samples=CAPTURE,
                  launches_per_rank=per_rank,
                  **{k: v for k, v in r0.items() if not k.endswith("launches")}, **card))
        what = f"sharded channel chain {key}"
        n_out = [r0["nch"], CAPTURE // r0["nch"]] if r0["kernel"] else [CAPTURE // r0["nch"]]
        check(r0["finite"] and r0["shape"] == r0["want_shape"] == n_out
              and r0["total"] == CAPTURE // r0["nch"],
              f"{what}: output {r0['shape']} vs {r0['want_shape']}")
        check(r0["vs_serial_rel"] < r0["bound"], f"{what}: rel {r0['vs_serial_rel']} vs serial")
        for counts in per_rank + second:
            check_counts(counts, r0["kernel"], what)
            if r0["kernel"]:
                check(counts[r0["kernel"]] == CAPTURE // BLOCK,
                      f"{what}: {counts[r0['kernel']]} K5 launches, want one per block")
        res["channels"][key] = dict(r0, launches_per_rank=per_rank)

    # 12d. the -c N CLI flows over the mesh, each in a process of its own,
    # against the serial --backend eager CLI's files
    res["channel_cli"] = {}
    cli_flows = [("-c 64 DeCW", capture,
                  ["-c", "64", "--demod", f"DeCW {CW_BW:g} {CW_PITCH:g} WAV"],
                  64, "fir_valid", K5_REL_ERR, [f"{world}x1"] + (["2x2"] if world == 4 else [])),
                 ("-c 16 -m DeNBFM", mix_path, ["-c", str(MIX_NCH), "-m", "--demod",
                                                f"DeNBFM {KF:g} WAV"],
                  1, None, CHAIN_REL_ERR, [f"{world}x1"])]
    for label, path, flow, files, kernel, bound_rel, meshes in cli_flows:
        common = ["--filename", path, "-n", str(CAPTURE), "--blocksize", str(BLOCK), *flow]
        frames = CAPTURE // (64 if files == 64 else MIX_NCH)
        prefix = os.path.join(tmp, "chain_ch_serial")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serial_counts = cli_run(torch, cli_main, common + [
                "--backend", "eager", "-o", prefix, "--device", "cuda", "-v"])
        m = re.search(thru, buf.getvalue())
        check(m is not None, f"serial CLI {label} output: {buf.getvalue()[-2000:]}")
        check_counts(serial_counts, kernel, f"serial CLI {label}")
        if kernel:
            check(serial_counts[kernel] == CAPTURE // BLOCK,
                  f"serial CLI {label}: {serial_counts[kernel]} K5 launches")
        serial = read_wavs(prefix, files, frames).astype(np.float64)
        for mesh in meshes:
            prefix = os.path.join(tmp, "chain_ch_mesh")
            argv = [sys.executable, "-m", "csdr_tpu_torch.apps.soapy_sdr_cli", *common,
                    "--mesh", mesh, "--device", "cuda", "-v", "-o", prefix]
            r = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=HERE)
            what = f"CLI {label} --mesh {mesh}"
            check(r.returncode == 0, f"{what}: exit code {r.returncode}: "
                                     f"{r.stderr.strip()[-2000:]}")
            m = re.search(thru, r.stdout)
            cli_counts = [json.loads(c) for c in re.findall(
                r"Kernel launches on rank \d+: (\{[^}]*\})", r.stdout)]
            ranks_n = int(mesh[0]) * int(mesh[2])
            check(m is not None and len(cli_counts) == ranks_n and "ShardedChain" in r.stdout,
                  f"{what} output: {r.stdout[-2000:]}")
            for counts in cli_counts:
                check_counts(counts, kernel, what)
                if kernel:
                    check(counts[kernel] == CAPTURE // BLOCK,
                          f"{what}: {counts[kernel]} K5 launches, want {CAPTURE // BLOCK}")
            audio = read_wavs(prefix, files, frames)
            rel = float(np.abs(audio - serial).max() / np.abs(serial).max())
            c = dict(launches_per_rank=cli_counts, serial_launches=serial_counts,
                     vs_serial_cli_rel=rel, finite=bool(np.isfinite(audio).all()),
                     files=files, frames=frames, samples_in=CAPTURE)
            emit(dict(phase="chain", part="channel_cli", world=world,
                      flow=f"{label} --mesh {mesh}", **c, **card))
            check(c["finite"] and rel < bound_rel, f"{what} vs serial CLI: rel {rel}")
            res["channel_cli"][f"{label} {mesh}"] = c
        del serial
    res.update(phase_chain_flows(torch, card, tmp, world, specs, ranks))
    os.unlink(mix_path)
    return res


SCAN_PLL_N = 1 << 16            # 13a: K7 on one row, two state-chained blocks of 2^15
SCAN_SYNC_ROWS, SCAN_SYNC_N = 4, 1 << 14   # 13a: K8 on 4 rows, three blocks of 2^14
SCAN_CHECK_N = 1 << 16         # 13b: K7's outputs at the flow's shape held against the twin
SCAN_SEP_DB = 15.0    # the scan PLL's separation after pull-in (tests/test_symsync_stereo.py:222)
SCAN_FLOW_TOL = 1e-5  # K7 at the DeFMS block against its twin (the φ pass's atan2f vs the CPU's)
def pll_constants():
    """K7's (ω, α, β) at the DeFMS flow's 200 kHz quad rate."""
    bw = 9.0 / FM_BW
    return 2 * np.pi * 19000.0 / FM_BW, 4.0 * bw, 4.0 * bw * bw


def phase_scan_kernels(torch, dev, card) -> dict:
    """13a. K7 and K8 against their plain twins (on the CPU): K7 on one
    noisy 19 kHz pilot row of SCAN_PLL_N samples in two state-chained
    blocks (2e-3, θ within 1e-4), then on the same row with runs of exact
    zeros (e from the rotated product's signed zeros) and from carries of
    θ = ±20, freq = 0.5 (the rotated product and the floored mod): 2e-3, θ
    within 1e-4; K8 through SymSyncScan on SCAN_SYNC_ROWS rows of the
    reference tests' signals (``sync_rows``), real k = 10 (kaiser, W = 81)
    and complex k = 4, m = 3 (rnyquist, W = 25), three blocks of
    SCAN_SYNC_N: every output and τ bit for bit (the twin steps and sums
    in the kernel's order), and once with a carried η of −30 that runs τ
    back through the row, so the window ring is re-seated and pairs read
    the row: bit for bit.  Each kernel launches once per block."""
    from csdr_tpu_torch.models import symsync
    from csdr_tpu_torch.ops.cuda import pll_scan as k7
    from csdr_tpu_torch.ops.cuda import symsync_scan as k8

    out = {}
    cpu = torch.device("cpu")
    omega, alpha, beta = pll_constants()
    rng = np.random.default_rng(SEED + 1300)
    t = np.arange(SCAN_PLL_N)
    p = (0.1 * np.exp(1j * (2 * np.pi * 19004.0 / FM_BW * t + 2.0))
         + 0.02 * (rng.normal(size=SCAN_PLL_N) + 1j * rng.normal(size=SCAN_PLL_N)))
    p = torch.from_numpy(p.astype(np.complex64).reshape(1, -1))
    cg = (torch.zeros(1, device=dev), torch.zeros(1, device=dev))
    cc = (torch.zeros(1), torch.zeros(1))
    before, errs, th = k7.launches, [], []
    half = SCAN_PLL_N // 2
    for b in range(2):
        pb = p[:, b * half:(b + 1) * half].contiguous()
        cg, yg = k7.pll_scan(pb.to(dev), cg, omega, alpha, beta)
        cc, yc = k7.pll_scan(pb, cc, omega, alpha, beta)
        errs.append(float((yg.cpu() - yc).abs().max()))
        th.append(float((cg[0].cpu() - cc[0]).abs().max()))
    torch.cuda.synchronize()
    out["pll"] = dict(max_abs_err=max(errs), theta_err=max(th), launches=k7.launches - before)
    check(out["pll"]["launches"] == 2, f"13a: K7 launched {out['pll']['launches']} times")
    check(max(errs) < SYNC_TOL and max(th) < 1e-4, f"13a: K7 vs twin {out['pll']}")
    # the rare branches: runs of exact zeros, carries outside the loop's range
    pz = p.clone()
    pz[:, 9000:9600] = 0
    pz[:, -300:] = 0
    for name, pr, th0, fr0 in (("zeros", pz, 1.0, 0.0), ("carry_high", p, 20.0, 0.5),
                               ("carry_low", p, -20.0, 0.5)):
        c0 = (torch.full((1,), th0), torch.full((1,), fr0))
        (tg, _), yg = k7.pll_scan(pr.to(dev), tuple(c.to(dev) for c in c0), omega, alpha, beta)
        (tc, _), yc = k7.pll_scan(pr, c0, omega, alpha, beta)
        torch.cuda.synchronize()
        r = dict(max_abs_err=float((yg.cpu() - yc).abs().max()),
                 theta_err=float((tg.cpu() - tc).abs().max()))
        out["pll"][name] = r
        check(r["max_abs_err"] < SYNC_TOL and r["theta_err"] < 1e-4, f"13a: K7 {name} vs twin {r}")

    for kind in ("real", "complex"):
        blk = (symsync.sym_sync_r(SYNC_K, 4, 0.0, 64, mode="scan") if kind == "real"
               else symsync.sym_sync_c(3, 4, mode="scan"))
        x = sync_rows(SCAN_SYNC_ROWS, 3 * SCAN_SYNC_N, blk.k, SEED + 1310, kind == "complex")
        sg = tuple(torch.zeros((SCAN_SYNC_ROWS, *leaf.shape), dtype=leaf.dtype, device=dev)
                   for leaf in blk.init(dev))
        sc = tuple(leaf.cpu() for leaf in sg)
        before, errs, equal = k8.launches, [], True
        for b in range(3):
            xb = torch.from_numpy(np.ascontiguousarray(x[:, b * SCAN_SYNC_N:(b + 1) * SCAN_SYNC_N]))
            sg, yg = blk.apply(sg, xb.to(dev))
            sc, yc = blk.apply(sc, xb)
            errs.append(float((yg.cpu() - yc).abs().max() / yc.abs().max()))
            equal &= torch.equal(yg.cpu(), yc) and all(torch.equal(a.cpu(), c)
                                                        for a, c in zip(sg[1:], sc[1:]))
        torch.cuda.synchronize()
        agree = dict(max_err=max(errs), bit_equal=equal, launches=k8.launches - before,
                     tau_err=float((sg[1].cpu() - sc[1]).abs().max()), k=blk.k, W=blk.W,
                     npfb=blk.npfb)
        # a carried η of −30 runs τ back through the row: re-seats, row reads
        xf = torch.cat([torch.zeros((SCAN_SYNC_ROWS, blk.H), dtype=xb.dtype), xb], dim=-1)
        bank = symsync._bank_on(blk.k, blk.m, blk.npfb, blk.ftype, blk.beta, cpu)
        z = torch.zeros(SCAN_SYNC_ROWS, dtype=xb.dtype)
        carry = (torch.full((SCAN_SYNC_ROWS,), np.float32(3000.3)),
                 torch.full((SCAN_SYNC_ROWS,), np.float32(-30.0)), z, z)
        loop = blk.loop(SCAN_SYNC_N)
        cg, yg = k8.symsync_scan(xf.to(dev), bank.to(dev), tuple(c.to(dev) for c in carry), loop)
        cc, yc = k8.symsync_scan_ref(xf, bank, carry, loop)
        torch.cuda.synchronize()
        agree["ring_paths_bit_equal"] = torch.equal(yg.cpu(), yc) and all(
            torch.equal(a.cpu(), c) for a, c in zip(cg, cc))
        out[f"sync_{kind}"] = agree
        check(agree["launches"] == 3, f"13a: K8 {kind} launched {agree['launches']} times")
        check(agree["bit_equal"] and agree["ring_paths_bit_equal"],
              f"13a: K8 {kind} vs twin {agree}")
    emit(dict(phase="scan_kernels", **out, **card))
    return out


@contextlib.contextmanager
def kernel_inputs(mod, name: str):
    """Within: ``mod.<name>``, a kernel's wrapper that the models import at
    each call, runs as before and keeps the arguments of its first call in
    the yielded list."""
    fn, seen = getattr(mod, name), []

    def keep(*args):
        if not seen:
            seen.append(args)
        return fn(*args)

    setattr(mod, name, keep)
    try:
        yield seen
    finally:
        setattr(mod, name, fn)


def tracker_graph(ct, mode: str):
    """The CLI's -c 64 DeNBFMSync graph behind the cu8 reader on pfb_fused
    (K4), its per-channel symbol sync in ``mode``."""
    from csdr_tpu_torch.models.receivers import channelized_receiver
    from csdr_tpu_torch.models.symsync import sym_sync_r

    inner = ct.chain(ct.fm_demodulator(0.02 * SYNC_K), sym_sync_r(SYNC_K, 4, 0.0, 64, mode=mode))
    return ct.chain(ct.u8_to_iq(), channelized_receiver(SYNC_NCH, inner, backend="pfb_fused"))


def phase_scan_flows(torch, ct, dev, card, tmp) -> dict:
    """13b. The scan modes at full width through the library.

    DeFMS 8 --rds with pll_mode="scan": phase 6b's capture through the
    CLI's front end, then ``fms_graph(8, "scan")`` on a Pipeline at the
    CLI's block: L/R separation > SCAN_SEP_DB on the second half (after the
    9 Hz loop's pull-in), PI and PS decoded, K7 once per block and K5 at
    least once per block, no other kernel.  The -c 64 DeNBFMSync 10 tracker
    with mode="scan" behind K4 on phase 9's capture: K8 and K4 once per
    block and nothing else; helidecode finds only the sent coordinate on
    each occupied channel, at least every one sent after the first block
    (each τ wrap at a block's end may cost the frame across it, in the JAX
    package too: tests/test_torch_scan.py), and nothing on the empty ones.
    Each kernel is then launched alone on the arguments the flow's first
    block hands it (``kernel_inputs``; that block launches it once) and
    held against its twin on the CPU: K7's first SCAN_CHECK_N outputs and θ
    at the cut within SCAN_FLOW_TOL, K8's every output and τ bit for bit
    (the twin steps and sums in the kernel's order)."""
    from csdr_tpu_torch.models import rds
    from csdr_tpu_torch.ops.cuda import pll_scan as k7
    from csdr_tpu_torch.ops.cuda import symsync_scan as k8

    out = {}
    # DeFMS --rds, pll_mode="scan"
    cu8 = os.path.join(tmp, "scan_stereo.cu8")
    stereo_capture(torch, dev, CAPTURE, SEED + 500).cpu().numpy().tofile(cu8)
    fe, n = front_end_cf32(ct, dev, cu8, 2.56e6, 0.0, FM_BW, os.path.join(tmp, "scan_fe.cf32"))
    os.unlink(cu8)
    g, block = fms_graph(FMS_DECIM, "scan")
    sink = ct.CollectSink()
    torch.cuda.synchronize()
    reset_counts()
    ct.Pipeline(g, block_size=block, device=dev).run(ct.cf32_file_source(fe, block), sink)
    torch.cuda.synchronize()
    counts = read_counts()
    audio, bits = sink.concat()
    blocks = -(-(n + g.flush_len()) // block)
    rate = FM_BW / FMS_DECIM
    sep = []
    for ch, (fw, fo) in enumerate(((FMS_L, FMS_R), (FMS_R, FMS_L))):
        y = audio[ch, audio.shape[-1] // 2:].astype(np.float64)
        spec = np.abs(np.fft.rfft(y * np.hanning(len(y)))) ** 2
        f = np.fft.rfftfreq(len(y), 1.0 / rate)
        band = lambda f0: spec[(f > f0 - 100) & (f < f0 + 100)].max()  # noqa: E731
        sep.append(float(10 * np.log10(band(fw) / band(fo))))
    info = rds.decode_groups(bits)
    # K7 alone on the pilot the flow's first block hands it: its first
    # SCAN_CHECK_N outputs held against the twin (the loop is causal) with
    # θ at the cut
    x = torch.from_numpy(np.fromfile(fe, np.complex64, count=block)).to(dev)
    g = fms_graph(FMS_DECIM, "scan")[0]
    reset_counts()
    with kernel_inputs(k7, "pll_scan") as seen:
        g.apply(g.init(dev), x)
    k7_launches = read_counts()["pll_scan"]
    del x
    os.unlink(fe)
    p_a, c0, *consts = seen[0]
    _, sub = k7.pll_scan(p_a, c0, *consts)
    (th, _), sub_c = k7.pll_scan_ref(p_a[..., :SCAN_CHECK_N].cpu(), tuple(c.cpu() for c in c0),
                                     *consts)
    sub = sub.cpu()
    full = dict(max_abs_err=float((sub[..., :SCAN_CHECK_N] - sub_c).abs().max()),
                theta_cut_err=float((sub[..., SCAN_CHECK_N]
                                     - torch.complex(torch.cos(2 * th), torch.sin(2 * th)))
                                    .abs().max()),
                checked=f"the first {SCAN_CHECK_N} of {p_a.shape[-1]} outputs")
    out["DeFMS"] = dict(samples=n, block=block, blocks=blocks, launches=counts,
                        separation_db=sep, pi=info["pi"], ps=info["ps"], k7_vs_twin=full,
                        k7_launches_per_step=k7_launches,
                        k7_shape=f"{tuple(p_a.shape)} complex64 -> {tuple(sub.shape)} complex64")
    del p_a, sub, seen
    emit(dict(phase="scan_flows", flow="DeFMS 8 --rds, pll_mode scan", wire="cf32",
              **out["DeFMS"], **card))
    check_counts(counts, ("pll_scan", "fir_valid"), "13b DeFMS scan")
    check(counts["pll_scan"] == blocks, f"13b DeFMS: K7 launched {counts['pll_scan']} times in "
                                        f"{blocks} blocks")
    check(counts["fir_valid"] >= blocks, f"13b DeFMS: K5 launched {counts['fir_valid']} times")
    check(bool(np.isfinite(audio).all()), "13b DeFMS: non-finite audio")
    check(min(sep) > SCAN_SEP_DB, f"13b DeFMS: L/R separation {sep} dB")
    check(k7_launches == 1, f"13b DeFMS: {k7_launches} K7 launches in the first block's step")
    check(info["pi"] == RDS_PI and info["ps"] == RDS_PS, f"13b DeFMS: RDS {info}")
    check(full["max_abs_err"] < SCAN_FLOW_TOL and full["theta_cut_err"] < SCAN_FLOW_TOL,
          f"13b DeFMS: K7 at the flow's shape vs twin {full}")

    # the -c 64 DeNBFMSync 10 tracker, mode="scan", behind K4
    xh, texts, eps_of = sync_capture(torch, dev, CAPTURE, SEED + 1000)
    path = os.path.join(tmp, "scan_heli.cu8")
    to_cu8(torch, xh).cpu().numpy().tofile(path)
    del xh
    g = tracker_graph(ct, "scan")
    block = BLOCK // g.granule * g.granule
    blocks = -(-CAPTURE // block)
    sink = ct.CollectSink()
    torch.cuda.synchronize()
    reset_counts()
    ct.Pipeline(g, block_size=block, device=dev).run(ct.cu8_file_source(path, block), sink)
    torch.cuda.synchronize()
    counts = read_counts()
    y = sink.concat()
    check(y.shape == (SYNC_NCH, CAPTURE * 2 // (SYNC_NCH * SYNC_K)) and bool(np.isfinite(y).all()),
          f"13b tracker: output {y.shape}")
    coords = []
    for ch in range(SYNC_NCH):
        f32 = os.path.join(tmp, f"scan_heli_ch{ch + 1}.f32")
        y[ch].astype(np.float32).tofile(f32)
        coords.append(heli_decode(f32))
        os.unlink(f32)
    # the coordinates of the frames sent wholly after the first block
    after_first = 2 * ((CAPTURE - block) // (SYNC_K * SYNC_NCH * 730) - 1)
    u8 = torch.from_numpy(np.fromfile(path, np.uint8, count=2 * block).reshape(block, 2)).to(dev)
    os.unlink(path)
    # K8 alone on the panel the tracker's first block hands it: every output
    # held against the twin on the CPU
    g = tracker_graph(ct, "scan")
    reset_counts()
    with kernel_inputs(k8, "symsync_scan") as seen:
        g.apply(g.init(dev), u8)
    k8_launches = read_counts()["symsync_scan"]
    del u8
    xf, bank, carry, loop = seen[0]
    (tau, *_), yk = k8.symsync_scan(xf, bank, carry, loop)
    (tau_c, *_), yc = k8.symsync_scan_ref(xf.cpu(), bank.cpu(), tuple(c.cpu() for c in carry),
                                          loop)
    yk = yk.cpu()
    full = dict(max_err=float((yk - yc).abs().max() / yc.abs().max()),
                tau_err=float((tau.cpu() - tau_c).abs().max()), outputs=int(yc.numel()),
                bit_equal=torch.equal(yk, yc) and torch.equal(tau.cpu(), tau_c))
    out["tracker"] = dict(
        samples=CAPTURE, block=block, blocks=blocks,
        launches=counts, coords_per_channel={ch: len(coords[ch]) for ch in SYNC_CHANNELS},
        coords_after_first_block=after_first,
        coords_on_empty_channels=sum(len(coords[ch]) for ch in range(SYNC_NCH)
                                     if ch not in SYNC_CHANNELS),
        clock_ppm={ch: e * 1e6 for ch, e in eps_of.items()},
        k8_shape=f"{tuple(xf.shape)} {str(xf.dtype)[6:]} -> {tuple(yk.shape)}",
        k8_vs_twin=full, k8_launches_per_step=k8_launches)
    del xf, seen, yk
    emit(dict(phase="scan_flows", flow=f"-c {SYNC_NCH} DeNBFMSync {SYNC_K}, mode scan, "
                                       "pfb_fused", wire="cu8", **out["tracker"], **card))
    check_counts(counts, ("pfb_channelize_fused", "symsync_scan"), "13b tracker")
    check(k8_launches == 1, f"13b tracker: {k8_launches} K8 launches in the first block's step")
    check(counts["symsync_scan"] == blocks and counts["pfb_channelize_fused"] == blocks,
          f"13b tracker: K8 {counts['symsync_scan']}, K4 {counts['pfb_channelize_fused']} "
          f"launches in {blocks} blocks")
    for ch in SYNC_CHANNELS:
        want = heli_coord(texts[ch])
        check(set(coords[ch]) == {want} and len(coords[ch]) >= after_first,
              f"13b tracker channel {ch}: {len(coords[ch])} coordinates {set(coords[ch])}, "
              f"want {want}, at least {after_first}")
    check(full["bit_equal"], f"13b tracker: K8 at the flow's shape vs twin {full}")
    check(out["tracker"]["coords_on_empty_channels"] == 0,
          f"13b tracker: {out['tracker']['coords_on_empty_channels']} coordinates on empty "
          "channels")
    return out


def phase_bundle(torch, card, tmp, capture: str, fused_audio: np.ndarray) -> dict:
    """13c. The port's bundle (``apps/package_app.build_bundle``, not
    self-contained, the kernel library it carried removed) runs phase 4's -c 64
    --backend fused --device cuda flow through its launcher in a process of
    its own: its kernel library is built from the sources inside the
    zipapp into the bundle's build directory, K1 launches once per block
    and no other kernel, and its 64 files equal the repo CLI's bit for
    bit."""
    from csdr_tpu_torch.apps.package_app import build_bundle
    from csdr_tpu_torch.ops.cuda import _build

    dist = build_bundle(os.path.join(tmp, "dist"))
    built = os.path.join(dist, "build")
    # the repo's library is built by now, and the bundle carries it: take it
    # out, so that the bundle builds its own from the zipapp's sources
    carried = sorted(os.listdir(built))
    check(carried == [_build.library_path().name],
          f"13c: the bundle carries {carried}, want the built {_build.library_path().name}")
    for f in carried:
        os.unlink(os.path.join(built, f))
    check(os.listdir(built) == [], f"13c: the bundle's build directory holds {os.listdir(built)}")
    prefix = os.path.join(tmp, "bundle")
    env = {k: v for k, v in os.environ.items() if k != _build.BUILD_ENV}
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", "")
    argv = [os.path.join(dist, "csdr"), "soapy-sdr", "--filename", capture, "-n", str(CAPTURE),
            "-c", "64", "-o", prefix, "--demod", f"DeNBFM {KF} F32", "--backend", "fused",
            "--device", "cuda", "--blocksize", str(BLOCK), "-v"]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600, cwd=tmp, env=env)
    check(r.returncode == 0, f"13c: the bundle's CLI exit code {r.returncode}: "
                             f"{r.stderr.strip()[-2000:]}")
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("Kernel launches: ")]
    counts = json.loads(line[-1].split(": ", 1)[1]) if line else {}
    lib = os.path.join(built, _build.library_path().name)
    log = os.path.join(built, _build.library_path().name.replace("libcsdr_kernels-", "nvcc-")
                       .replace(".so", ".log"))
    blocks = CAPTURE // BLOCK
    equal = all(np.array_equal(np.fromfile(f"{prefix}_ch{k + 1}.f32", np.float32), fused_audio[k])
                for k in range(64))
    out = dict(carried=carried, launches=counts, library=os.path.relpath(lib, tmp),
               library_built_in_bundle=os.path.exists(lib) and os.path.exists(log),
               files_equal_repo_cli=equal)
    emit(dict(phase="bundle", flow="-c 64 DeNBFM fused through the bundle's launcher", **out,
              **card))
    for k in range(64):
        os.unlink(f"{prefix}_ch{k + 1}.f32")
    check(out["library_built_in_bundle"], f"13c: no kernel library built in {built}: "
                                          f"{os.listdir(built)}")
    check(counts.get("flagship_fused") == blocks
          and all(v == 0 for k, v in counts.items() if k != "flagship_fused"),
          f"13c: the bundle's kernel launches {counts}, want K1 {blocks} times")
    check(equal, "13c: the bundle's files differ from the repo CLI's")
    shutil.rmtree(dist)
    return out


def phase_scan(torch, ct, dev, card, tmp, capture: str, fused_audio) -> dict:
    """13. The scan kernels against their twins (13a), the scan modes'
    full-width library runs (13b), the bundle (13c)."""
    out = {"13a": timed("scan_kernels", phase_scan_kernels, torch, dev, card)}
    out["13b"] = timed("scan_flows", phase_scan_flows, torch, ct, dev, card, tmp)
    out["13c"] = timed("bundle", phase_bundle, torch, card, tmp, capture, fused_audio)
    return out


def fused_reference(torch, tmp, capture: str) -> np.ndarray:
    """Phase 4's fused -c 64 CLI run on ``capture`` (for --scan-only): the
    64 channels' audio."""
    from csdr_tpu_torch.apps.soapy_sdr_cli import main as cli_main

    prefix = os.path.join(tmp, "fused")
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        counts = cli_run(torch, cli_main, [
            "--filename", capture, "-n", str(CAPTURE), "-c", "64", "-o", prefix, "--demod",
            f"DeNBFM {KF} F32", "--backend", "fused", "--device", "cuda", "--blocksize",
            str(BLOCK)])
    check_counts(counts, "flagship_fused", "4 (reference)")
    audio = np.stack([np.fromfile(f"{prefix}_ch{k + 1}.f32", np.float32) for k in range(64)])
    for k in range(64):
        os.unlink(f"{prefix}_ch{k + 1}.f32")
    return audio


def timed(label: str, fn, *args):
    """``fn(*args)``, then a {"phase": "seconds"} line with its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit(dict(phase="seconds", of=label, seconds=time.perf_counter() - t0))
    return out


def main(mesh_only: bool = False, sync_only: bool = False, imagery_only: bool = False,
         device_only: bool = False, chain_only: bool = False, scan_only: bool = False) -> int:
    """Every phase; with ``mesh_only`` (``--mesh-only``) identity, build,
    phase 4's CLI runs (the serial reference) and phase 7 alone, for a
    call on several cards; with ``sync_only`` (``--sync-only``) identity,
    build and phase 9; with ``imagery_only`` (``--imagery-only``) identity,
    build and phase 10; with ``device_only`` (``--device-only``) identity,
    build and phase 11; with ``chain_only`` (``--chain-only``) identity,
    build, phase 4's capture and phase 12; with ``scan_only``
    (``--scan-only``) identity, build, phase 4's capture and fused CLI run,
    and phase 13."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "csdr_tpu_torch")):
        fail(f"no csdr_tpu_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, HERE)
    import csdr_tpu_torch as ct
    from csdr_tpu_torch.ops.cuda import _build
    from csdr_tpu_torch.ops.cuda import flagship_fused as ff
    from csdr_tpu_torch.ops.cuda import pfb_fused as pf

    # 1. identity
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    card = dict(card=kind, nvidia_smi=smi)
    emit(dict(phase="identity", torch=torch.__version__, cuda=torch.version.cuda,
              device_count=torch.cuda.device_count(), **card))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 2. build
    lib = timed("build", _build.build)
    ptxas = ptxas_summary(lib)
    emit(dict(phase="build", library=os.path.relpath(lib, HERE), ptxas=ptxas))

    if sync_only:
        with tempfile.TemporaryDirectory() as tmp:
            timed("sync", phase_sync, torch, ct, pf, dev, card, tmp)
        print(smi, flush=True)
        emit({"sync_only": True, "ok": True})
        return 0
    if imagery_only:
        with tempfile.TemporaryDirectory() as tmp:
            timed("imagery_and_files", phase_imagery_and_files, torch, dev, card, tmp)
        print(smi, flush=True)
        emit({"imagery_only": True, "ok": True})
        return 0
    if device_only:
        with tempfile.TemporaryDirectory() as tmp:
            timed("device", phase_device, torch, ff, dev, card, tmp)
        print(smi, flush=True)
        emit({"device_only": True, "ok": True})
        return 0
    if chain_only:
        with tempfile.TemporaryDirectory() as tmp:
            capture, _ = main_capture(torch, dev, tmp)
            chain = timed("chain", phase_chain, torch, card, tmp, capture)
        print(smi, flush=True)
        emit({"chain_only": True, "world": chain["world"], "ok": True})
        return 0
    if scan_only:
        with tempfile.TemporaryDirectory() as tmp:
            capture, _ = main_capture(torch, dev, tmp)
            fused = fused_reference(torch, tmp, capture)
            timed("scan", phase_scan, torch, ct, dev, card, tmp, capture, fused)
        print(smi, flush=True)
        emit({"scan_only": True, "ok": True})
        return 0
    if mesh_only:
        with tempfile.TemporaryDirectory() as tmp:
            _, runs, capture, _ = timed("main_path", phase_main_path, torch, ff, pf, dev, card,
                                        tmp)
            agc_path = write_agc_capture(torch, ct, dev, card, tmp)
            mesh = timed("mesh", phase_mesh, torch, card, tmp, capture, agc_path, runs["fused"])
        print(smi, flush=True)
        emit({"mesh_only": True, "world": mesh["world"], "ok": True})
        return 0

    # 3. kernel vs plain
    errs = timed("compare", phase_compare, torch, ct, ff, dev, card)
    errs.update(timed("compare_pfb", phase_compare_pfb, torch, ct, pf, dev, card))  # 3b
    errs.update(timed("compare_fir", phase_compare_fir, torch, dev, card))  # 3c

    # 4. main paths through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        launches, runs, capture, bins = timed("main_path", phase_main_path, torch, ff, pf, dev,
                                              card, tmp)
        pfb_runs, agc_path = timed("main_path_pfb", phase_main_path_pfb, torch, ct, dev,
                                   card, tmp, capture, runs, bins)  # 4b
        mesh = timed("mesh", phase_mesh, torch, card, tmp, capture, agc_path, runs["fused"])  # 7
        chain = timed("chain", phase_chain, torch, card, tmp, capture)  # 12
        scan = timed("scan", phase_scan, torch, ct, dev, card, tmp, capture,
                     runs["fused"])  # 13
        del runs
        ckpt = timed("checkpoint", phase_checkpoint, torch, ct, dev, card, capture)  # 6d
        for f in (capture, agc_path):
            os.unlink(f)
        fir_runs = timed("main_path_fir", phase_main_path_fir, torch, dev, card, tmp)  # 4c
        timed("wbfm", phase_wbfm, torch, dev, card, tmp)  # 6a
        fms = timed("stereo_rds", phase_stereo_rds, torch, dev, card, tmp)  # 6b
        mix = timed("mix", phase_mix, torch, dev, card, tmp)  # 6c
        pkt = timed("packet", phase_packet, torch, ct, dev, card, tmp)  # 8
        sync = timed("sync", phase_sync, torch, ct, pf, dev, card, tmp)  # 9
        img = timed("imagery_and_files", phase_imagery_and_files, torch, dev, card,
                    tmp)  # 10
        live = timed("device", phase_device, torch, ff, dev, card, tmp)  # 11

    print(smi, flush=True)
    flagship = {
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/flagship_fused.cu",
        "launches": launches,
        "shape": f"cu8 ({2 * BLOCK},) uint8 -> (64, {BLOCK // 64}) float32",
        "launches_mix_run": mix["fused"]["launches"]["flagship_fused"],
        "launches_checkpoint_run": ckpt["fused"]["launches"]["flagship_fused"],
        "launches_wav_run": img["wav"]["runs"]["fused"]["launches"]["flagship_fused"],
        "launches_rtl_tcp_device_run": live["11a"]["launches"],
        "launches_bundle_run": scan["13c"]["launches"].get("flagship_fused"),
        "launches_mesh_run_per_rank": [c["flagship_fused"]
                                       for c in mesh["flagship_launches_per_rank"]],
        "launches_mesh_cli_per_rank": [c["flagship_fused"]
                                       for c in mesh["cli"]["launches_per_rank"]],
        "mesh": {"world": mesh["world"], "q99_vs_serial": mesh["flagship"]["q99"]},
        "tiles_vs_default": live["11d"]["vs_default"],
    }
    emit({"kernels": [dict(
        name="flagship_fused_wide",
        replaces="csdr_tpu/ops/pallas/flagship_fused_wide.py:537",
        max_abs_err=errs[(64, "u8")],
        note="K1 (nch | 64) and K2 are one CUDA kernel; launches and max_abs_err read the "
             "-c 64 main path and the nch 64 cu8 runs",
        **flagship,
    ), dict(
        name="flagship_fused",
        replaces="csdr_tpu/ops/pallas/flagship_fused.py:479",
        max_abs_err=errs[(64, "u8")],
        note="the same kernel as flagship_fused_wide; K2's any-nch path is compared at "
             "nch 20 under nch20",
        nch20={"max_abs_err": max(errs[(20, "f32")], errs[(20, "u8")]),
               "shape": f"cu8 ({2 * block_len(20, ff.DEFAULT_TILE_F)},) uint8 -> "
                        f"(20, {block_len(20, ff.DEFAULT_TILE_F) // 20}) float32"},
        **flagship,
    ), {
        "name": "pfb_fm_fused",
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/pfb_fused.cu",
        "replaces": "csdr_tpu/ops/pallas/pfb_fused.py:149",
        "launches": pfb_runs["pfb_fm_fused"]["launches"],
        "launches_mix_run": mix["pfb_fused"]["launches"]["pfb_fm_fused"],
        "launches_profile_run": img["files"]["profile"]["launches"],
        "launches_synthetic_device_run": live["11b"]["runs"]["pfb_fused device"]["launches"][
            "pfb_fm_fused"],
        "launches_mesh_runs_per_rank": {
            f"{c['mesh'][0]}x{c['mesh'][1]}": [n["pfb_fm_fused"] for n in c["launches_per_rank"]]
            for c in mesh["channelized"] if c["backend"] == "pfb_fused"},
        "max_abs_err": errs[("pfb_fm_fused", 64)],
        "shape": f"({BLOCK // 64 + 14}, 64) complex64 -> (64, {BLOCK // 64}) float32",
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("pfb_tile<1")},
    }, {
        "name": "pfb_channelize_fused",
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/pfb_fused.cu",
        "replaces": "csdr_tpu/ops/pallas/pfb_fused.py:188",
        "launches": pfb_runs["pfb_channelize_fused"]["launches"],
        "launches_raw_split": pfb_runs["raw_split"]["launches"],
        "launches_mix_agc_run": mix["pfb_fused -a"]["launches"]["pfb_channelize_fused"],
        "launches_band_monitor_run": pkt["band monitor pfb_fused"]["launches"][
            "pfb_channelize_fused"],
        "launches_denbfmsync_run": sync["9b"]["runs"]["pfb_fused"]["launches"][
            "pfb_channelize_fused"],
        "launches_scan_tracker_run": scan["13b"]["tracker"]["launches"]["pfb_channelize_fused"],
        "denbfmsync": {
            "shape": f"({sync['9b']['block'] // 64 + 13}, 64) complex64 -> "
                     f"(64, {sync['9b']['block'] // 64}) complex64",
            "max_abs_err": sync["9a"]["k4_vs_plain_max"]},
        "band_monitor": {k: pkt["band monitor pfb_fused"][k] for k in (
            "k4_vs_eager_env_max", "k4_vs_eager_score_max_paged")},
        "launches_mesh_runs_per_rank": {
            f"{c['mesh'][0]}x{c['mesh'][1]}": [n["pfb_channelize_fused"]
                                               for n in c["launches_per_rank"]]
            for c in mesh["channelized"] if c["backend"] == "pfb_fused -a"},
        "max_abs_err": errs[("pfb_channelize_fused", 64)],
        "shape": f"({BLOCK // 64 + 13}, 64) complex64 -> (64, {BLOCK // 64}) complex64",
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("pfb_tile<0")},
    }, {
        "name": "fir_valid",
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/fir_valid.cu",
        "replaces": "csdr_tpu/ops/pallas/fir_kernel.py:100",
        "launches": fir_runs["fir_valid"]["launches"],
        "launches_pfb_fused_run": fir_runs["fir_valid"]["launches_pfb_fused"],
        "launches_single_channel_run": fir_runs["fir_valid_single"],
        "launches_rds_run": fms["launches"]["fir_valid"],
        "launches_rds_scan_pll_run": scan["13b"]["DeFMS"]["launches"]["fir_valid"],
        "launches_rtty_run": pkt["DeRTTY"]["launches"]["fir_valid"],
        "launches_sharded_chain_per_rank": [c["fir_valid"]
                                            for c in chain["DeCW"]["launches_per_rank"]],
        "launches_sharded_cli_per_rank": [c["fir_valid"]
                                          for c in chain["cli"]["launches_per_rank"]],
        "sharded_chain": {
            "world": chain["world"],
            "shape": f"({BLOCK // chain['world'] + chain['DeCW']['taps'] - 1},) complex64 "
                     f"x {chain['DeCW']['taps']} real taps per rank",
            "vs_serial_rel": chain["DeCW"]["vs_serial_rel"]},
        "launches_channel_chain_per_rank": {
            key: [c["fir_valid"] for c in r["launches_per_rank"]]
            for key, r in chain["channels"].items() if r["kernel"] == "fir_valid"},
        "launches_channel_cli_per_rank": {
            key: [c["fir_valid"] for c in r["launches_per_rank"]]
            for key, r in chain["channel_cli"].items() if "DeCW" in key},
        "launches_sharded_flows_per_rank": {
            key: [c["fir_valid"] for c in r["launches_per_rank"]]
            for key, r in chain["flows"].items() if key.startswith(("DeFMS", "DeRTTY"))},
        "launches_flow_cli_per_rank": [
            c["fir_valid"] for c in chain["flow_cli"]["DeFMS --rds"]["launches_per_rank"]],
        "sharded_flows": {
            key: {"shape_per_rank": f"(1, {r['nloc'] + K - 1}) "
                                    f"{'complex64' if cplx else 'float32'} x {K} real taps",
                  "vs_serial_rel": r["vs_serial_rel"]}
            for key, r in chain["flows"].items()
            for K, cplx in [(333, False) if key.startswith("DeFMS") else (1056, True)]
            if key.startswith(("DeFMS", "DeRTTY"))},
        "channel_chain": {
            key: {"shape_per_rank": r["k5_shape_per_rank"], "panel_per_rank": r["panel_per_rank"],
                  "vs_serial_rel": r["vs_serial_rel"]}
            for key, r in chain["channels"].items() if r["kernel"] == "fir_valid"},
        "max_abs_err": errs["c64_complex_585"][0],
        "vs_fft_strategy_rel": errs["c64_complex_585"][1],
        "shape": f"(64, {BLOCK // 64 + 584}) complex64 x 585 real taps -> (64, {BLOCK // 64})",
        "other_shapes": {c: {"max_abs_err": errs[c][0], "vs_fft_strategy_rel": errs[c][1]}
                         for c in ("c64_real_585", "c1_complex_3651", "c1_real_rds_333",
                                   "c1_complex_rtty_1056")},
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("fir_valid_tile")},
    }, {
        "name": "fft_fir",
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/fft_fir.cu",
        "replaces": "csdr_tpu/ops/pallas/fftfir.py:137",
        "launches": fir_runs["fft_fir"]["launches"],
        "max_abs_err": errs["c1_complex_usb_1826"][0],
        "vs_fft_strategy_rel": errs["c1_complex_usb_1826"][1],
        "shape": f"({BLOCK + 1825},) complex64 x 1826 complex taps -> ({BLOCK},) complex64",
        "other_shapes": {c: {"max_abs_err": errs[c][0], "vs_fft_strategy_rel": errs[c][1]}
                         for c in ("c1_real_real_3651", "k6_c64_complex_585",
                                   "k6_c1_complex_3651")},
    }, {
        "name": "pll_scan",
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/pll_scan.cu",
        "replaces": "csdr_tpu/models/stereo.py:39",
        "note": "K7, no Pallas counterpart: fms_pll_scan's lax.scan (csdr_tpu/models/"
                "stereo.py:62), StereoFMDecoder(pll_mode='scan'). max_abs_err against the "
                "twin over the first 2^16 outputs of the DeFMS 8 --rds scan flow's first "
                "block (13b); max_abs_err_13a over 13a's two chained blocks",
        "launches": scan["13b"]["DeFMS"]["launches"]["pll_scan"],
        "launches_per_step": scan["13b"]["DeFMS"]["k7_launches_per_step"],
        "max_abs_err": scan["13b"]["DeFMS"]["k7_vs_twin"]["max_abs_err"],
        "max_abs_err_13a": scan["13a"]["pll"]["max_abs_err"],
        "shape": scan["13b"]["DeFMS"]["k7_shape"],
    }, {
        "name": "symsync_scan",
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/symsync_scan.cu",
        "replaces": "csdr_tpu/models/symsync.py:281",
        "note": "K8, no Pallas counterpart: SymSyncScan's lax.scan (csdr_tpu/models/"
                "symsync.py:362), sym_sync_r/sym_sync_c(mode='scan'); bit for bit equal to "
                "the twin. max_abs_err on the -c 64 DeNBFMSync 10 scan tracker's first (64, F) "
                "panel (13b), max_abs_err_13a over 13a's real and complex rows",
        "launches": scan["13b"]["tracker"]["launches"]["symsync_scan"],
        "launches_per_step": scan["13b"]["tracker"]["k8_launches_per_step"],
        "max_abs_err": scan["13b"]["tracker"]["k8_vs_twin"]["max_err"],
        "max_abs_err_13a": max(scan["13a"][f"sync_{k}"]["max_err"] for k in ("real", "complex")),
        "shape": scan["13b"]["tracker"]["k8_shape"],
    }, {
        "name": "symsync_block",
        "route": "cuda",
        "source": "csdr_tpu_torch/csrc/symsync_block.cu",
        "replaces": "csdr_tpu/models/symsync.py:180",
        "note": "K9, no Pallas counterpart: SymSync.apply's jnp gathers (block mode). "
                "launches read the -c 64 DeNBFMSync 10 pfb_fused CLI run (9b, 2 a block); "
                "max_abs_err (either pick, relative to the largest output, occupied "
                "channels) and tau_err against the plain version at that flow's (64, F) panel",
        "launches": sync["9b"]["runs"]["pfb_fused"]["launches"]["symsync_block"],
        "launches_eager_run": sync["9b"]["runs"]["eager"]["launches"]["symsync_block"],
        "max_abs_err": sync["9b"]["k9"]["vs_plain"][0],
        "tau_err": sync["9b"]["k9"]["tau_err"],
        "shape": sync["9b"]["k9"]["shape"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(mesh_only=sys.argv[1:2] == ["--mesh-only"],
                  sync_only=sys.argv[1:2] == ["--sync-only"],
                  imagery_only=sys.argv[1:2] == ["--imagery-only"],
                  device_only=sys.argv[1:2] == ["--device-only"],
                  chain_only=sys.argv[1:2] == ["--chain-only"],
                  scan_only=sys.argv[1:2] == ["--scan-only"]))
