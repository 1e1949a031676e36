"""The benchmark's one traffic generator: the blocks of a cell's input,
made on the card from ``--seed`` as the cell's traffic file sets them.

Frozen copies, each adapted as its note says, of the repo's generators:

* ``occupied_band`` and ``to_cu8``: ``chip_smoke.py`` ``occupied_band``,
  ``to_cu8``.  Adapted: the samples are [t0, t0 + n) of a stream that
  repeats every ring of blocks without a seam (its tones on whole cycles
  a ring), and the noise comes from a ``torch.Generator`` on the device.
* ``sync_capture``, ``heli_text``, ``heli_levels``: ``chip_smoke.py``
  ``sync_capture``, ``heli_text``, ``heli_levels`` (``host_noise`` as a
  device generator).  Adapted: the capture is made a block at a time, the
  FSK phase carried across the blocks in float64.

Kinds (``"signal"`` in a traffic file) and their ``"signal_args"``:

* ``"occupied_band"``: an FM carrier on every channel centre over noise;
  ``{"nch", "noise"}``.  The ring's blocks are consecutive pieces of it.
* ``"sync_capture"``: helicopter 2-FSK on some channels of a 64-way split,
  each with its own symbol clock, over noise;
  ``{"nch", "k", "channels", "ppm", "amp", "noise"}``.
"""

from __future__ import annotations

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def _gen(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key``."""
    s = np.random.SeedSequence([int(k) & SEED_MASK for k in key]).generate_state(2, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(s[0]) & SEED_MASK)
    return g


def to_cu8(x: torch.Tensor) -> torch.Tensor:
    """complex → rtl_sdr uint8 rows (n, 2), 60 LSB per unit (copied from
    ``chip_smoke.to_cu8``, rows in place of the flat bytes)."""
    ri = torch.view_as_real(x) * 60.0 + 127.5
    return torch.clamp(torch.round(ri), 0, 255).to(torch.uint8)


def occupied_band(args: dict, seed: int, t0: int, n: int, period: int,
                  device) -> torch.Tensor:
    """Samples [t0, t0 + n) of a stream that repeats every ``period``
    samples: an FM carrier on every channel centre (channel k at
    (k − (nch−1)/2)/nch cycles/sample), each modulated by its own tone
    (quantized to whole cycles a period, so the stream has no seam where
    it repeats), plus noise, in float64 on the device, as complex64."""
    nch = args["nch"]
    rng = np.random.default_rng([int(seed) & SEED_MASK, 0])
    tones = np.round(0.002 / nch * (1 + np.arange(nch) % 5) * rng.uniform(0.8, 1.2, nch)
                     * period) / period
    phases = rng.uniform(0, 2 * np.pi, nch)
    t = torch.arange(t0, t0 + n, dtype=torch.float64, device=device)
    x = torch.zeros(n, dtype=torch.complex128, device=device)
    amp = 0.6 / np.sqrt(nch)
    for k in range(nch):
        fc = (k - (nch - 1) / 2) / nch
        ph = (2 * np.pi * torch.remainder(fc * t, 1.0)
              + 2.0 * torch.sin(2 * np.pi * torch.remainder(float(tones[k]) * t, 1.0))
              + float(phases[k]))
        x += amp * torch.polar(torch.ones_like(ph), ph)
    g = _gen(device, seed, t0, 1)
    noise = torch.randn((n, 2), generator=g, device=device, dtype=torch.float32) * args["noise"]
    x += torch.view_as_complex(noise).to(torch.complex128)
    return x.to(torch.complex64)


def heli_text(ch: int) -> str:
    """Channel ch's two coordinate records (copied from ``chip_smoke``)."""
    return (f"AN {40 + ch % 50:02d} {10 + ch % 49:02d}{13 * ch % 100:02d}\r\n"
            f"BW {10 + ch % 80:02d} {20 + ch % 39:02d}{7 * ch % 100:02d}\r\n")


def heli_levels(text: str, nsym: int) -> np.ndarray:
    """The helicopter frame layout, 710-bit frames of 71 10-bit characters
    between 20-bit syncs, as ±1 symbol levels (bit '0' → +1), repeated to at
    least nsym symbols (copied from ``chip_smoke``)."""
    payload = (b"\xff\xff" + (text * 3).encode())[:71]
    frame = "".join("".join("1" if (b >> j) & 1 else "0" for j in range(8)) + "11"
                    for b in payload)
    unit = "1100000000" + "0100000000" + frame
    bits = unit * (nsym // len(unit) + 2)
    return np.where(np.frombuffer(bits.encode(), np.uint8) == ord("0"), 1.0, -1.0)


def sync_capture(args: dict, seed: int, nblocks: int, n: int, device) -> np.ndarray:
    """A capture of ``nblocks`` blocks of ``n`` samples as host cu8 rows
    (nblocks·n, 2): helicopter 2-FSK (±0.1 cycles/sample at the channel
    rate) on ``channels`` of an nch-way split, each with its own text,
    start phase and symbol clock (±ppm), over noise."""
    nch, k = args["nch"], args["k"]
    total = nblocks * n
    rng = np.random.default_rng([int(seed) & SEED_MASK, 1000])
    spb = k * nch                              # input samples per symbol
    dev_c = 0.02 * k * 0.5 / nch               # deviation, cycles per input sample
    chans = []
    for ch in args["channels"]:
        eps = rng.uniform(-args["ppm"], args["ppm"])
        d0, c0 = rng.uniform(0, spb), rng.uniform(0, 1)
        lv = torch.from_numpy(heli_levels(heli_text(ch), int(total / spb) + 4)).to(device)
        chans.append(dict(ch=ch, eps=eps, d0=d0, c0=c0, lv=lv, carry=0.0))
    out = np.empty((total, 2), np.uint8)
    for b in range(nblocks):
        t = torch.arange(b * n, (b + 1) * n, dtype=torch.float64, device=device)
        g = _gen(device, seed, b, 2)
        noise = torch.randn((n, 2), generator=g, device=device, dtype=torch.float32)
        x = torch.view_as_complex(noise * args["noise"])
        for c in chans:
            sym = torch.floor((t + c["d0"]) / (spb * (1 + c["eps"]))).to(torch.int64)
            inc = c["lv"][sym] * dev_c
            fc = (c["ch"] - (nch - 1) / 2) / nch
            cyc = c["c0"] + c["carry"] + torch.cumsum(inc, 0) + fc * t
            c["carry"] += float(inc.sum())
            cyc -= torch.floor(cyc)
            x = x + (args["amp"] * torch.polar(torch.ones_like(cyc), 2 * np.pi * cyc)).to(
                torch.complex64)
        out[b * n:(b + 1) * n] = to_cu8(x).cpu().numpy()
    return out
