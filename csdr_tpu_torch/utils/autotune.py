"""On-disk cache of the CUDA kernels' tile sizes, one entry per card.

Counterpart of ``csdr_tpu/utils/autotune.py``.  The fused kernels' free
scheduling knob is ``tileF``, frames per tile; the best value depends on
the kernel, ``nch``, the input and the card.  ``FlagshipFused``,
``PFBFusedFM`` and ``PFBFusedChannelizer`` built with ``tileF=None``, and
the ``--mesh`` CLI's flagship, take ``lookup(...)``; ``sweep(...)`` times
candidates on the card and records the winner (``chip_smoke.py`` phase
11d sweeps K1).

The cache is ``$CSDR_TPU_TORCH_AUTOTUNE_CACHE`` or
``$XDG_CACHE_HOME/csdr_tpu_torch/autotune.json`` (``~/.cache/...``), a file
of its own: the JAX package's cache holds TPU tiles.  Entries are keyed
``kernel:<card>:nch[:variant]``, ``<card>`` being
``torch.cuda.get_device_name()`` (``cpu`` without a card), and keep the
winning tile, its rate and the whole sweep.  Without an entry ``lookup``
returns the kernel's own ``DEFAULT_TILE_F``, so nothing changes on a
machine with no cache; a cache that does not parse is ignored.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable

import torch

from ..ops.cuda import flagship_fused as _ff
from ..ops.cuda import pfb_fused as _pf

__all__ = ["lookup", "record", "sweep", "has_entry", "best_msps", "cache_path", "card",
           "DEFAULTS"]

_CACHE_ENV = "CSDR_TPU_TORCH_AUTOTUNE_CACHE"

# the tile each kernel's wrapper takes by default (K1/K2, K3, K4)
DEFAULTS = {
    "flagship_fused": _ff.DEFAULT_TILE_F,
    "pfb_fm_fused": _pf.DEFAULT_TILE_F,
    "pfb_channelize_fused": _pf.DEFAULT_TILE_F,
}


def cache_path() -> str:
    p = os.environ.get(_CACHE_ENV)
    if p:
        return p
    root = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(root, "csdr_tpu_torch", "autotune.json")


def card() -> str:
    """The name keys carry: the current CUDA card's, or ``cpu``."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def _load() -> dict:
    try:
        with open(cache_path()) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return {}
    return d if isinstance(d, dict) else {}


def _store(d: dict) -> None:
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(d, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _key(kernel: str, nch: int, variant: str | None, card_name: str | None) -> str:
    k = f"{kernel}:{card_name or card()}:{nch}"
    return f"{k}:{variant}" if variant else k


def has_entry(kernel: str, nch: int, variant: str | None = None,
              card_name: str | None = None) -> bool:
    """Whether the cache holds a measured entry for this key."""
    return _key(kernel, nch, variant, card_name) in _load()


def best_msps(kernel: str, nch: int, variant: str | None = None,
              card_name: str | None = None) -> float | None:
    """The cached winner's rate (MS/s) for this key, or None."""
    ent = _load().get(_key(kernel, nch, variant, card_name))
    return float(ent["msps"]) if isinstance(ent, dict) and "msps" in ent else None


def lookup(kernel: str, nch: int, default: int | None = None, variant: str | None = None,
           card_name: str | None = None) -> int:
    """The best-known tileF for (kernel, nch, variant) on the card; without
    an entry ``DEFAULTS[kernel]``, then ``default``; KeyError without
    either."""
    ent = _load().get(_key(kernel, nch, variant, card_name))
    if isinstance(ent, dict) and "tileF" in ent:
        return int(ent["tileF"])
    if kernel in DEFAULTS:
        return DEFAULTS[kernel]
    if default is not None:
        return default
    raise KeyError(f"no autotune entry or default for {kernel}")


def record(kernel: str, nch: int, tileF: int, msps: float, variant: str | None = None,
           card_name: str | None = None, sweep_results: list | None = None) -> None:
    d = _load()
    d[_key(kernel, nch, variant, card_name)] = {
        "tileF": int(tileF), "msps": float(msps), "ts": time.time(),
        **({"sweep": sweep_results} if sweep_results else {}),
    }
    _store(d)


def sweep(kernel: str, nch: int, candidates: Iterable[int], bench_fn: Callable[[int], float],
          variant: str | None = None, card_name: str | None = None, verbose: bool = False):
    """Call ``bench_fn(tileF)`` (a rate, MS/s) for each candidate and record
    the fastest.  A candidate that raises (a tile the kernel's checks
    refuse, too much shared memory) is recorded as infeasible and skipped;
    RuntimeError where none ran.  Returns ``(best_tileF, results)``,
    results ``[{"tileF": t, "msps": x} | {"tileF": t, "error": str}, ...]``."""
    results = []
    best_t, best_m = None, -1.0
    for t in candidates:
        try:
            m = float(bench_fn(t))
        except Exception as e:  # an infeasible tile: keep sweeping
            results.append({"tileF": t, "error": f"{type(e).__name__}: {e}"[:200]})
            if verbose:
                print(f"#   tileF={t}: infeasible ({type(e).__name__})", flush=True)
            continue
        results.append({"tileF": t, "msps": m})
        if verbose:
            print(f"#   tileF={t}: {m:.1f} MSPS", flush=True)
        if m > best_m:
            best_t, best_m = t, m
    if best_t is None:
        raise RuntimeError(f"autotune sweep for {kernel}: no feasible candidate")
    record(kernel, nch, best_t, best_m, variant=variant, card_name=card_name,
           sweep_results=results)
    return best_t, results
