"""The port's tile cache (csdr_tpu_torch/utils/autotune.py): lookup,
record and sweep as tests/test_autotune.py holds the JAX package's, keys
per card, and the call sites (FlagshipFused, PFBFusedFM,
PFBFusedChannelizer with tileF=None; the CLI's fused flow).  The cache
variable points at tmp_path in every test."""

import json
import os

import numpy as np
import pytest
import torch

from csdr_tpu_torch.apps.soapy_sdr_cli import main
from csdr_tpu_torch.blocks.fused_blocks import FlagshipFused, PFBFusedChannelizer, PFBFusedFM
from csdr_tpu_torch.ops.cuda import flagship_fused as ff
from csdr_tpu_torch.ops.cuda import pfb_fused as pf
from csdr_tpu_torch.utils import autotune

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    p = str(tmp_path / "autotune.json")
    monkeypatch.setenv("CSDR_TPU_TORCH_AUTOTUNE_CACHE", p)
    return p


def test_lookup_falls_back_to_the_kernels_defaults(cache):
    assert autotune.DEFAULTS == {"flagship_fused": ff.DEFAULT_TILE_F,
                                 "pfb_fm_fused": pf.DEFAULT_TILE_F,
                                 "pfb_channelize_fused": pf.DEFAULT_TILE_F}
    for kernel, tile in autotune.DEFAULTS.items():
        assert autotune.lookup(kernel, 64) == tile
        assert autotune.lookup(kernel, 64, variant="u8") == tile
    assert autotune.lookup("no_such_kernel", 64, default=7) == 7
    with pytest.raises(KeyError):
        autotune.lookup("no_such_kernel", 64)
    assert not os.path.exists(cache)


def test_record_then_lookup_roundtrip(cache):
    autotune.record("flagship_fused", 64, 128, 123.4, card_name=H100)
    assert autotune.lookup("flagship_fused", 64, card_name=H100) == 128
    assert autotune.lookup("flagship_fused", 32, card_name=H100) == ff.DEFAULT_TILE_F
    assert autotune.has_entry("flagship_fused", 64, card_name=H100)
    assert autotune.best_msps("flagship_fused", 64, card_name=H100) == pytest.approx(123.4)
    d = json.load(open(cache))
    assert d[f"flagship_fused:{H100}:64"]["msps"] == pytest.approx(123.4)
    autotune.record("flagship_fused", 64, 64, 150.0, card_name=H100)  # a later sweep wins
    assert autotune.lookup("flagship_fused", 64, card_name=H100) == 64


def test_sweep_picks_winner_and_records_infeasible(cache):
    def bench(t):
        if t == 512:
            raise ValueError("needs 270000 B of shared memory per block")
        return {64: 10.0, 128: 30.0, 256: 20.0}[t]

    best, results = autotune.sweep("pfb_fm_fused", 64, (64, 128, 256, 512), bench,
                                   card_name=H100)
    assert best == 128 and autotune.lookup("pfb_fm_fused", 64, card_name=H100) == 128
    by_t = {r["tileF"]: r for r in results}
    assert "ValueError" in by_t[512]["error"] and by_t[256]["msps"] == 20.0
    assert len(json.load(open(cache))[f"pfb_fm_fused:{H100}:64"]["sweep"]) == 4


def test_sweep_all_infeasible_raises(cache):
    def bad(t):
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError, match="no feasible"):
        autotune.sweep("pfb_fm_fused", 64, (64, 128), bad, card_name=H100)
    assert not autotune.has_entry("pfb_fm_fused", 64, card_name=H100)


def test_a_cards_key_never_reads_another_cards_or_the_tpus(cache, monkeypatch, tmp_path):
    """Entries of another card, the JAX package's TPU keys in the same file,
    and the JAX package's own cache file are all invisible to this card."""
    autotune.record("flagship_fused", 64, 256, 99.0, card_name=H100)
    d = json.load(open(cache))
    d["flagship_fused_wide:tpu:64"] = {"tileF": 4096, "msps": 1.0}
    d["flagship_fused:tpu:64"] = {"tileF": 2048, "msps": 1.0}
    json.dump(d, open(cache, "w"))
    jax_cache = tmp_path / "jax_autotune.json"
    jax_cache.write_text(json.dumps({"flagship_fused:cpu:64": {"tileF": 1024, "msps": 5.0}}))
    monkeypatch.setenv("CSDR_AUTOTUNE_CACHE", str(jax_cache))
    assert autotune.card() == ("cpu" if not torch.cuda.is_available()
                               else torch.cuda.get_device_name())
    for other in ("cpu", "NVIDIA A100-SXM4-80GB"):
        assert not autotune.has_entry("flagship_fused", 64, card_name=other)
        assert autotune.lookup("flagship_fused", 64, card_name=other) == ff.DEFAULT_TILE_F
        assert autotune.best_msps("flagship_fused_wide", 64, card_name=other) is None
    assert autotune.lookup("flagship_fused", 64, card_name=H100) == 256


def test_blocks_take_the_cached_tile(cache):
    """tileF=None takes this card's entry (else the default); the granule
    follows; an explicit tileF wins."""
    assert FlagshipFused(64).tileF == ff.DEFAULT_TILE_F
    card = autotune.card()
    autotune.record("flagship_fused", 64, 128, 1.0, card_name=card)
    autotune.record("pfb_fm_fused", 16, 32, 1.0, card_name=card)
    autotune.record("pfb_channelize_fused", 16, 16, 1.0, card_name=card)
    assert FlagshipFused(64).tileF == 128 and FlagshipFused(64).granule == 64 * 128
    assert FlagshipFused(32).tileF == ff.DEFAULT_TILE_F
    assert FlagshipFused(64, tileF=16).tileF == 16
    assert PFBFusedFM(16).tileF == 32 and PFBFusedFM(16).granule == 16 * 32
    assert PFBFusedChannelizer(16).tileF == 16 and PFBFusedChannelizer(16).granule == 256
    autotune.record("flagship_fused", 64, 128, 1.0, card_name="some other card")
    autotune.record("flagship_fused", 8, 64, 1.0, card_name="some other card")
    assert FlagshipFused(8).tileF == ff.DEFAULT_TILE_F


def test_cli_fused_flow_with_a_cached_tile(cache, tmp_path):
    """The fused CLI flow on the CPU with a cached tile writes the same
    files as with none (the tile only moves the block size)."""
    rng = np.random.default_rng(2)
    n = 8 * 64 * 12 + 40
    x = (0.5 * np.exp(2j * np.pi * np.mod(0.19 * np.arange(n), 1.0))
         + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    x.tofile(tmp_path / "cap.cf32")
    argv = ["--filename", str(tmp_path / "cap.cf32"), "-n", str(n), "-c", "8", "--demod",
            "DeNBFM 0.6 F32", "--backend", "fused", "--blocksize", "4096", "--device", "cpu"]
    assert main(argv + ["-o", str(tmp_path / "a")]) == 0
    autotune.record("flagship_fused", 8, 64, 1.0, card_name=autotune.card())
    assert main(argv + ["-o", str(tmp_path / "b")]) == 0
    for i in range(1, 9):
        a = np.fromfile(tmp_path / f"a_ch{i}.f32", np.float32)
        b = np.fromfile(tmp_path / f"b_ch{i}.f32", np.float32)
        assert a.shape == (n // 8,) and np.array_equal(a, b), i


def test_corrupt_cache_is_ignored(cache):
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    with open(cache, "w") as f:
        f.write("{not json")
    assert autotune.lookup("flagship_fused", 64) == ff.DEFAULT_TILE_F
    assert autotune.best_msps("flagship_fused", 64) is None
    autotune.record("flagship_fused", 64, 64, 2.0)  # a record replaces the corrupt file
    assert autotune.lookup("flagship_fused", 64) == 64


def test_default_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("CSDR_TPU_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune.cache_path() == str(tmp_path / "csdr_tpu_torch" / "autotune.json")
