"""Checkpoint and resume in the port: counterparts of tests/test_checkpoint.py
(bit-identical resume, signature mismatch, round-trip structure, periodic
checkpoints, a path without ``.npz``, the position never ahead of the
drained output), and the same for a dict state (the stereo decoder), the
fused blocks on their plain versions, and a refused swap of layouts."""

import os

import numpy as np
import pytest
import torch

import csdr_tpu_torch as ct
from csdr_tpu_torch.blocks.fused_blocks import FlagshipFused, PFBFusedFM
from csdr_tpu_torch.core import checkpoint as ckpt_mod
from csdr_tpu_torch.core.checkpoint import (load_state, resume_pipeline, save_pipeline,
                                            save_state)
from csdr_tpu_torch.core.runtime import Pipeline, skip_n
from csdr_tpu_torch.models.stereo import stereo_fm_decoder

torch.set_num_threads(1)

CPU = torch.device("cpu")


def graph():
    return ct.chain(ct.dc_blocker(), ct.mix_down(0.3), ct.fm_demodulator(0.6),
                    ct.fir_decimator(4))


def noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def test_resume_is_bit_identical(tmp_path):
    n, bs = 1 << 16, 1 << 14
    x = noise(n, 0)
    s0 = ct.CollectSink()
    Pipeline(graph(), bs, device=CPU).run(iter([x]), s0)

    half = n // 2
    p1 = Pipeline(graph(), bs, device=CPU)
    s1 = ct.CollectSink()
    p1.run(iter([x[:half]]), s1)
    ck = str(tmp_path / "ck.npz")
    save_pipeline(ck, p1, position=half)

    p2 = Pipeline(graph(), bs, device=CPU)
    pos = resume_pipeline(ck, p2)
    assert pos == half
    s2 = ct.CollectSink()
    p2.run(skip_n(iter([x]), pos), s2)
    assert np.array_equal(np.concatenate([s1.concat(), s2.concat()]), s0.concat())


def test_signature_mismatch_rejected(tmp_path):
    p = Pipeline(graph(), 1 << 12, device=CPU)
    ck = str(tmp_path / "a.npz")
    save_pipeline(ck, p, position=0)
    other = Pipeline(ct.chain(ct.dc_blocker(), ct.am_demodulator()), 1 << 12, device=CPU)
    with pytest.raises(ValueError):
        resume_pipeline(ck, other)


def test_state_roundtrip_structure(tmp_path):
    blk = ct.firpfbch_channelizer(8)
    st = blk.init(CPU)
    st = (st[0] + 1.5, (st[1][0] + 2.0, st[1][1] - 1j))
    path = str(tmp_path / "s.npz")
    save_state(path, st, position=123, signature="pfb")
    st2, pos = load_state(path, blk.init(CPU), CPU, signature="pfb")
    assert pos == 123
    for a, b in zip(_leaves(st), _leaves(st2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(path) as z:
        assert z["leaf_2"].dtype == np.complex64  # plain numpy leaves, no re/im encoding


def test_periodic_checkpoint_during_run(tmp_path):
    n = 1 << 15
    ck = str(tmp_path / "periodic.npz")
    Pipeline(graph(), 1 << 13, device=CPU).run(iter([noise(n, 7)]), ct.NullSink(),
                                                checkpoint_path=ck, checkpoint_every=1 << 14)
    assert os.path.exists(ck)
    assert resume_pipeline(ck, Pipeline(graph(), 1 << 13, device=CPU)) >= 1 << 14


def test_checkpoint_path_without_npz_extension(tmp_path):
    pipe = Pipeline(ct.dc_blocker(), 1024, device=CPU)
    pipe.process_block(noise(1024, 1))
    p = str(tmp_path / "job.ckpt")
    save_pipeline(p, pipe, position=1024)
    assert resume_pipeline(p, Pipeline(ct.dc_blocker(), 1024, device=CPU)) == 1024
    assert torch.equal(Pipeline(ct.dc_blocker(), 1024, device=CPU).state[0],
                       torch.zeros(1, dtype=torch.complex64))


def test_checkpoint_position_never_exceeds_drained_output(tmp_path, monkeypatch):
    """Each periodic checkpoint is written after the output of every input
    sample it covers reached the sink, although the runtime drains one step
    late."""
    seen = []
    real_save = ckpt_mod.save_pipeline
    sink = ct.CollectSink()

    def spy_save(path, pipeline, position):
        seen.append((position, sum(len(a) for a in sink.parts)))
        real_save(path, pipeline, position)

    monkeypatch.setattr(ckpt_mod, "save_pipeline", spy_save)
    Pipeline(ct.dc_blocker(), 4096, device=CPU).run(
        iter([noise(1 << 15, 2)]), sink, checkpoint_path=str(tmp_path / "c.npz"),
        checkpoint_every=8192)
    assert len(seen) == 4
    for position, drained in seen:
        assert drained >= position, (position, drained)  # rate 1: out == in


def _resume_matches_unbroken(tmp_path, make, x, bs, every, concat=np.concatenate):
    """Run ``make()`` over x whole with a checkpoint every ``every`` input
    samples; a new Pipeline resumed from the last checkpoint, fed
    skip_n(x, position), gives the unbroken run's output after that
    position bit for bit.  Returns the checkpoint's path."""
    ck = str(tmp_path / "run.npz")
    whole = ct.CollectSink()
    g = make()
    Pipeline(g, bs, device=CPU).run(iter([x]), whole, checkpoint_path=ck,
                                    checkpoint_every=every)
    p2 = Pipeline(make(), bs, device=CPU)
    pos = resume_pipeline(ck, p2)
    assert 0 < pos < len(x)
    rest = ct.CollectSink()
    p2.run(skip_n(iter([x[:pos // 3], x[pos // 3:]]), pos), rest)
    k = pos * g.rate.numerator // g.rate.denominator
    got, want = concat(rest.parts), concat(whole.parts)
    assert np.array_equal(got, want[..., k:])
    return ck


def test_stereo_dict_state_resume(tmp_path):
    """The stereo decoder carries a dict state (and owes a flush)."""
    quad = 192000.0
    t = np.arange(6 * 4096) / quad
    mpx = (0.4 * np.sin(2 * np.pi * 900 * t) + 0.1 * np.cos(2 * np.pi * 19000 * t)
           + 0.3 * np.sin(2 * np.pi * 2500 * t) * np.cos(2 * np.pi * 38000 * t)
           + 0.01 * np.random.default_rng(3).normal(size=len(t))).astype(np.float32)
    make = lambda: ct.chain(stereo_fm_decoder(quad, 4))  # noqa: E731
    _resume_matches_unbroken(tmp_path, make, mpx, 4096, 5 * 4096,
                             lambda parts: np.concatenate(parts, axis=-1))


@pytest.mark.parametrize("block", ["flagship_fused", "pfb_fused_fm", "eager"])
def test_channelized_resume_on_plain_versions(tmp_path, block):
    """FlagshipFused (dict state) and PFBFusedFM (3-tuple) on their plain
    versions, and the eager chain, resume bit for bit."""
    nch, tileF = 8, 16
    make = {"flagship_fused": lambda: FlagshipFused(nch, 0.6, tileF=tileF),
            "pfb_fused_fm": lambda: ct.chain(ct.dc_blocker(), PFBFusedFM(nch, 0.6, tileF=tileF)),
            "eager": lambda: ct.channelized_fm_receiver(nch, kf=0.6)}[block]
    t = np.arange(8 * nch * tileF * 4)
    x = (0.5 * np.exp(1j * (2 * np.pi * 0.07 * t + 2 * np.sin(2e-3 * t))) + noise(len(t), 4)
         * 0.02).astype(np.complex64)
    _resume_matches_unbroken(tmp_path, make, x, nch * tileF * 2, 3 * nch * tileF * 2,
                             lambda parts: np.concatenate(parts, axis=-1))


def test_swapped_layout_refused(tmp_path):
    """A FlagshipFused checkpoint is refused by the eager chain of the same
    nch: by the signature, and by the structure when no signature is
    asked for; and a PFBFusedFM state by a FlagshipFused."""
    nch = 8
    fused = Pipeline(FlagshipFused(nch, 0.6, tileF=16), 256, device=CPU)
    ck = str(tmp_path / "fused.npz")
    save_pipeline(ck, fused, position=0)
    eager = Pipeline(ct.channelized_fm_receiver(nch, kf=0.6), 256, device=CPU)
    with pytest.raises(ValueError, match="signature"):
        resume_pipeline(ck, eager)
    assert fused.block.name != eager.block.name
    with pytest.raises(ValueError):
        load_state(ck, eager.block.init(CPU), CPU)
    pfb = Pipeline(PFBFusedFM(nch, 0.6, tileF=16), 256, device=CPU)
    save_pipeline(ck, pfb, position=0)
    with pytest.raises(ValueError):
        load_state(ck, fused.block.init(CPU), CPU)


def test_dtype_and_shape_mismatch_refused(tmp_path):
    ck = str(tmp_path / "d.npz")
    save_state(ck, (torch.zeros(4), torch.zeros(2, dtype=torch.complex64)))
    with pytest.raises(ValueError, match="leaf 1"):
        load_state(ck, (torch.zeros(4), torch.zeros(2)), CPU)
    with pytest.raises(ValueError, match="leaf 0"):
        load_state(ck, (torch.zeros(5), torch.zeros(2, dtype=torch.complex64)), CPU)


def test_skip_n():
    chunks = [np.arange(5), np.arange(5, 12), np.arange(12, 20)]
    for n in (0, 3, 5, 11, 12, 19, 20):
        got = list(skip_n(iter(chunks), n))
        assert np.array_equal(np.concatenate(got) if got else np.zeros(0), np.arange(n, 20))
