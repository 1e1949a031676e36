"""``Pipeline(profile=True)`` and the CLI's ``--profile`` in the port, on the
CPU (tests/test_profile.py's cases): the profiled output equals the
unprofiled output bit for bit, the per-stage statistics count every block
with the first call apart, the report names every stage, and ``--profile``
prints the table and leaves the files as they are without it."""

import os

import numpy as np
import pytest
import torch

import csdr_tpu_torch as ct
from csdr_tpu_torch.apps.soapy_sdr_cli import main
from csdr_tpu_torch.utils import prof

torch.set_num_threads(1)
CPU = torch.device("cpu")


def wbfm_graph():
    return ct.chain(ct.dc_blocker(), ct.fm_demodulator(0.6), ct.fir_decimator(4))


def fm_iq(n, f=0.01, kf=0.6):
    msg = 0.4 * np.sin(2 * np.pi * f * np.arange(n))
    return np.exp(2j * np.pi * kf * np.cumsum(msg)).astype(np.complex64)


@pytest.mark.parametrize("graph", [wbfm_graph, lambda: ct.fm_demodulator(0.6)],
                         ids=["chain", "one_block"])
def test_profiled_pipeline_matches_unprofiled(graph):
    n = 1 << 14
    iq = fm_iq(n)
    plain = ct.Pipeline(graph(), block_size=4096, device=CPU)
    profd = ct.Pipeline(graph(), block_size=4096, device=CPU, profile=True)
    a = [plain.process_block(iq[i:i + 4096]).numpy() for i in range(0, n, 4096)]
    b = [profd.process_block(iq[i:i + 4096]).numpy() for i in range(0, n, 4096)]
    assert np.array_equal(np.concatenate(a), np.concatenate(b))
    assert type(profd.state) is type(plain.state)


def test_profile_stats_and_report():
    n = 1 << 14
    pipe = ct.Pipeline(wbfm_graph(), block_size=4096, device=CPU, profile=True)
    assert pipe.run(iter([fm_iq(n)]), lambda y: None) == n // 4
    assert [s.name for s in pipe.stage_stats] == ["dc_blocker", "fm_demod(0.6)", "fir_decim(4)"]
    for st in pipe.stage_stats:
        assert st.calls == 4  # n / block_size; the first counted apart
        assert st.samples == (st.calls - 1) * 4096
        assert st.compile_seconds > 0 and st.seconds > 0 and st.msps > 0
    rep = pipe.profile_report()
    assert "MSPS_in" in rep and "dc_blocker" in rep and "TOTAL" in rep
    assert "disabled" in ct.Pipeline(wbfm_graph(), 4096, device=CPU).profile_report()


def test_stage_stat_rates_follow_the_graph():
    """A stage after a 1:4 decimator counts a quarter of the input."""
    pipe = ct.Pipeline(ct.chain(ct.fir_decimator(4, complex_input=True),
                                ct.fm_demodulator(0.6)), block_size=4096, device=CPU,
                       profile=True)
    pipe.run(iter([fm_iq(3 * 4096)]), lambda y: None)
    assert [s.samples for s in pipe.stage_stats] == [2 * 4096, 2 * 1024]


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "tr")):
        wbfm_graph().apply(wbfm_graph().init(CPU), torch.from_numpy(fm_iq(4096)))
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("backend", ["eager", "pfb_fused", "fused"])
def test_cli_profile_flag(tmp_path, capsys, backend):
    n = 8 * 4096 + 40
    cap = tmp_path / "in.cf32"
    fm_iq(n, f=0.003).tofile(cap)
    common = ["--filename", str(cap), "-n", str(n), "-c", "8", "--blocksize", "4096",
              "--demod", "DeNBFM 0.6 F32", "--backend", backend, "--device", "cpu"]
    assert main(common + ["-o", str(tmp_path / "prof"), "--profile"]) == 0
    out = capsys.readouterr().out
    assert "Per-stage budget" in out and "pct" in out and "TOTAL" in out
    assert {"eager": "pfb_channelizer(8)", "pfb_fused": "pfb_fused_fm(8)",
            "fused": "flagship_fused(8)"}[backend] in out
    assert main(common + ["-o", str(tmp_path / "plain")]) == 0
    assert "Per-stage" not in capsys.readouterr().out
    for i in range(1, 9):
        a = np.fromfile(tmp_path / f"prof_ch{i}.f32", np.float32)
        b = np.fromfile(tmp_path / f"plain_ch{i}.f32", np.float32)
        assert a.size == n // 8 and np.array_equal(a, b)
    assert os.path.exists(tmp_path / "plain_ch8.f32")


def test_cli_profile_matches_jax_cli(tmp_path, capsys):
    """tests/test_profile.py's CLI case on the same file through both CLIs:
    both print the stage table, and the port's WAV is within 2e-5 of the
    JAX CLI's (tests/test_golden.py)."""
    from scipy.io import wavfile

    from csdr_tpu.apps.soapy_sdr_cli import main as jax_main

    n = 1 << 14
    fm_iq(n).tofile(tmp_path / "in.cf32")
    common = ["--filename", str(tmp_path / "in.cf32"), "-s", "256000", "-n", str(n),
              "--demod", "DeWBFM 4 WAV", "--profile", "--blocksize", "4096"]
    outs = {}
    for cli, name, extra in ((jax_main, "j", []), (main, "p", ["--device", "cpu"])):
        assert cli(common + extra + ["-o", str(tmp_path / name)]) == 0
        out = capsys.readouterr().out
        assert "Per-stage budget" in out and "pct" in out and "fir_decim(4)" in out
        outs[name] = wavfile.read(tmp_path / f"{name}.wav")[1].astype(np.float64)
    assert outs["p"].shape == outs["j"].shape == (n // 4,)
    assert np.max(np.abs(outs["p"] - outs["j"])) / np.max(np.abs(outs["j"])) < 2e-5
