"""The port's span-and-counter recorder (``csdr_tpu_torch/utils/prof``) in
``Pipeline`` and ``Chain.apply``, on the CPU: spans nest by parent id and a
step's spans share its number, ``PerChannel``'s inner stages nest under it,
nothing is recorded with the recorder off, spans are recorded inside
``prof.recording()`` and inside a ``torch.profiler`` session (as host ranges
of its trace too, on its clock), the output is bit-identical with the
recorder on or off, and the byte counters equal the blocks' and outputs'
bytes.  The card's side (stage device intervals, no barrier in
``profile=True``) is in ``tests/test_torch_cuda.py``."""

import json

import numpy as np
import pytest
import torch

import csdr_tpu_torch as ct
from csdr_tpu_torch.models.receivers import channelized_receiver
from csdr_tpu_torch.utils import prof

torch.set_num_threads(1)
CPU = torch.device("cpu")
BLOCK = 4096


def wbfm_graph():
    return ct.chain(ct.dc_blocker(), ct.fm_demodulator(0.6), ct.fir_decimator(4))


def fm_iq(n, f=0.01, kf=0.6):
    msg = 0.4 * np.sin(2 * np.pi * f * np.arange(n))
    return np.exp(2j * np.pi * kf * np.cumsum(msg)).astype(np.complex64)


def run(graph, x, block=BLOCK):
    outs = []
    ct.Pipeline(graph, block, device=CPU).run(iter([x]), outs.append)
    return outs


def test_spans_nest_by_parent_and_share_their_step():
    n = 3 * BLOCK + 100   # three full blocks and a padded fourth
    with prof.recording() as rec:
        run(wbfm_graph(), fm_iq(n))
    spans = rec.read()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.name == "pipeline.block"]
    assert [r.block for r in roots] == [0, 1, 2, 3, 4] and all(r.parent is None for r in roots)
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.block == s.block and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    names = [s.name for s in spans if s.block == 1]
    assert names == ["pipeline.block", "pipeline.stage", "pipeline.apply", "dc_blocker",
                     "fm_demod(0.6)", "fir_decim(4)", "pipeline.drain_wait", "pipeline.trim",
                     "pipeline.sink"]
    applies = {s.id for s in spans if s.name == "pipeline.apply"}
    stages = [s for s in spans if s.parent in applies]
    assert len(stages) == 3 * 4 and {s.name for s in stages} == {
        "dc_blocker", "fm_demod(0.6)", "fir_decim(4)"}
    # the last step feeds nothing and drains the last block; sinks are roots
    assert [s.name for s in spans if s.block == 4] == [
        "pipeline.block", "pipeline.drain_wait", "pipeline.trim", "pipeline.sink"]
    assert all(s.parent is None for s in spans if s.name == "pipeline.sink")
    assert all(s.device_ms is None for s in spans)   # no card: no events
    assert rec.last_run() == spans


def test_per_channel_inner_stages_nest_under_it():
    nch = 4
    graph = channelized_receiver(nch, ct.chain(ct.fm_demodulator(0.6), ct.fir_decimator(2)))
    with prof.recording() as rec:
        run(graph, fm_iq(2 * graph.granule * 16), block=graph.granule * 16)
    spans = rec.read()
    per = [s for s in spans if s.name.startswith("per_channel[")]
    assert len(per) == 2
    for p in per:
        inner = [s for s in spans if s.parent == p.id]
        assert [s.name for s in inner] == ["fm_demod(0.6)", "fir_decim(2)"]
        assert all(s.block == p.block for s in inner)


def test_nothing_is_recorded_with_the_recorder_off():
    before = len(prof.SESSION)
    with prof.recording() as rec:
        pass
    run(wbfm_graph(), fm_iq(2 * BLOCK))
    assert len(rec) == 0 and len(prof.SESSION) == before
    assert prof.span("pipeline.apply") is prof.OFF
    assert prof.stage(ct.dc_blocker(), torch.zeros(4)) is prof.OFF


def test_spans_inside_recording_and_inside_a_profiler_session():
    x = fm_iq(2 * BLOCK)
    with prof.recording() as rec:
        run(wbfm_graph(), x)
    assert sum(s.name == "pipeline.apply" for s in rec.read()) == 2
    from torch.profiler import ProfilerActivity, profile

    prof.SESSION.clear()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        run(wbfm_graph(), x)
    got = prof.SESSION.last_run()
    assert [s.name for s in got] == [s.name for s in rec.read()]
    # each span is also a host range of the trace, inside the span on the
    # profiler's clock (read-out converts as the profiler does)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in p.profiler.kineto_results.events() if e.name() == "pipeline.apply")
    spans = [(s.start_ns, s.end_ns) for s in got if s.name == "pipeline.apply"]
    assert len(ranges) == len(spans) == 2
    slack = 20_000   # ns
    for (r0, r1), (s0, s1) in zip(ranges, spans):
        assert s0 - slack <= r0 <= r1 <= s1 + slack


@pytest.mark.parametrize("profile", [False, True], ids=["plain", "profile"])
def test_output_is_bit_identical_with_the_recorder_on_and_off(profile):
    x = fm_iq(3 * BLOCK + 999)

    def outputs():
        outs = []
        ct.Pipeline(wbfm_graph(), BLOCK, device=CPU, profile=profile).run(iter([x]),
                                                                         outs.append)
        return np.concatenate(outs)

    off = outputs()
    with prof.recording():
        on = outputs()
    assert off.dtype == on.dtype and np.array_equal(off, on)


def test_trace_writes_the_programs_spans(tmp_path):
    with prof.trace(str(tmp_path / "tr")):
        run(wbfm_graph(), fm_iq(2 * BLOCK))
    names = {e.get("name") for e in json.loads(
        (tmp_path / "tr" / "trace.json").read_text())["traceEvents"]}
    assert {"pipeline.block", "pipeline.apply", "fm_demod(0.6)", "pipeline.sink"} <= names
    assert [s.block for s in prof.SESSION.read() if s.name == "pipeline.block"] == [0, 1, 2]


def test_counters_equal_the_bytes_of_blocks_and_outputs():
    n = 2 * BLOCK + 10
    graph = ct.chain(ct.fm_demodulator(0.6), ct.Tee(ct.fir_decimator(4), ct.fir_decimator(2)))
    with prof.recording() as rec:
        ct.Pipeline(graph, BLOCK, device=CPU).run(iter([fm_iq(n)]), lambda y: None)
    blocks = 3   # padded to the block size
    assert rec.counters["pipeline.h2d_bytes"] == blocks * BLOCK * 8   # complex64 in
    assert rec.counters["pipeline.d2h_bytes"] == blocks * (BLOCK // 4 + BLOCK // 2) * 4


def test_a_checkpoint_is_a_span_of_its_step(tmp_path):
    with prof.recording() as rec:
        ct.Pipeline(wbfm_graph(), BLOCK, device=CPU).run(
            iter([fm_iq(3 * BLOCK)]), lambda y: None,
            checkpoint_path=str(tmp_path / "ck"), checkpoint_every=2 * BLOCK)
    spans = rec.read()
    ck = [s for s in spans if s.name == "pipeline.checkpoint"]
    assert [s.block for s in ck] == [1] and ck[0].parent is None
    # the step that checkpoints drains its own block too, before the sinks
    assert [s.name for s in spans if s.block == 1].count("pipeline.drain_wait") == 2


def test_profiled_lone_block_is_one_stage_with_the_pipelines_spans():
    pipe = ct.Pipeline(ct.fm_demodulator(0.6), BLOCK, device=CPU, profile=True)
    pipe.run(iter([fm_iq(3 * BLOCK)]), lambda y: None)
    (st,) = pipe.stage_stats
    assert st.name == "fm_demod(0.6)" and st.calls == 3 and st.samples == 2 * BLOCK
    assert st.seconds > 0 and st.host_seconds > 0
    rep = pipe.profile_report()
    for name in ("pipeline.stage", "pipeline.apply", "pipeline.drain_wait", "pipeline.trim",
                 "pipeline.sink", "MB copied per block", "h2d 0.033"):
        assert name in rep, rep
