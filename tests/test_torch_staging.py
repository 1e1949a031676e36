"""The Pipeline's staging step (``core/runtime._Staging``) on the CPU.

A block reaches the graph through ``Tensor.copy_`` from a tensor view of
the source's own array.  Every kind of block the Pipeline takes (complex64,
float32, cu8 (n, 2) uint8 rows; non-contiguous views; the zero-padded last
block; the read-only ``np.frombuffer`` arrays of the file sources) gives the
same output, bit for bit, as the former numpy assignment into a fresh
tensor, and no warning.  The pinned ring of two buffers runs on a card
only: ``tests/test_torch_cuda.py``."""

import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import csdr_tpu_torch as ct
from csdr_tpu_torch.core.runtime import _host_view
from csdr_tpu_torch.utils import prof

torch.set_num_threads(1)
CPU = torch.device("cpu")
BLOCK = 4096
REPO = Path(__file__).resolve().parents[1]


def numpy_staging(chunk: np.ndarray) -> torch.Tensor:
    """The former staging step on the CPU: a numpy assignment into a fresh
    tensor, the reference of these tests."""
    stage = torch.empty(chunk.shape, dtype=torch.from_numpy(np.empty(0, chunk.dtype)).dtype)
    stage.numpy()[...] = chunk
    return stage


def fm_iq(n, f=0.01, kf=0.6):
    msg = 0.4 * np.sin(2 * np.pi * f * np.arange(n))
    return np.exp(2j * np.pi * kf * np.cumsum(msg)).astype(np.complex64)


def cu8_rows(n, seed=3):
    x = fm_iq(n)
    noise = np.random.default_rng(seed).normal(0, 2.0, (n, 2))
    rows = np.stack([x.real, x.imag], axis=1) * 100 + 127.5 + noise
    return np.clip(np.round(rows), 0, 255).astype(np.uint8)


# kind -> (graph, stream of n samples)
KINDS = {
    "complex64": (lambda: ct.chain(ct.dc_blocker(), ct.fm_demodulator(0.6), ct.fir_decimator(4)),
                  fm_iq),
    "float32": (lambda: ct.iir_filter(4, 0.1),
                lambda n: (0.5 * np.sin(0.02 * np.arange(n))
                           + 0.1 * np.random.default_rng(5).normal(size=n)).astype(np.float32)),
    "cu8": (lambda: ct.chain(ct.u8_to_iq(), ct.dc_blocker(), ct.fm_demodulator(0.6)), cu8_rows),
}


def outputs(graph, chunks, staging=None):
    """The Pipeline's output over ``chunks``, joined; ``staging`` replaces
    its staging step."""
    pipe = ct.Pipeline(graph, BLOCK, device=CPU)
    if staging is not None:
        pipe._staging = staging
    outs = []
    pipe.run(iter(chunks), outs.append)
    return np.concatenate(outs)


def assert_same_as_numpy_staging(kind, chunks):
    make_graph, _ = KINDS[kind]
    got = outputs(make_graph(), chunks)
    want = outputs(make_graph(), chunks, numpy_staging)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_staged_blocks_equal_the_numpy_copy_with_a_padded_last_block(kind):
    x = KINDS[kind][1](3 * BLOCK + 999)
    assert_same_as_numpy_staging(kind, [x[:BLOCK + 7], x[BLOCK + 7:]])


@pytest.mark.parametrize("kind", list(KINDS))
def test_non_contiguous_chunks_equal_the_numpy_copy(kind):
    x = KINDS[kind][1](2 * (2 * BLOCK + 100))
    strided = x[::2]                      # every other sample (row)
    assert not strided.flags.c_contiguous
    chunks = [strided[:BLOCK], strided[BLOCK:]]
    if kind == "cu8":                     # rows cut out of wider records
        wide = np.concatenate([x, np.zeros_like(x)], axis=1)[: 2 * BLOCK + 100, :2]
        assert not wide.flags.c_contiguous
        chunks.append(wide)
    assert_same_as_numpy_staging(kind, chunks)


@pytest.mark.parametrize("kind,source", [("complex64", ct.cf32_file_source),
                                         ("float32", ct.f32_file_source),
                                         ("cu8", ct.cu8_file_source)])
def test_read_only_file_chunks_stage_without_a_warning(tmp_path, kind, source):
    """The file sources yield ``np.frombuffer`` views of the bytes read;
    chunks of the block size reach the staging step as they are."""
    x = KINDS[kind][1](3 * BLOCK + 999)
    path = tmp_path / "capture.raw"
    path.write_bytes(x.tobytes())
    chunks = list(source(str(path), BLOCK))
    assert not chunks[0].flags.writeable and len(chunks[0]) == BLOCK
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = outputs(KINDS[kind][0](), chunks)
    want = outputs(KINDS[kind][0](), [x], numpy_staging)
    assert np.array_equal(got, want)


def test_read_only_chunk_warns_nothing_in_a_fresh_process():
    """Torch warns of a non-writable array once a process, so only a fresh
    interpreter, warnings made errors, shows that staging gives none."""
    script = textwrap.dedent("""
        import numpy as np
        import csdr_tpu_torch as ct
        x = np.frombuffer(np.arange(2 * 4096, dtype=np.uint8).tobytes(), np.uint8)
        outs = []
        ct.Pipeline(ct.u8_to_iq(), 4096, device="cpu").run(iter([x.reshape(-1, 2)]),
                                                           outs.append)
        assert len(outs) == 1 and outs[0].shape == (4096,)
    """)
    done = subprocess.run([sys.executable, "-W", "error", "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


def test_host_view_copies_nothing_but_a_negative_stride():
    ro = np.frombuffer(cu8_rows(BLOCK).tobytes(), np.uint8).reshape(-1, 2)
    strided = fm_iq(2 * BLOCK)[::2]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for a in (ro, strided, ro[:, :1]):
            t = _host_view(a)
            assert t.data_ptr() == a.ctypes.data
            assert t.stride() == tuple(s // a.itemsize for s in a.strides)
            assert np.array_equal(t.numpy(), a)
    rev = ro[::-1]
    t = _host_view(rev)
    assert np.array_equal(t.numpy(), rev)


@pytest.mark.parametrize("kind,width", [("complex64", 8), ("float32", 4), ("cu8", 2)])
def test_h2d_bytes_count_every_staged_block(kind, width):
    make_graph, make = KINDS[kind]
    with prof.recording() as rec:
        ct.Pipeline(make_graph(), BLOCK, device=CPU).run(iter([make(2 * BLOCK + 10)]),
                                                         lambda y: None)
    blocks = 3   # padded to the block size
    assert rec.counters["pipeline.h2d_bytes"] == blocks * BLOCK * width
    assert "pipeline.stage_reused_bytes" not in rec.counters   # the ring is the card's


def test_each_cpu_block_reaches_the_graph_in_a_fresh_tensor():
    """On the CPU the staged tensor is the graph's input itself, and a
    graph may keep views of it in its carried state: no block's tensor is
    refilled by a later one."""
    x = fm_iq(4 * BLOCK)
    graph = ct.fm_demodulator(0.6)
    seen = []
    apply = graph.apply

    def keep(state, xb):
        seen.append(xb)
        return apply(state, xb)

    graph.apply = keep
    ct.Pipeline(graph, BLOCK, device=CPU).run(iter([x]), lambda y: None)
    assert len(seen) == 4
    assert len({t.data_ptr() for t in seen}) == 4
    for j, t in enumerate(seen):
        assert np.array_equal(t.numpy(), x[j * BLOCK:(j + 1) * BLOCK])
