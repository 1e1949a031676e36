"""The frozen bound arithmetic against hand-worked values, and the trace
reduction on synthetic timelines."""

import pytest

import bounds
import tracing


def test_flagship_bound_at_the_main_shape():
    # 2^23 cu8 samples: 2 B in + 4 B out per sample = 50.3 MB over 3.35 TB/s
    # = 15.0 µs; (4·15 + 5·6 + 8 + 6 + 4 + 26) = 134 FLOP a sample = 1.124
    # GFLOP over 67 TFLOP/s = 16.78 µs, the larger
    b = bounds.flagship_bound(1 << 23, 64, cu8=True)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] * 1e3 == pytest.approx(16.8, abs=0.05)
    assert b["bound_flops"] == 134 * (1 << 23)


def test_pfb_bound_at_k4s_shape():
    # the heli64 block, 8,376,320 samples: F = 130,880 frames; panels (F +
    # 14) × 64 complex in (8 B) and complex channels out (8 B a sample) =
    # 134.1 MB over 3.35 TB/s = 40.0 µs
    b = bounds.pfb_bound(8376320, 64, demod=False)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] * 1e3 == pytest.approx(40.1, abs=0.1)
    assert b["bound_bytes"] == 8 * (130880 + 14) * 64 + 8 * 8376320


def test_busy_union_counts_overlap_once():
    # kernels [0, 4) and [2, 6) overlap; a copy [8, 9); window [0, 12)
    busy, gaps = tracing.busy_union([(2.0, 6.0), (0.0, 4.0), (8.0, 9.0)], 0.0, 12.0)
    assert busy == pytest.approx(7.0)
    assert gaps == [(6.0, 8.0), (9.0, 12.0)]
    # intervals outside the window are clipped; a nested one adds nothing
    busy, gaps = tracing.busy_union([(-3.0, 1.0), (0.5, 0.7), (11.0, 15.0)], 0.0, 12.0)
    assert busy == pytest.approx(2.0)
    assert gaps == [(1.0, 11.0)]


class _Ev:
    def __init__(self, name, cuda, start_us, dur_us):
        self._n, self._c, self._s, self._d = name, cuda, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int(self._d * 1e3)


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda s: events})()


def test_summarize_a_synthetic_trace():
    ev = [_Ev(tracing.WINDOW, False, 0, 100),
          _Ev("cudaLaunchKernel", False, 1, 2), _Ev("cudaLaunchKernel", False, 5, 2),
          _Ev("cudaStreamSynchronize", False, 60, 40),
          _Ev("void channel_tile<64, 2>(float)", True, 10, 30),
          _Ev("dc_chunk(int)", True, 30, 20),
          _Ev("Memcpy HtoD (Pageable -> Device)", True, 70, 10),
          _Ev("nccl:broadcast", True, 0, 100)]
    s = tracing.summarize(_Prof(ev), steps=2)
    assert s["window_s"] == pytest.approx(100e-6)
    # kernels [10, 40) ∪ [30, 50) ∪ the copy [70, 80): 50 µs; the NCCL range
    # is no operation
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["launch_calls"] == 2 and tracing.complete(s)
    assert set(s["kernels"]) == {"void channel_tile<64, 2>(float)", "dc_chunk(int)"}
    assert s["copies_s"] == pytest.approx(10e-6)
    assert s["device_ops"][0][0] == "void channel_tile<64, 2>(float)"
    # gaps [0, 10), [50, 70), [80, 100): the host call at each middle
    gaps = {(round(v * 1e6)): k for k, v in s["idle_gaps"]}
    assert [v for _, v in s["idle_gaps"]][0] == pytest.approx(20e-6)
    assert gaps[10] == "cudaLaunchKernel" and gaps[20] == "cudaStreamSynchronize"
