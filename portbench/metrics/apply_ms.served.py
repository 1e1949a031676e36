"""apply_ms.served (ms): the host's time per block in ``pipeline.apply``, the
graph's ``apply``: its enqueue of every stage, the launches included.  Read
from the program's own spans (``csdr_tpu_torch/utils/prof``, which records
while the harness's profiler session is active): the sum over the traced
window's Pipeline run ÷ the blocks it applied.  None from a program without
the recorder.  Moves ``msps``."""


def read(run):
    try:
        from csdr_tpu_torch.utils.prof import SESSION
    except ImportError:
        return None
    spans = SESSION.last_run()
    applied = [s.ms for s in spans if s.name == "pipeline.apply"]
    return sum(applied) / len(applied) if applied and sum(applied) > 0 else None
