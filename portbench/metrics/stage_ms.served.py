"""stage_ms.served (ms): the host's time per block in ``pipeline.stage``, the
Pipeline's pinned buffer and the host copy of the block into it.  Read from
the program's own spans (``csdr_tpu_torch/utils/prof``, which records while
the harness's profiler session is active): the sum over the traced window's
Pipeline run ÷ the blocks it applied.  None from a program without the
recorder.  Moves ``msps``."""


def read(run):
    try:
        from csdr_tpu_torch.utils.prof import SESSION
    except ImportError:
        return None
    spans = SESSION.last_run()
    blocks = sum(1 for s in spans if s.name == "pipeline.apply")
    t = sum(s.ms for s in spans if s.name == "pipeline.stage")
    return t / blocks if blocks and t > 0 else None
