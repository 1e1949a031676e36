"""sync_device_ms.served (ms): the device's time per block in the symbol
sync (``SymSync``, ``models/symsync.py``; the stage span named
``symsync(k=…)``, ``symsync_r`` or ``symsync_c``): the interval between the
CUDA events the program records around the stage, summed over the traced
window's Pipeline run ÷ the blocks it applied.  None on the CPU (no events)
and from a program without the recorder.  Moves ``msps``."""

import re

SYNC = re.compile(r"^symsync(_[rc])?\(")


def read(run):
    try:
        from csdr_tpu_torch.utils.prof import SESSION
    except ImportError:
        return None
    spans = SESSION.last_run()
    blocks = sum(1 for s in spans if s.name == "pipeline.apply")
    dev = [s.device_ms for s in spans if SYNC.match(s.name) and s.device_ms is not None]
    return sum(dev) / blocks if blocks and dev else None
