"""csdr_tpu_torch — the channelized FM receiver of csdr_tpu on PyTorch and CUDA.

A second package beside ``csdr_tpu`` (the JAX reference, which it never
imports).  Blocks are static config plus two functions over explicit state,

    init(device)      -> state            (tensors on that device)
    apply(state, x)   -> (state, y)

composed with ``chain`` and streamed by ``Pipeline`` on an explicit
``torch.device``.  The fused DC blocker → NCO → PFB → DFT → FM demod chain
(``csrc/flagship_fused.cu``) and the fused PFB FIR → DFT (→ FM demod) tail
(``csrc/pfb_fused.cu``) are hand-written CUDA kernels, built with ``nvcc``
at their first CUDA launch; on a CPU tensor their plain PyTorch versions
run instead.
"""

import torch as _torch

# TF32 keeps ~10 mantissa bits: a silent ~−52 dB error floor for DSP, the
# same floor the JAX package avoids by forcing "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .core.block import Block, Chain, chain, PerChannel, MixChannels  # noqa: E402
from .core.runtime import Pipeline, rechunk, take_n  # noqa: E402
from .blocks import (  # noqa: E402
    automatic_gain_control, dc_blocker, firpfbch_channelizer, fm_demodulator, u8_to_iq,
)
from .models.receivers import channelized_receiver, channelized_fm_receiver  # noqa: E402
from .io.sources import cf32_file_source, cu8_file_source  # noqa: E402
from .io.sinks import (  # noqa: E402
    RawFileSink, AudioFileSink, ChannelFileSinks, NullSink, CollectSink,
)

__all__ = [
    "Block", "Chain", "chain", "PerChannel", "MixChannels",
    "Pipeline", "rechunk", "take_n",
    "automatic_gain_control", "dc_blocker", "firpfbch_channelizer", "fm_demodulator",
    "u8_to_iq",
    "channelized_receiver", "channelized_fm_receiver",
    "cf32_file_source", "cu8_file_source",
    "RawFileSink", "AudioFileSink", "ChannelFileSinks", "NullSink", "CollectSink",
]

__version__ = "0.1.0"
