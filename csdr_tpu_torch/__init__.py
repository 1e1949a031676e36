"""csdr_tpu_torch — csdr_tpu's receivers on PyTorch and CUDA.

A second package beside ``csdr_tpu`` (the JAX reference, which it never
imports).  Blocks are static config plus two functions over explicit state,

    init(device)      -> state            (tensors on that device)
    apply(state, x)   -> (state, y)

composed with ``chain`` and streamed by ``Pipeline`` on an explicit
``torch.device``.  The fused DC blocker → NCO → PFB → DFT → FM demod chain
(``csrc/flagship_fused.cu``), the fused PFB FIR → DFT (→ FM demod) tail
(``csrc/pfb_fused.cu``), the long real-tap FIR (``csrc/fir_valid.cu``) and
the overlap-save FFT FIR (``csrc/fft_fir.cu``) are hand-written CUDA
kernels, built with ``nvcc`` at their first CUDA launch; on a CPU tensor
their plain PyTorch versions run instead.  ``core/checkpoint.py`` saves a
Pipeline's state mid-stream and resumes it bit for bit.
"""

import torch as _torch

# TF32 keeps ~10 mantissa bits: a silent ~−52 dB error floor for DSP, the
# same floor the JAX package avoids by forcing "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .core.block import (  # noqa: E402
    Block, Chain, chain, Delay, Lambda, PerChannel, MixChannels, Tee,
)
from .core.runtime import Pipeline, rechunk, skip_n, take_n  # noqa: E402
from .core.checkpoint import resume_pipeline, save_pipeline  # noqa: E402
from .blocks import (  # noqa: E402
    am_demodulator, automatic_gain_control, complex_to_real, cw_demodulator, dc_blocker,
    fir_decimator, fir_filter, fir_filter_c_kaiser, fir_filter_rnyquist, fir_interpolator,
    firpfbch_channelizer, fm_demodulator, iir_cfilter, iir_filter, mix_down, mix_up,
    real_to_complex, resampler, ssb_demodulator, u8_to_iq, wbfm_demodulator,
)
from .models.receivers import (  # noqa: E402
    am_receiver, channelized_fm_receiver, channelized_receiver, front_end, nbfm_receiver,
    raw_capture, wbfm_receiver,
)
from .models.stereo import stereo_fm_decoder  # noqa: E402
from .models.rds import rds_receiver  # noqa: E402
from .io.sources import (  # noqa: E402
    cf32_file_source, cu8_file_source, f32_file_source, raw_bytes_source, wav_iq_source,
)
from .io.sinks import (  # noqa: E402
    RawFileSink, StdoutSink, AudioFileSink, ConstellationPlotSink, SpectrumPlotSink,
    BranchSinks, ChannelFileSinks, NullSink, CollectSink, PlaybackSink, TeeSink,
)

__all__ = [
    "Block", "Chain", "chain", "Delay", "Lambda", "PerChannel", "MixChannels", "Tee",
    "Pipeline", "rechunk", "skip_n", "take_n", "save_pipeline", "resume_pipeline",
    "am_demodulator", "automatic_gain_control", "complex_to_real", "cw_demodulator",
    "dc_blocker", "fir_decimator", "fir_filter", "fir_filter_c_kaiser", "fir_filter_rnyquist",
    "fir_interpolator", "firpfbch_channelizer", "fm_demodulator", "iir_cfilter", "iir_filter",
    "mix_down", "mix_up", "real_to_complex", "resampler", "ssb_demodulator", "u8_to_iq",
    "wbfm_demodulator",
    "front_end", "wbfm_receiver", "nbfm_receiver", "am_receiver", "raw_capture",
    "channelized_receiver", "channelized_fm_receiver", "stereo_fm_decoder", "rds_receiver",
    "cf32_file_source", "cu8_file_source", "f32_file_source", "raw_bytes_source",
    "wav_iq_source",
    "RawFileSink", "StdoutSink", "AudioFileSink", "ConstellationPlotSink", "SpectrumPlotSink",
    "BranchSinks", "ChannelFileSinks", "NullSink", "CollectSink", "PlaybackSink", "TeeSink",
]

__version__ = "0.1.0"
