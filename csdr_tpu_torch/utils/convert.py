"""Carry streaming state across from the JAX package.

The receiver has no weights: what crosses over is the carried state.  The
functions take the JAX package's state pytrees with their leaves given as
numpy arrays (``jax.tree.map(np.asarray, state)``) and return the port's
state on a given device.  The design constants (taps, DFT matrix, phase
tables) are not state: the port rebuilds them from its copied numpy code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.sharding import place_state
from ..ops.pfb import pfb_offset

__all__ = ["from_jax_chain_state", "from_jax_flagship_state", "from_jax_flagship_wide_state",
           "from_jax_pfb_fm_state", "from_jax_sharded_channelized_state",
           "from_jax_sharded_chain_state"]


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.astype(np.uint8)  # RDSBitSlicer's previous raw bit, 0 or 1
    return torch.from_numpy(a).to(device)


def from_jax_chain_state(state, device: torch.device):
    """State of the JAX XLA-path chain → the port's eager chain state.

    For ``dc_blocker >> firpfbch_channelizer >> PerChannel(fm_demodulator)``
    that is ``(dc_blocker_init, (phase, pfb_analyze_init), stacked FMDemod
    state)``, and with the AGC ``PerChannel(chain(AGC, fm_demodulator))``
    carries ``((ln_gain (nch,), prev_above (nch,) bool), FMDemod state)``.
    The FIR family and the front end carry plain leaves: ``FIRFilter``,
    ``FIRDecim`` and ``HalfbandDecim`` their input hist (K − 1,),
    ``RationalResampler`` its (L − 1,) tail, ``Mixer`` its float32 phase,
    ``Lambda`` and ``AMDemod`` nothing (``()``); inside ``PerChannel`` each
    leaf gains a leading channel axis.

    The IIR family (``IIRFilter``, the WBFM de-emphasis) carries per stage
    ``(fir_hist (2,), carries (2,) complex64)``; ``Delay`` its (n,) buffer;
    ``Tee`` the pair of its branches' states.  ``StereoFMDecoder`` and
    ``RDSBaseband`` carry dicts (phase19, pilot_hist, delay_buf, the FIR
    histories, the de-emphasis cascades, the scan-PLL carry ``pll``), which
    map key for key; ``RDSBitSlicer`` carries (MF hist (15,), previous raw
    bit), the bit uint32 in the JAX package and uint8 here, the one leaf
    whose dtype changes.  ``SymSync`` carries ``(hist (H,), tau (), valid
    () bool)``, ``SymSyncScan`` ``(hist (H,), tau (), eta (), prev_c (),
    edge ())`` (prev_c and edge of the input's dtype), and ``sym_tracker``'s stages their own: the AGC's pair, the
    sync's triple, the power normalizer's ``(p, valid)``, the carrier
    phase, the equalizer's ``(w (T,) complex64, hist (T − 1,))``; inside
    ``PerChannel`` each gains the leading channel axis that the JAX vmap
    stacks.  The port's blocks carry the same leaves in the same nesting,
    so the structure maps one to one and every other leaf keeps its shape
    and dtype."""
    if isinstance(state, dict):
        return {k: from_jax_chain_state(v, device) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(from_jax_chain_state(s, device) for s in state)
    return _leaf(state, device)


def from_jax_flagship_state(state: dict, device: torch.device) -> dict:
    """State of the JAX narrow fused kernel (``flagship_fused_init``:
    phase, hist_re, hist_im (L+1, nch), scal = [x_last re, im, y_dc_last re,
    im]) → the port's ``flagship_fused`` state dict."""
    scal = np.asarray(state["scal"], dtype=np.float32)
    hist = (np.asarray(state["hist_re"], np.float32)
            + 1j * np.asarray(state["hist_im"], np.float32)).astype(np.complex64)
    return dict(
        phase=_leaf(np.asarray(state["phase"], np.float32).reshape(()), device),
        hist=_leaf(hist, device),
        x_last=_leaf(np.complex64(scal[0] + 1j * scal[1]), device),
        y_dc_last=_leaf(np.complex64(scal[2] + 1j * scal[3]), device),
    )


def from_jax_flagship_wide_state(state: dict, nch: int, device: torch.device,
                                 m: int = 7) -> dict:
    """State of the JAX wide fused kernel (``flagship_fused_wide_init``, the
    state of ``ShardedFlagship``: phase, hist_re, hist_im (h, 128), scal)
    → the port's ``flagship_fused`` state.

    The wide hist holds the last h·128 DC-blocked samples in stream order,
    not NCO-shifted (its kernel folds the NCO into its constants).  K1's
    hist holds the last L+1 frames NCO-shifted, so the last (L+1)·nch of
    those samples are rotated by e^{−j(phase + ω·k)} at their indices k =
    −(L+1)·nch .. −1 before the next block, ``phase`` being the NCO phase
    at that block's first sample (made in float64)."""
    L = 2 * m
    hs = (L + 1) * nch
    y = (np.asarray(state["hist_re"], np.float64).reshape(-1)
         + 1j * np.asarray(state["hist_im"], np.float64).reshape(-1))[-hs:]
    if y.shape[0] != hs:
        raise ValueError(f"wide hist holds {y.shape[0]} samples, K1's needs {hs}")
    phase = float(np.asarray(state["phase"], np.float32))
    k = np.arange(-hs, 0, dtype=np.float64)
    theta = phase + np.mod(pfb_offset(nch) * k, 2.0 * np.pi)
    hist = (y * np.exp(-1j * theta)).reshape(L + 1, nch)
    return from_jax_flagship_state(dict(phase=state["phase"], hist_re=hist.real,
                                        hist_im=hist.imag, scal=state["scal"]), device)


def from_jax_sharded_channelized_state(state: dict, device: torch.device) -> dict:
    """State of the JAX ``ShardedChannelizedFM`` (its ``init``/``step``
    state: dc_x, dc_y, phase, pfb_tail, demod_last, fir_tail, agc_lng,
    agc_above, complex leaves CEnc-encoded as float32 (…, 2) re/im planes)
    → the port's ``ShardedChannelizedFM`` state, the same keys with
    complex64 leaves.  A CEnc leaf arrives as the CEnc itself or as a
    1-tuple of its planes."""
    out = {}
    for k, v in state.items():
        if isinstance(v, tuple):
            ri = np.asarray(v[0], np.float32)
            v = (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)
        out[k] = _leaf(v, device)
    return out


def from_jax_pfb_fm_state(state, device: torch.device):
    """State of the JAX ``PallasChannelizedFM`` (``channelized_fm_pallas_init``:
    phase, hist_x (nch−1,), hist_v (L, nch)) → the port's ``PFBFusedFM``
    state, which has the same leaves."""
    phase, hist_x, hist_v = state
    return (_leaf(np.asarray(phase, np.float32).reshape(()), device),
            _leaf(np.asarray(hist_x, np.complex64), device),
            _leaf(np.asarray(hist_v, np.complex64), device))


def from_jax_sharded_chain_state(state, device: torch.device, tags="rep", ci: int = 0,
                                 dc: int = 1):
    """State of the JAX ``ShardedChain`` (its ``init``/``step`` state: the
    graph's ``shard_init`` tree, complex leaves CEnc-encoded, each leaf
    whole as ``np.asarray`` reads it) → this rank's share of the port's
    ``ShardedChain`` state.  Both packages collapse a fused run the same
    way (``Chain._shard_segments``: the run's raw-input tail (A1,) at its
    first block, ``()`` at the others), so the trees map one to one; a CEnc
    leaf (a named tuple with an ``ri`` field of float32 (…, 2) re/im planes)
    becomes complex64.  The stereo and RDS decoders' dicts map key for key;
    ``RDSBitSlicer``'s previous raw bit turns from uint32 to uint8, as in
    ``from_jax_chain_state``; ``GMSKDemod`` carries (previous sample (1,),
    matched-filter history) and ``SymSync`` (hist, tau, valid), as
    serial.  ``tags`` is the port's ``ShardedChain.state_tags``
    (the graph's ``shard_state_spec``): on a dc-way channel axis each "ch"
    leaf (a ``PerChannel`` stack) is handed over as the rows of channel
    rank ``ci``, as ``ShardedChain.init`` places them."""
    return place_state(_from_jax_chain_tree(state, device), tags, ci, dc)


def _from_jax_chain_tree(state, device: torch.device):
    if hasattr(state, "ri"):
        ri = np.asarray(state.ri, np.float32)
        return _leaf((ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64), device)
    if isinstance(state, dict):
        return {k: _from_jax_chain_tree(v, device) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(_from_jax_chain_tree(s, device) for s in state)
    return _leaf(state, device)
