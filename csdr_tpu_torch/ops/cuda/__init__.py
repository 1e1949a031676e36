"""Hand-written CUDA kernels, their build step, wrappers and plain twins.

Each kernel's wrapper module counts the calls that launched it in
``launches``: an int, or (``pfb_fused``) one count per kernel.
``kernel_launches()`` reads every count of this process and
``reset_kernel_launches()`` sets them to 0; both import the wrapper
modules only when called, so this package imports without a card.
"""

__all__ = ["kernel_launches", "reset_kernel_launches"]


def _kernel_modules() -> tuple:
    """The modules of the hand-written kernels."""
    from . import (fft_fir, fir_valid, flagship_fused, pfb_fused, pll_scan, symsync_block,
                   symsync_scan)

    return pfb_fused, flagship_fused, fir_valid, fft_fir, pll_scan, symsync_scan, symsync_block


def kernel_launches() -> dict:
    """Each hand-written kernel's launch count in this process."""
    out = {}
    for mod in _kernel_modules():
        counts = mod.launches
        out.update(counts if isinstance(counts, dict) else {mod.__name__.rsplit(".", 1)[1]: counts})
    return out


def reset_kernel_launches() -> None:
    """Set every hand-written kernel's launch count to 0."""
    for mod in _kernel_modules():
        if isinstance(mod.launches, dict):
            mod.launches.update(dict.fromkeys(mod.launches, 0))
        else:
            mod.launches = 0
