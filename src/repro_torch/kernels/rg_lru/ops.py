"""Entry point of the RG-LRU scan: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises, unless
``REPRO_LM_KERNELS`` pins the op to its plain version (``kernels/pin.py``).
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

from .. import pin
from . import ref


def rglru_scan(x, a, h0):
    """x, a (B, S, D); h0 (B, D) f32 -> (h (B, S, D), hT (B, D) f32)."""
    if pin.use_kernel("rglru_scan", x):
        from . import kernel
        return kernel.rglru_scan(x, a, h0)
    return ref.rglru_scan(x, a, h0)
