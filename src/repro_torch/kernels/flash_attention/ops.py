"""Entry point of flash attention: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises, unless
``REPRO_LM_KERNELS`` pins the op to its plain version (``kernels/pin.py``).
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

from .. import pin
from . import ref


def flash_attention(q, k, v, *, causal: bool = True, window=None, cap=None,
                    scale=None):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype."""
    if pin.use_kernel("flash_attention", q):
        from . import kernel
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      cap=cap, scale=scale)
    return ref.attention(q, k, v, causal=causal, window=window, cap=cap,
                         scale=scale)
