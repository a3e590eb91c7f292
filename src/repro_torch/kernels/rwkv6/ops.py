"""Entry point of the WKV6 recurrence: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises, unless
``REPRO_LM_KERNELS`` pins the op to its plain version (``kernels/pin.py``).
There is no fallback from the kernel to the plain version.

The kernel has no backward yet (ROADMAP queue 1 item 8): under autograd
on a CUDA tensor the op raises ``NotImplementedError``.  On a CPU tensor
(or under the pin) autograd runs through the plain version, as the
reference's training differentiates its plain WKV.
"""

from __future__ import annotations

import torch

from .. import pin
from . import ref


def wkv6(r, k, v, w, u, state):
    """r, k, v, w (B, S, H, N); u (H, N); state (B, H, N, N) f32 ->
    (y (B, S, H, N) in r's dtype, final state f32)."""
    if pin.use_kernel("wkv6", r):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, u, state)):
            raise NotImplementedError(
                "wkv6 has no backward kernel yet (ROADMAP queue 1 item 8, "
                "WKV6's backward): rwkv6 cannot train on the card")
        from . import kernel
        return kernel.wkv6(r, k, v, w, u, state)
    return ref.wkv6(r, k, v, w, u, state)
