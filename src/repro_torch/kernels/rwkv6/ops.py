"""Entry point of the WKV6 recurrence: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises, unless
``REPRO_LM_KERNELS`` pins the op to its plain version (``kernels/pin.py``).
There is no fallback from the kernel to the plain version.

The kernel has no backward yet (ROADMAP queue 1 item 8): under autograd
on a CUDA tensor the op raises ``NotImplementedError``.  On a CPU tensor
(or under the pin) autograd runs through the plain version, as the
reference's training differentiates its plain WKV.

A meta tensor takes the shape-only route (`pin.py`, `MetaWKV6`, an
autograd Function so that gradients reach r, k, v, w, u and the state),
each call charged with the kernel's work: forward, 5 operations per state
element and step plus 5 N per (b, t, h) for the bonus (the count of
``chip_smoke.py``'s ``wkv_case``), each operand and result moved once;
backward, the reverse recurrence: the forward's 5 to rebuild each state
element, and 10 more for dS = w dS + r dy and the four rank-one sums of
dr, dk, dv and dw, so 15 (N^2 + N) per (b, t, h).
"""

from __future__ import annotations

import torch

from .. import pin
from . import ref


class MetaWKV6(torch.autograd.Function):
    """The shape-only route on meta tensors, forward and backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        B, S, H, N = r.shape
        y = torch.empty_like(r)
        sT = torch.empty(state.shape, dtype=torch.float32, device=r.device)
        pin.charge("wkv6", 5.0 * B * S * H * (N * N + N),
                   pin.nbytes(r, k, v, w, u, state, y, sT))
        ctx.save_for_backward(r, k, v, w, u, state)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u, state = ctx.saved_tensors
        B, S, H, N = r.shape
        grads = tuple(torch.empty_like(t) for t in (r, k, v, w, u, state))
        pin.charge("wkv6_bwd", 15.0 * B * S * H * (N * N + N),
                   pin.nbytes(r, k, v, w, u, state, dy, dsT, *grads))
        return grads


def wkv6(r, k, v, w, u, state):
    """r, k, v, w (B, S, H, N); u (H, N); state (B, H, N, N) f32 ->
    (y (B, S, H, N) in r's dtype, final state f32)."""
    if r.device.type == "meta":
        return MetaWKV6.apply(r, k, v, w, u, state)
    if pin.use_kernel("wkv6", r):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, u, state)):
            raise NotImplementedError(
                "wkv6 has no backward kernel yet (ROADMAP queue 1 item 8, "
                "WKV6's backward): rwkv6 cannot train on the card")
        from . import kernel
        return kernel.wkv6(r, k, v, w, u, state)
    return ref.wkv6(r, k, v, w, u, state)
