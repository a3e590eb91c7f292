"""Entry point of the RG-LRU scan: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises, unless
``REPRO_LM_KERNELS`` pins the op to its plain version (``kernels/pin.py``).
There is no fallback from the kernel to the plain version, and a DTensor
raises (`pin.refuse_dtensor`).

When an operand requires grad (and grad mode is on) the call goes through
`RGLRUScan`, an autograd Function whose backward is the backward kernel on
a CUDA tensor and ``ref.rglru_scan_bwd`` on a CPU tensor (or under the
pin); it saves a, the output h and h0.

A meta tensor takes the shape-only route (`pin.py`), each call charged
with the kernel's work: forward, one multiply and one add per element,
x, a, h0 read and h, hT written; backward, an add and two multiplies per
element, a, h, dh, h0, dhT read and dx, da, dh0 written.
"""

from __future__ import annotations

import torch

from .. import pin
from . import ref


def _meta_fwd(x, a, h0):
    h = torch.empty_like(x)
    hT = torch.empty(h0.shape, dtype=torch.float32, device=x.device)
    pin.charge("rglru_scan", 2.0 * x.numel(), pin.nbytes(x, a, h0, h, hT))
    return h, hT


def _meta_bwd(a, h, h0, dh, dhT):
    f32 = dict(dtype=torch.float32, device=a.device)
    dx, da = torch.empty(a.shape, **f32), torch.empty(a.shape, **f32)
    dh0 = torch.empty(h0.shape, **f32)
    pin.charge("rglru_scan_bwd", 3.0 * a.numel(),
               pin.nbytes(a, h, h0, dh, dhT, dx, da, dh0))
    return dx, da, dh0


def _impl(x):
    if pin.shape_only(x):
        return _meta_fwd, _meta_bwd
    if pin.use_kernel("rglru_scan", x):
        from . import kernel
        return kernel.rglru_scan, kernel.rglru_scan_bwd
    return ref.rglru_scan, ref.rglru_scan_bwd


class RGLRUScan(torch.autograd.Function):
    """The scan with its hand-written backward (the reverse recurrence)."""

    @staticmethod
    def forward(ctx, x, a, h0):
        fwd, _ = _impl(x)
        h, hT = fwd(x, a, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.dtypes = (x.dtype, a.dtype, h0.dtype)
        return h, hT

    @staticmethod
    def backward(ctx, dh, dhT):
        a, h, h0 = ctx.saved_tensors
        _, bwd = _impl(a)
        dx, da, dh0 = bwd(a, h, h0, dh.float().contiguous(),
                          dhT.float().contiguous())
        return tuple(g.to(dt) for g, dt in zip((dx, da, dh0), ctx.dtypes))


def rglru_scan(x, a, h0):
    """x, a (B, S, D); h0 (B, D) f32 -> (h (B, S, D), hT (B, D) f32)."""
    pin.refuse_dtensor("rglru_scan", x, a, h0)
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad
                                    or h0.requires_grad):
        return RGLRUScan.apply(x, a, h0)
    fwd, _ = _impl(x)
    return fwd(x, a, h0)
