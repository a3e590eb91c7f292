"""Entry point of the WKV6 recurrence: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises, unless
``REPRO_LM_KERNELS`` pins the op to its plain version (``kernels/pin.py``).
There is no fallback from the kernel to the plain version, and a DTensor
raises (`pin.refuse_dtensor`).

When an operand requires grad (and grad mode is on) the call goes through
`WKV6`, an autograd Function whose backward is the backward kernel
(``kernel.wkv6_bwd``) on a CUDA tensor and ``ref.wkv6_bwd`` on a CPU
tensor (or under the pin); it saves the operands, the initial state among
them, and the backward rebuilds the states from them.

A meta tensor takes the shape-only route (`pin.py`): outputs of the
right shapes and the scratch the backward kernel allocates (every 16th
state of its first pass, and du's partials), each call charged with the
kernel's work: forward, 5 operations per state
element and step plus 5 N per (b, t, h) for the bonus (the count of
``chip_smoke.py``'s ``wkv_case``), each operand and result moved once;
backward, the kernel's reverse recurrence: S = w S + k v (3 operations)
once in the first pass and 22 times in every 16 steps of the second (each
half chunk rebuilt from the chunk's checkpoint), 3 for G = w G + r dy, 2
for each of the four sums of dr, dk, dv and dw, so 18.125 per state
element and step, and 15 N per (b, t, h) for the bonus terms: (145 N^2 +
120 N) / 8 per (b, t, h).  That is 29% above the function's least work
(14 N^2 + 15 N, the count of ``chip_smoke.py``'s ``wkv6_bwd_case``).
"""

from __future__ import annotations

import torch

from .. import pin
from . import ref


#: the backward kernel keeps every BWD_CHUNK-th state of its first pass
#: (``wkv6.cu``'s ``kBwdK``)
BWD_CHUNK = 16


def _meta_fwd(r, k, v, w, u, state):
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    sT = torch.empty(state.shape, dtype=torch.float32, device=r.device)
    pin.charge("wkv6", 5.0 * B * S * H * (N * N + N),
               pin.nbytes(r, k, v, w, u, state, y, sT))
    return y, sT


def _meta_bwd(r, k, v, w, u, state, dy, dsT=None):
    B, S, H, N = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    grads = tuple(torch.empty(t.shape, **f32) for t in (r, k, v, w, u, state))
    scratch = (torch.empty(B * H * -(-S // BWD_CHUNK) * N * N, **f32),
               torch.empty((B, H, N), **f32))             # du's partials
    pin.charge("wkv6_bwd", B * S * H * (145.0 * N * N + 120.0 * N) / 8,
               pin.nbytes(r, k, v, w, u, state, dy, dsT, *grads))
    del scratch
    return grads


def _impl(r):
    if pin.shape_only(r):
        return _meta_fwd, _meta_bwd
    if pin.use_kernel("wkv6", r):
        from . import kernel
        return kernel.wkv6, kernel.wkv6_bwd
    return ref.wkv6, ref.wkv6_bwd


class WKV6(torch.autograd.Function):
    """The recurrence with its hand-written backward (the reverse
    recurrence over states rebuilt from the saved operands)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        fwd, _ = _impl(r)
        y, sT = fwd(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        saved = ctx.saved_tensors
        r = saved[0]
        _, bwd = _impl(r)
        grads = bwd(*saved, dy.to(r.dtype).contiguous(),
                    None if dsT is None else dsT.float().contiguous())
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved))


def wkv6(r, k, v, w, u, state):
    """r, k, v, w (B, S, H, N); u (H, N); state (B, H, N, N) f32 ->
    (y (B, S, H, N) in r's dtype, final state f32)."""
    pin.refuse_dtensor("wkv6", r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        return WKV6.apply(r, k, v, w, u, state)
    fwd, _ = _impl(r)
    return fwd(r, k, v, w, u, state)
