"""Entry point of flash attention: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises, unless
``REPRO_LM_KERNELS`` pins the op to its plain version (``kernels/pin.py``).
There is no fallback from the kernel to the plain version, and a DTensor
raises (`pin.refuse_dtensor`).

When an operand requires grad (and grad mode is on) the call goes through
`FlashAttention`, an autograd Function: its forward also keeps each row's
log-sum-exp, and its backward is the backward kernel on a CUDA tensor and
``ref.attention_bwd`` on a CPU tensor (or under the pin).  Otherwise the
call is the forward alone, which writes no log-sum-exp.

A meta tensor takes the shape-only route (`pin.py`): outputs of the right
shapes and the scratch the kernels allocate (the backward's row sums D
and, under GQA, its float32 partials of each query head's dK and dV),
each call charged with the kernel's work, 4 hd operations a live
(query, key) pair and head forward, 10 hd backward (recomputing S, then
dP, dV, dQ, dK), and q, k, v, o (and lse, do, dq, dk, dv) moved once.
The plain version would instead count the masked pairs and move the full
(B, H, Sq, Sk) float32 matrices, which the kernel never writes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import pin
from . import ref


def live_pairs(Sq: int, Sk: int, *, causal: bool, window) -> int:
    """The (query, key) pairs `ref.live_mask` lets attend, counted."""
    q = np.arange(Sq, dtype=np.int64)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(
        q - window + 1, 0)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _meta_fwd(q, k, v, *, causal=True, window=None, cap=None, scale=None,
              return_lse=False):
    B, Sq, H, hd = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    pairs = live_pairs(Sq, k.shape[1], causal=causal, window=window)
    pin.charge("flash_attention", 4.0 * hd * pairs * B * H,
               pin.nbytes(q, k, v, o, lse))
    return (o, lse) if return_lse else o


def _meta_bwd(q, k, v, o, lse, do, *, causal=True, window=None, cap=None,
              scale=None):
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = [torch.empty((B, H, Sq), **f32)]                    # D
    if H != KV:
        scratch.append(torch.empty((2, B, Sk, H, hd), **f32))
    pairs = live_pairs(Sq, Sk, causal=causal, window=window)
    pin.charge("flash_attention_bwd", 10.0 * hd * pairs * B * H,
               pin.nbytes(q, k, v, o, lse, do, *grads))
    del scratch
    return grads


def _impl(q):
    if pin.shape_only(q):
        return _meta_fwd, _meta_bwd
    if pin.use_kernel("flash_attention", q):
        from . import kernel
        return kernel.flash_attention, kernel.flash_attention_bwd
    return ref.attention, ref.attention_bwd


class FlashAttention(torch.autograd.Function):
    """Attention with its hand-written backward: saves q, k, v, the output
    and the row log-sum-exps; dk and dv come summed over each KV head's
    group of query heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale):
        fwd, _ = _impl(q)
        opts = dict(causal=causal, window=window, cap=cap, scale=scale)
        o, lse = fwd(q, k, v, return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        _, bwd = _impl(q)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None, cap=None,
                    scale=None):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype."""
    pin.refuse_dtensor("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, cap, scale)
    fwd, _ = _impl(q)
    return fwd(q, k, v, causal=causal, window=window, cap=cap, scale=scale)
