"""Plain PyTorch version of the RG-LRU recurrence: a sequential loop.

Each step is one multiply and one add, each rounded on its own (two
separate tensor ops, so nothing fuses them), which is the arithmetic the
CUDA kernel spells with ``__fmul_rn``/``__fadd_rn``: on the card the two
agree bit for bit.
"""

from __future__ import annotations

import torch


def rglru_scan(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """x, a: (B, S, D); h0: (B, D) -> (h (B, S, D) in x's dtype, hT (B, D)
    f32).  f32 math, ``h_t = a_t * h_{t-1} + x_t``."""
    xf, af = x.float(), a.float()
    h = h0.float()
    ys = torch.empty_like(xf)
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys[:, t] = h
    return ys.to(x.dtype), h
