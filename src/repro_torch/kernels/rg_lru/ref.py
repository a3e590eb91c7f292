"""Plain PyTorch version of the RG-LRU recurrence and of its backward:
sequential loops.

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


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   dh: torch.Tensor, dhT: torch.Tensor | None = None):
    """Gradient of `rglru_scan` from the forward's ``h`` (B, S, D) and the
    outputs' gradients ``dh`` (B, S, D) and ``dhT`` (B, D) or None:
    (dx, da (B, S, D), dh0 (B, D)), float32.  The reverse loop: g = dh_t +
    c, dx_t = g, da_t = g * h_{t-1} (h_{-1} = h0), c = a_t * g, from
    c = dhT; dh0 is the last c.  One rounding per op, as the kernel's
    ``__fadd_rn``/``__fmul_rn``."""
    af, hf, dhf = a.float(), h.float(), dh.float()
    h0f = h0.float()
    c = dhT.float() if dhT is not None else torch.zeros_like(h0f)
    dx, da = torch.empty_like(dhf), torch.empty_like(dhf)
    for t in range(a.shape[1] - 1, -1, -1):
        g = dhf[:, t] + c
        dx[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else h0f)
        c = af[:, t] * g
    return dx, da, c
