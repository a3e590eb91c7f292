"""int8 gradient quantization: a port of ``repro.optim.compression``.

`quantize_int8` takes a per-tensor float32 scale (max |x| / 127, plus
1e-30) and rounds half to even into [-127, 127]; `dequantize` multiplies
back.  Both are bitwise the reference's.  The reference's
``compressed_psum`` sums the quantized leaves across replicas; it needs
process groups and comes with sharding (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
