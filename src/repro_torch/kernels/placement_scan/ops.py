"""Entry points of the placement-scan ops: the kernel for CUDA tensors.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``kernel.py``) or raises.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from . import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"placement-scan ops run on cuda or cpu, not {t.device}")


def scan_bitmaps(win, Vs, ks, t_live, *, W: int):
    """Feasible-start bitmaps (g, W, m) int8; see ref.scan_bitmaps."""
    if _on_cuda(win):
        from . import kernel
        return kernel.scan_bitmaps(win, Vs, ks, int(t_live), int(W))
    return ref.scan_bitmaps(win, Vs, ks, int(t_live), int(W))


def heartbeat_eligible(dem32, thr_fit, thr_fung, fd_mask, rd_mask, gd_mask):
    """Sound-superset heartbeat eligibility (n, m) int8."""
    if _on_cuda(dem32):
        from . import kernel
        return kernel.heartbeat_eligible(dem32, thr_fit, thr_fung, fd_mask,
                                         rd_mask, gd_mask)
    return ref.heartbeat_eligible(dem32, thr_fit, thr_fung, fd_mask, rd_mask,
                                  gd_mask)


def match_wave_walk(avail, order, dem, pri, srpt, gidx, loc, taken0, ema,
                    deficit, share, fd_mask, rd_mask, fg_mask, consts, *,
                    bundle_limit: int, use_packing: bool, use_srpt: bool,
                    use_overbooking: bool, drf: bool):
    """One fused heartbeat wave; see ref.match_wave_walk."""
    kw = dict(bundle_limit=int(bundle_limit), use_packing=bool(use_packing),
              use_srpt=bool(use_srpt), use_overbooking=bool(use_overbooking),
              drf=bool(drf))
    args = (avail, order, dem, pri, srpt, gidx, loc, taken0, ema, deficit,
            share, fd_mask, rd_mask, fg_mask, consts)
    if _on_cuda(avail):
        from . import kernel
        return kernel.match_wave_walk(*args, **kw)
    return ref.match_wave_walk(*args, **kw)
