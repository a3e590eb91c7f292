"""Plain PyTorch version of flash attention: naive full-matrix softmax."""

from __future__ import annotations

import math

import torch


def live_mask(Sq: int, Sk: int, *, causal: bool, window: int | None,
              device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which (query, key) pairs attend.  Positions count
    from 0 for queries and keys alike."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              cap: float | None = None,
              scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  f32 math."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    mask = live_mask(Sq, Sk, causal=causal, window=window, device=q.device)
    s = torch.where(mask[None, None], s, torch.full((), -1e30,
                                                    device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype)
