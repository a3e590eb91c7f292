"""Plain PyTorch version of flash attention and of its backward: naive
full-matrix softmax and its gradient, in float32."""

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


def _scores(q, kf, *, causal, window, cap, scale):
    """(raw products scaled, tanh of the capped ones or None, masked capped
    scores (B, H, Sq, Sk), mask (Sq, Sk)) in float32."""
    Sq, Sk = q.shape[1], kf.shape[1]
    x = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    t = None
    if cap is not None:
        t = torch.tanh(x / cap)
        x = cap * t
    mask = live_mask(Sq, Sk, causal=causal, window=window, device=q.device)
    s = torch.where(mask[None, None], x, torch.full((), -1e30,
                                                    device=q.device))
    return t, s, mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              cap: float | None = None, scale: float | None = None,
              return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  f32 math.
    ``return_lse`` also returns each row's log-sum-exp of the scaled,
    capped, masked scores, (B, H, Sq) float32."""
    hd, rep = q.shape[3], q.shape[2] // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2).float()
    _, s, _ = _scores(q, kf, causal=causal, window=window, cap=cap,
                      scale=scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  cap: float | None = None, scale: float | None = None,
                  tile_dtype: torch.dtype | None = None):
    """Gradient of `attention` from its output ``o`` (B, Sq, H, hd), the
    row log-sum-exps ``lse`` (B, H, Sq) and the output's gradient ``do``:
    (dq, dk, dv) in the operands' dtypes, dk and dv summed over the H/KV
    query heads of each KV head.  The full matrices in float32:
    P = exp(S - lse) on live pairs, D = rowsum(dO o O),
    dS = P (dO V^T - D) (1 - tanh^2) scale.  ``tile_dtype`` (the bfloat16
    kernel's rounding point, for the tests) rounds P and dS to that dtype
    before their products dV = P^T dO, dK = dS^T Q and dQ = dS K, as the
    kernel's tensor-core operands are; dS itself comes from the unrounded P,
    and every sum stays float32."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2).float()
    qf, dof = q.float(), do.float()
    t, s, mask = _scores(q, kf, causal=causal, window=window, cap=cap,
                         scale=scale)
    p = torch.where(mask[None, None], torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))

    def tile(x):
        return x if tile_dtype is None else x.to(tile_dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", tile(p), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)          # (B, H, Sq)
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = tile(ds * scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)

    def group_sum(x):
        return x.reshape(B, Sk, KV, rep, hd).sum(3)
    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)
