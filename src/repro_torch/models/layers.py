"""Model building blocks of the recurrentgemma serving path, in PyTorch.

Ports the parts of ``repro.models.layers`` that recurrentgemma-2b runs:
RMSNorm (gemma-style ``(1 + w)`` scaling), tanh soft-cap, RoPE (half-split
rotation), GQA/MQA attention with a sliding window, the geglu/swiglu MLPs
and the Griffin RG-LRU recurrent block.  Every function is functional:
params in, activations out, with the reference's parameter layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, ...).  Decode variants take and
return explicit state.

Prefill attention goes through the flash-attention op and the RG-LRU scan
through the rg_lru op (``repro_torch.kernels``): the hand-written kernel on
a CUDA tensor, the plain version on a CPU tensor.  Decode attention is a
one-query softmax over the cache in plain PyTorch, as the reference keeps
it outside any kernel.  MoE, RWKV, M-RoPE and sinusoidal positions come
with the slices that need them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.rg_lru import ops as rglru_ops

Params = dict


# ----------------------------------------------------------------------
# norms & activations
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w) if plus_one else w
    return (xf * scale).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


# ----------------------------------------------------------------------
# positions
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S).  Plain RoPE, half-split."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention (GQA, windowed, softcapped)
# ----------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, KV, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, hd).reshape(
        B, S, KV * n_rep, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              cap: float | None = None) -> torch.Tensor:
    """Full-sequence attention through the flash op: q (B, Sq, H, hd),
    k/v (B, Sk, KV, hd); query and key positions both start at 0, scale
    1/sqrt(hd)."""
    return flash_ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, cap=cap)


@dataclasses.dataclass
class AttnConfig:
    """The reference's AttnConfig for plain-RoPE attention without biases
    (M-RoPE, qkv biases and unrotated positions come with their slices)."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    window: int | None = None
    cap: float | None = None


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * std).to(dtype)


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.bfloat16,
              device="cpu") -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq": _normal(gen, (d, H, hd), s, dtype, device),
        "wk": _normal(gen, (d, KV, hd), s, dtype, device),
        "wv": _normal(gen, (d, KV, hd), s, dtype, device),
        "wo": _normal(gen, (H, hd, d), s / math.sqrt(H * hd / d), dtype,
                      device),
    }


def _qkv(p: Params, x: torch.Tensor, cfg: AttnConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p: Params, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (scoring / prefill)."""
    return attn_prefill(p, x, cfg, positions)[0]


def attn_prefill(p: Params, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    """Like forward but also returns the KV cache {k, v}: (B, S, KV, hd)."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = attention(q, k, v, causal=True, window=cfg.window, cap=cfg.cap)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), {"k": k, "v": v}


def attn_decode(p: Params, x: torch.Tensor, cfg: AttnConfig, cache: Params,
                pos: torch.Tensor):
    """One-token decode: x (B, 1, d), cache {k, v}: (B, S, KV, hd), pos (B,).

    If the cache is no larger than the window it is a ring buffer: slots
    are recycled mod S and every slot is valid once the ring has wrapped.
    RoPE is applied at absolute positions before writing, so recycled slots
    stay correct.  The cache is updated in place (one slot per row) and
    returned.
    """
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    S = cache["k"].shape[1]
    ring = cfg.window is not None and S <= cfg.window
    wpos = pos % S if ring else pos
    rows = torch.arange(cache["k"].shape[0], device=x.device)
    cache["k"][rows, wpos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, wpos] = v[:, 0].to(cache["v"].dtype)
    kpos = torch.arange(S, device=x.device)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    kf = _repeat_kv(cache["k"], H // KV)
    vf = _repeat_kv(cache["v"], H // KV)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bchd,bshd->bhcs", q.float(), kf.float()) * scale
    if cfg.cap is not None:
        logits = softcap(logits, cfg.cap)
    if ring:
        mask = (kpos[None, :] <= pos[:, None]) | (pos[:, None] >= S)
    else:
        mask = kpos[None, :] <= pos[:, None]
        if cfg.window is not None:
            mask &= kpos[None, :] > pos[:, None] - cfg.window
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), -1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhcs,bshd->bchd", probs, vf.float()).to(x.dtype)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, cache


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int, kind: str = "swiglu",
             dtype=torch.bfloat16, device="cpu") -> Params:
    if kind not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"mlp kind {kind!r}: the plain 2-layer MLP comes with the "
            "musicgen slice")
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {"wg": _normal(gen, (d, f), s_in, dtype, device),
            "wu": _normal(gen, (d, f), s_in, dtype, device),
            "wd": _normal(gen, (f, d), s_out, dtype, device)}


def mlp_forward(p: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if kind == "geglu":
        return (gelu_tanh(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    raise NotImplementedError(
        f"mlp kind {kind!r}: the plain 2-layer MLP comes with the musicgen "
        "slice")


# ----------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RGLRUConfig:
    d_model: int
    d_rnn: int
    conv_width: int = 4
    c: float = 8.0


def rglru_init(gen: torch.Generator, cfg: RGLRUConfig, dtype=torch.bfloat16,
               device="cpu") -> Params:
    d, dr = cfg.d_model, cfg.d_rnn
    s = 1.0 / math.sqrt(d)
    sr = 1.0 / math.sqrt(dr)
    u = torch.rand((dr,), generator=gen, dtype=torch.float32, device=device)
    # Lambda init so that a ~ U(0.9, 0.999)^c-ish (griffin init)
    lam = torch.log(torch.expm1(-torch.log(u * 0.099 + 0.9) / cfg.c))
    f32 = torch.float32
    return {
        "w_in_x": _normal(gen, (d, dr), s, dtype, device),
        "w_in_g": _normal(gen, (d, dr), s, dtype, device),
        "conv_w": _normal(gen, (cfg.conv_width, dr), 0.1, dtype, device),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=device),
        "wa": _normal(gen, (dr, dr), sr, dtype, device),
        "ba": torch.zeros((dr,), dtype=f32, device=device),
        "wx": _normal(gen, (dr, dr), sr, dtype, device),
        "bx": torch.zeros((dr,), dtype=f32, device=device),
        "lam": lam,
        "w_out": _normal(gen, (dr, d), sr, dtype, device),
    }


def rglru_scan(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + x_t over S through the rg_lru op.  x, a:
    (B, S, D) f32; h0 (B, D) f32 -> (h (B, S, D), hT (B, D))."""
    return rglru_ops.rglru_scan(x.contiguous(), a.contiguous(),
                                h0.contiguous())


def rglru_block(p: Params, x: torch.Tensor, cfg: RGLRUConfig,
                state: tuple | None = None):
    """Griffin recurrent block: in-proj -> conv1d -> RG-LRU, gated.

    x: (B, S, d).  state = (conv_carry (B, W-1, dr), h (B, dr) f32).
    Returns (out, new_state).
    """
    B, S, _ = x.shape
    dr = cfg.d_rnn
    gate = gelu_tanh(x @ p["w_in_g"])
    u = x @ p["w_in_x"]
    W = cfg.conv_width
    if state is None:
        conv_carry = torch.zeros((B, W - 1, dr), dtype=u.dtype, device=u.device)
        h0 = torch.zeros((B, dr), dtype=torch.float32, device=u.device)
    else:
        conv_carry, h0 = state
    upad = torch.cat([conv_carry, u], dim=1)              # (B, S+W-1, dr)
    # W shifted products summed in the activation dtype, then the bias
    conv = upad[:, 0:S] * p["conv_w"][0]
    for i in range(1, W):
        conv = conv + upad[:, i:i + S] * p["conv_w"][i]
    conv = conv + p["conv_b"]
    new_conv_carry = upad[:, S:] if W > 1 else conv_carry
    # RG-LRU gates in f32
    convf = conv.float()
    rg = torch.sigmoid(convf @ p["wa"].float() + p["ba"])
    ig = torch.sigmoid(convf @ p["wx"].float() + p["bx"])
    log_a = -cfg.c * rg * F.softplus(p["lam"])
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = (ig * convf) * mult
    h, new_h = rglru_scan(gated, a, h0.float())
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, (new_conv_carry, new_h)
