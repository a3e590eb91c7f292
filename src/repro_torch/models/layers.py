"""Model building blocks, in PyTorch: a port of ``repro.models.layers``.

Covers every sub-block of the reference's architecture pool: RMSNorm
(gemma-style ``(1 + w)`` scaling), tanh soft-cap, RoPE (half-split
rotation), M-RoPE (qwen2-vl) and sinusoidal positions (musicgen), GQA/MQA
attention with a sliding window, a soft-cap and optional qkv biases, the
swiglu/geglu/plain-GELU MLPs, the token-dropping Mixture-of-Experts with
sort-based capacity dispatch (deepseek-moe, mixtral), the Griffin RG-LRU
recurrent block, and the RWKV6 time-mix (data-dependent decay) and
channel-mix.  Every function is functional: params in, activations out,
with the reference's parameter layouts (``wq (d, H, hd)``, ``wo (H, hd,
d)``, ``wg (E, d, f)``, ...).  Decode variants take and return explicit
state.  The initializers take a ``torch.Generator`` and ``device="cuda"``
by default, which raises without a card.

Prefill attention goes through the flash-attention op, the RG-LRU scan
through the rg_lru op and the WKV recurrence through the wkv6 op
(``repro_torch.kernels``): the hand-written kernel on a CUDA tensor, the
plain version on a CPU tensor.  Decode attention is a one-query softmax
over the cache in plain PyTorch, and the MoE's routing, dispatch, expert
products and combine are plain PyTorch too, as the reference keeps both
outside any kernel.  The reference's ``logical(...)`` sharding annotations
stand where it has them (`models.sharding`: the identity outside a mesh);
under a mesh's rules the MoE's dispatch groups tile the device grid as the
reference's do (`_moe_groups`), each group dispatched on its own as its
``shard_map`` does.  On DTensors (a sharded program) the three kernel ops
and the decode cache's write run on local shards (`models.sharding.
local_region`): flash with batch on "data" and heads on the TP axes,
RG-LRU with batch and channels, WKV6 with batch and heads, the sequence
whole in each.  The initializers also take ``device="meta"``, whose
tensors hold no data: the dry run counts a step on them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..core.engine.kernels import check_device
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.rg_lru import ops as rglru_ops
from ..kernels.rwkv6 import ops as rwkv6_ops
from .sharding import (axis_coord, axis_prod, current_mesh, current_rules,
                       is_dtensor, layout, local_einsum, local_region,
                       logical, project, project_out, replicated_like,
                       unflatten_last)

Params = dict


#: the products `project` and `project_out` compute
_mm = torch.matmul
_heads_in = functools.partial(torch.einsum, "bsd,dhk->bshk")
_heads_out = functools.partial(torch.einsum, "bshk,hkd->bsd")


def _mm_f32(x, w):
    """A product with the weight in float32."""
    return x @ w.float()


#: a product of the residual (B, S, d) with a (d, f) weight, and back
_IN = "bsd,df->bsf"
_OUT = "bsf,fd->bsd"
_HEADS_OUT = "bshk,hkd->bsd"
#: the RG-LRU's gates: (B, S, dr) channels times a (dr, dr) weight
_GATE = "bsf,fg->bsg"


def check_init_device(device) -> str:
    """`check_device` for the initializers, which also take "meta"."""
    if torch.device(device).type == "meta":
        return "meta"
    return check_device(device)


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
               theta: float = 1e4,
               mrope_sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (3, B, S) for M-RoPE.
    Half-split rotation."""
    hd = x.shape[-1]
    freqs = replicated_like(rope_freqs(hd, theta, x.device), positions)
    if mrope_sections is None:
        angles = positions[..., None].float() * freqs      # (B, S, hd/2)
    else:
        # M-RoPE: the hd/2 frequency slots split into (t, h, w) sections,
        # each driven by its own position stream (qwen2-vl)
        if positions.dim() != 3 or positions.shape[0] != len(mrope_sections):
            raise ValueError(f"M-RoPE takes positions ({len(mrope_sections)}"
                             f", B, S), got {tuple(positions.shape)}")
        parts, off = [], 0
        for sec, pos in zip(mrope_sections, positions):
            parts.append(pos[..., None].float() * freqs[off:off + sec])
            off += sec
        angles = torch.cat(parts, dim=-1)                  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(S: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """(S, d) float32: sin at the even columns, cos at the odd ones."""
    pos = torch.arange(offset, offset + S, dtype=torch.float32,
                       device=device)
    return _sinusoid(pos, d)


def _sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(N, d) float32 position embedding of the float32 positions ``pos``."""
    dim = replicated_like(
        torch.arange(0, d, 2, dtype=torch.float32, device=pos.device), pos)
    angle = pos[:, None] / torch.pow(10000.0, dim / d)[None, :]
    pe = replicated_like(torch.zeros((pos.shape[0], d), dtype=torch.float32,
                                     device=pos.device), pos)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# ----------------------------------------------------------------------
# attention (GQA, windowed, softcapped)
# ----------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, KV, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, hd).reshape(
        B, S, KV * n_rep, hd)


#: (B, S, heads, hd), the sequence whole
_HEADS = ("batch", None, "heads", None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              cap: float | None = None) -> torch.Tensor:
    """Full-sequence attention through the flash op: q (B, Sq, H, hd),
    k/v (B, Sk, KV, hd); query and key positions both start at 0, scale
    1/sqrt(hd).  On DTensors, on local shards (`_flash_plan`)."""
    def run(q, k, v):
        return flash_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, cap=cap)
    q_names, body = _flash_plan(run, q, k)
    return local_region(body, (q, k, v), (q_names, _HEADS, _HEADS), (0,))


def _flash_plan(run, q, k):
    """(q's dim names, the body) of flash's region: batch on "data", query
    heads on the TP axes in contiguous blocks, KV heads too where they
    divide the axes (else whole), the sequence whole (a sequence-sharded
    input is gathered by the region's redistribution).  Where the KV heads
    stay whole and more than one, each shard takes the one KV head its
    block of query heads reads (GQA's h // (H / KV) map); where no single
    head serves a block, the query heads stay whole too.  On plain tensors
    the names go unread."""
    if not is_dtensor(q):
        return _HEADS, run
    H, KV = q.shape[2], k.shape[2]
    mesh, ax = q.device_mesh, current_rules()["heads"]
    split = layout(q, *_HEADS) != layout(q, "batch")
    n = axis_prod(mesh, ax) if split else 1
    sliced = n > 1 and layout(k, *_HEADS) == layout(k, "batch") and KV > 1
    if not sliced:
        return _HEADS, run
    if (H // KV) % (H // n):
        return ("batch",), run
    lo = axis_coord(mesh, ax) * (H // n) // (H // KV)

    def body(q, k, v):
        return run(q, k[:, :, lo:lo + 1], v[:, :, lo:lo + 1])
    return _HEADS, body


@dataclasses.dataclass
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None
    window: int | None = None
    cap: float | None = None
    qkv_bias: bool = False
    use_rope: bool = True


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * std).to(dtype)


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.bfloat16,
              device="cuda") -> Params:
    check_init_device(device)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, H, hd), s, dtype, device),
        "wk": _normal(gen, (d, KV, hd), s, dtype, device),
        "wv": _normal(gen, (d, KV, hd), s, dtype, device),
        "wo": _normal(gen, (H, hd, d), s / math.sqrt(H * hd / d), dtype,
                      device),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: AttnConfig, positions):
    eq = "bsd,dhk->bshk"
    q, k, v = project(x, (eq, p["wq"], _heads_in), (eq, p["wk"], _heads_in),
                      (eq, p["wv"], _heads_in))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
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
    return project_out(o, _HEADS_OUT, p["wo"], _heads_out), {"k": k, "v": v}


def _write_slot(c: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """c[rows, slot] = new: one (KV, hd) slot per row of a cache."""
    c[rows, slot] = new.to(c.dtype)


def _write_slot_or_drop(c: torch.Tensor, rows: torch.Tensor,
                        slot: torch.Tensor, new: torch.Tensor) -> None:
    """Like `_write_slot`, but a write outside the cache is dropped, as the
    reference's scatter drops out-of-range updates (the row then attends
    to the cache as it stands).  Only a plain cache needs it, or a shard
    of one cut by slot: a ring's slots are taken mod its length."""
    fits = ((slot >= 0) & (slot < c.shape[1]))[:, None, None]
    slot = torch.clamp(slot, 0, c.shape[1] - 1)
    c[rows, slot] = torch.where(fits, new.to(c.dtype), c[rows, slot])


#: a decode cache (B, S, KV, hd): slots on "kv_seq" where its heads do not
#: divide the TP axes
_CACHE = ("batch", "kv_seq", "heads", None)


def _slot_offset(c) -> int | None:
    """The first slot the local shard of the DTensor cache ``c`` holds,
    where the rules shard it by slot; else None."""
    if not is_dtensor(c) or (layout(c, *_CACHE) ==
                             layout(c, "batch", None, "heads", None)):
        return None
    mesh, ax = c.device_mesh, current_rules()["kv_seq"]
    return axis_coord(mesh, ax) * (c.shape[1] // axis_prod(mesh, ax))


def _write_cache(cache: Params, wpos, k, v, write) -> Params:
    """The decode write of one (KV, hd) slot a row, ``k``/``v`` (B, KV,
    hd).  On DTensors on local shards: batch on "data", and the cache's
    heads (or its slots) as the state's rules shard them.  Rows are local;
    a cache sharded by slot writes on the shard that holds the slot and
    drops elsewhere, so the drop past the end holds per shard as whole."""
    off = _slot_offset(cache["k"])

    def body(ck, cv, wpos, k, v):
        rows = torch.arange(ck.shape[0], device=ck.device)
        for c, new in ((ck, k), (cv, v)):
            if off is None:
                write(c, rows, wpos, new)
            else:
                _write_slot_or_drop(c, rows, wpos - off, new)
        return ck, cv
    ck, cv = local_region(body, (cache["k"], cache["v"], wpos, k, v),
                          (_CACHE, _CACHE, ("batch",), ("batch", "heads"),
                           ("batch", "heads")), (0, 1))
    return {"k": ck, "v": cv}


def attn_decode(p: Params, x: torch.Tensor, cfg: AttnConfig, cache: Params,
                pos: torch.Tensor):
    """One-token decode: x (B, 1, d), cache {k, v}: (B, S, KV, hd), pos (B,).

    If the cache is no larger than the window it is a ring buffer: slots
    are recycled mod S and every slot is valid once the ring has wrapped.
    RoPE is applied at absolute positions before writing, so recycled slots
    stay correct; M-RoPE rotates all three sections at ``pos`` (the cache
    slot, which for qwen2-vl counts the prepended patches).  The cache is
    updated in place (one slot per row) and returned.
    """
    pp = pos[:, None]
    if cfg.mrope_sections is not None:
        pp = pp[None].expand(len(cfg.mrope_sections), *pp.shape)
    q, k, v = _qkv(p, x, cfg, pp)
    S = cache["k"].shape[1]
    ring = cfg.window is not None and S <= cfg.window
    wpos = pos % S if ring else pos
    write = _write_slot if ring else _write_slot_or_drop
    cache = _write_cache(cache, wpos, k[:, 0], v[:, 0], write)
    kpos = replicated_like(torch.arange(S, device=x.device), pos)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    kf = logical(_repeat_kv(cache["k"], H // KV), "batch", "kv_seq", "heads",
                 None)
    vf = logical(_repeat_kv(cache["v"], H // KV), "batch", "kv_seq", "heads",
                 None)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = local_einsum("bchd,bshd->bhcs", q.float(), kf.float()) * scale
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
    o = local_einsum("bhcs,bshd->bchd", probs, vf.float()).to(x.dtype)
    out = project_out(o, _HEADS_OUT, p["wo"], _heads_out)
    return out, cache


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int, kind: str = "swiglu",
             dtype=torch.bfloat16, device="cuda") -> Params:
    check_init_device(device)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if kind in ("swiglu", "geglu"):
        return {"wg": _normal(gen, (d, f), s_in, dtype, device),
                "wu": _normal(gen, (d, f), s_in, dtype, device),
                "wd": _normal(gen, (f, d), s_out, dtype, device)}
    return {  # plain 2-layer MLP (musicgen)
        "w1": _normal(gen, (d, f), s_in, dtype, device),
        "b1": torch.zeros((f,), dtype=dtype, device=device),
        "w2": _normal(gen, (f, d), s_out, dtype, device),
        "b2": torch.zeros((d,), dtype=dtype, device=device)}


def mlp_forward(p: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        g, u = project(x, (_IN, p["wg"], _mm), (_IN, p["wu"], _mm))
        act = F.silu if kind == "swiglu" else gelu_tanh
        return project_out(act(g) * u, _OUT, p["wd"], _mm)
    h = gelu_tanh(project(x, (_IN, p["w1"], _mm)) + p["b1"])
    return project_out(h, _OUT, p["w2"], _mm) + p["b2"]


# ----------------------------------------------------------------------
# Mixture-of-Experts with sort-based capacity dispatch
# ----------------------------------------------------------------------

@dataclasses.dataclass
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_mode: str = "softmax_topk"   # deepseek: softmax then topk
                                        # mixtral: "topk_softmax"


def moe_init(gen: torch.Generator, d: int, cfg: MoEConfig,
             dtype=torch.bfloat16, device="cuda") -> Params:
    """Router (float32), routed experts ``wg``/``wu`` (E, d, f) and ``wd``
    (E, f, d), and the shared experts as one swiglu MLP of width
    ``n_shared * d_expert``."""
    check_init_device(device)
    E, f = cfg.n_experts, cfg.d_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": _normal(gen, (d, E), s_in, torch.float32, device),
         "wg": _normal(gen, (E, d, f), s_in, dtype, device),
         "wu": _normal(gen, (E, d, f), s_in, dtype, device),
         "wd": _normal(gen, (E, f, d), s_out, dtype, device)}
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, d, f * cfg.n_shared, "swiglu", dtype,
                               device)
    return p


def _moe_groups(B: int, S: int) -> tuple[int, int]:
    """(batch-groups, seq-groups) of the dispatch, as the reference's.

    Under a mesh's rules the groups cover the full device grid (data x
    model axes), so that routing, sorting and capacity dropping are
    device-local and only the (G, E, C, d) buffer crosses the model axis.
    On an expert-factorized mesh the seq groups stay 1 (the buffer crosses
    into the expert axis by slicing).  Outside a mesh both are 1.
    """
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return 1, 1
    g1 = axis_prod(mesh, rules.get("batch"))
    if "expert" in tuple(mesh.mesh_dim_names):
        g2 = 1
    else:
        g2 = axis_prod(mesh, rules.get("capacity"))   # the TP axis
    if g1 <= 0 or B % max(g1, 1) != 0:
        g1 = 1
    if g2 <= 0 or S % max(g2, 1) != 0:
        g2 = 1
    return g1, g2


def moe_capacity(Tg: int, cfg: MoEConfig) -> int:
    """Slots per expert for a group of Tg tokens: ceil(Tg K / E * cf)."""
    return int(math.ceil(Tg * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor))


def moe_route(xg: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """(g, Tg, d) tokens -> (w (g, Tg, K) float32, idx (g, Tg, K)): each
    token's K experts and their weights.  The router's product runs in
    float32 (TF32 on the card would move near-ties), then ``softmax_topk``
    (softmax, top K, renormalized) or ``topk_softmax`` (top K logits,
    softmax over them)."""
    if xg.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("moe_route needs float32 matmuls in full "
                           "precision: torch.backends.cuda.matmul."
                           "allow_tf32 is True")
    logits = torch.einsum("gtd,de->gte", xg.float(), router.float())
    K = cfg.top_k
    if cfg.router_mode == "softmax_topk":
        w, idx = torch.topk(torch.softmax(logits, dim=-1), K, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    elif cfg.router_mode == "topk_softmax":
        lw, idx = torch.topk(logits, K, dim=-1)
        w = torch.softmax(lw, dim=-1)
    else:
        raise ValueError(f"router_mode {cfg.router_mode!r}")
    return w, idx


def moe_plan(idx: torch.Tensor, w: torch.Tensor, C: int, E: int):
    """Capacity dispatch of the routing choices ``idx``/``w`` (g, Tg, K):
    the (token, choice) pairs sorted stably by expert, each pair's place
    among its expert's, and ``keep = place < C``.  Returns (st, sw, keep,
    buf_idx), each (g, Tg K) in expert order: token index, weight, kept,
    and the slot ``expert C + place`` (``E C``, a spare slot, when
    dropped)."""
    g, Tg, K = idx.shape
    flat_e = idx.reshape(g, Tg * K)
    flat_t = torch.arange(Tg, device=idx.device).repeat_interleave(K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sw = torch.gather(w.reshape(g, Tg * K), 1, order)
    counts = torch.zeros((g, E), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = (torch.arange(Tg * K, device=idx.device)[None]
           - torch.gather(starts, 1, se))
    keep = pos < C
    buf_idx = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    return st, sw, keep, buf_idx


def moe_combine(yb: torch.Tensor, st: torch.Tensor, sw: torch.Tensor,
                buf_idx: torch.Tensor, Tg: int, K: int) -> torch.Tensor:
    """(g, Tg, d) float32: each token's K slot outputs of ``yb`` (g, E C +
    1, d, the spare slot last), scaled by their weights ``sw`` in the
    activation dtype, added from 0 in a fixed order: the token's pairs in
    expert order, as ``index_add_`` adds them one source row at a time on
    the CPU (bitwise its result there).  On the card ``index_add_`` adds
    them with atomics, whose order nothing fixes (torch lists it among its
    nondeterministic ops); this forward sum's order is fixed.  One gather
    takes every pair's slot output, then K adds of its slices.  ``st``,
    ``sw`` and ``buf_idx`` (g, Tg K) are `moe_plan`'s, in expert order."""
    g, _, d = yb.shape
    # each token's pairs, in expert order (a stable sort by token keeps it)
    pair = torch.argsort(st, dim=1, stable=True)
    slot = torch.gather(buf_idx, 1, pair).reshape(g, Tg, K)
    wt = torch.gather(sw, 1, pair).reshape(g, Tg, K, 1)
    rows = torch.arange(g, device=yb.device)[:, None, None]
    contrib = (yb[rows, slot] * wt).float()
    out = torch.zeros((g, Tg, d), dtype=torch.float32, device=yb.device)
    for k in range(K):
        out = out + contrib[:, :, k]
    return out


def _group_name(G1: int, G2: int):
    """The logical name of the dispatch groups' dim: the mesh axes backing
    it, as the reference's ``_group_axes`` gives them (batch axes, then
    the capacity axes)."""
    return {(True, True): "moe_group", (True, False): "batch",
            (False, True): "capacity"}.get((G1 > 1, G2 > 1))


def moe_forward(p: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Token-dropping MoE, the reference's semantics: route in float32,
    dispatch each kept (token, choice) pair to its expert's slot of a
    (g, E, C, d) buffer, run the experts as batched products, scale each
    slot's output by its weight in the activation dtype, add each token's
    contributions in float32 (`moe_combine`) and cast back, then add the
    shared experts.

    The dispatch (routing, the capacity plan, the scatter into the buffer)
    and the combine each run in a region over the dispatch groups
    (`models.sharding.local_region`), the counterparts of the reference's
    two ``shard_map`` calls: on DTensors each rank takes its own groups'
    tokens, one group a rank when the groups tile the device grid, and the
    regrouping of (B, S, d) into (G, Tg, d) and back happens on the local
    block.  Between them the expert products run on DTensors, the buffer
    resharded from groups to experts (the expert-parallel all-to-all)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G1, G2 = _moe_groups(B, S)
    G = G1 * G2
    Tg = B * S // G
    C = moe_capacity(Tg, cfg)
    # the groups one block holds: all of them on a plain tensor, one a rank
    # on a DTensor (its block is one group's (B / G1, S / G2) tokens)
    g1, g2 = (1, 1) if is_dtensor(x) else (G1, G2)
    b, s = B // G1, S // G2

    def dispatch(xl, router):
        # (g1 b, g2 s, d) -> (g1, b, g2, s, d) -> (g, Tg, d): group
        # g1 G2 + g2, data major, as the reference's
        xg = xl.reshape(g1, b, g2, s, d).transpose(1, 2).reshape(
            g1 * g2, Tg, d)
        w, idx = moe_route(xg, router, cfg)
        st, sw, keep, buf_idx = moe_plan(idx, w, C, E)
        # tokens gathered in expert order into their slots (the dropped
        # ones all land in the spare slot E*C, cut off below)
        rows = torch.arange(g1 * g2, device=xl.device)[:, None]
        xb = torch.zeros((g1 * g2, E * C + 1, d), dtype=xl.dtype,
                         device=xl.device)
        xb[rows, buf_idx] = xg[rows, st]
        sw_eff = torch.where(keep, sw, torch.zeros((), device=xl.device)).to(
            xl.dtype)
        return (xg, xb[:, :E * C].reshape(g1 * g2, E, C, d), st, sw_eff,
                buf_idx)

    def combine(yb, st, sw, buf_idx, *shared):
        g = yb.shape[0]
        # each pair reads its slot (the spare slot reads zeros)
        ybf = torch.cat([yb.reshape(g, E * C, d),
                         torch.zeros((g, 1, d), dtype=yb.dtype,
                                     device=yb.device)], dim=1)
        out = moe_combine(ybf, st, sw, buf_idx, Tg, K).to(yb.dtype)
        if shared:
            out = out + shared[0]
        return out.reshape(g1, g2, b, s, d).transpose(1, 2).reshape(
            g1 * b, g2 * s, d)

    gn = _group_name(G1, G2)
    x_names = ("batch", "capacity" if G2 > 1 else None, None)
    xg, xb, st, sw, bidx = local_region(
        dispatch, (x, p["router"]), (x_names, (None, None)),
        ((gn, None, None), (gn, None, None, None), (gn, None), (gn, None),
         (gn, None)))
    # expert compute: the buffer reshards from groups to experts here
    xb = logical(xb, "moe_batch", "expert", None, None)
    h = F.silu(torch.einsum("gecd,edf->gecf", xb, p["wg"])) * torch.einsum(
        "gecd,edf->gecf", xb, p["wu"])
    h = logical(h, "moe_batch", "expert", None, "ffn")
    yb = logical(torch.einsum("gecf,efd->gecd", h, p["wd"]), "moe_batch",
                 "expert", None, None)
    args, names = (yb, st, sw, bidx), ((gn,),) * 4
    if "shared" in p:
        args += (mlp_forward(p["shared"], xg, "swiglu"),)
        names += ((gn,),)
    return local_region(combine, args, names, (x_names,))


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
               device="cuda") -> Params:
    check_init_device(device)
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
    (B, S, D) f32; h0 (B, D) f32 -> (h (B, S, D), hT (B, D)).  On
    DTensors, on local shards: batch on "data", channels on "model", the
    sequence whole."""
    def run(x, a, h0):
        return rglru_ops.rglru_scan(x.contiguous(), a.contiguous(),
                                    h0.contiguous())
    xn = ("batch", None, "ffn")
    return local_region(run, (x, a, h0), (xn, xn, ("batch", "ffn")), (0, 2))


def rglru_block(p: Params, x: torch.Tensor, cfg: RGLRUConfig,
                state: tuple | None = None):
    """Griffin recurrent block: in-proj -> conv1d -> RG-LRU, gated.

    x: (B, S, d).  state = (conv_carry (B, W-1, dr), h (B, dr) f32).
    Returns (out, new_state).
    """
    B, S, _ = x.shape
    dr = cfg.d_rnn
    g, u = project(x, (_IN, p["w_in_g"], _mm), (_IN, p["w_in_x"], _mm))
    gate = gelu_tanh(g)
    W = cfg.conv_width
    if state is None:
        conv_carry = replicated_like(
            torch.zeros((B, W - 1, dr), dtype=u.dtype, device=u.device), u)
        h0 = replicated_like(
            torch.zeros((B, dr), dtype=torch.float32, device=u.device), u)
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
    rg = torch.sigmoid(project_out(convf, _GATE, p["wa"], _mm_f32) + p["ba"])
    ig = torch.sigmoid(project_out(convf, _GATE, p["wx"], _mm_f32) + p["bx"])
    log_a = -cfg.c * rg * F.softplus(p["lam"])
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = (ig * convf) * mult
    h, new_h = rglru_scan(gated, a, h0.float())
    out = project_out(h.to(x.dtype) * gate, _OUT, p["w_out"], _mm)
    return out, (new_conv_carry, new_h)


# ----------------------------------------------------------------------
# RWKV6 (Finch): time-mix with data-dependent decay + channel-mix
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RWKVConfig:
    d_model: int
    n_heads: int            # head size = d_model // n_heads (usually 64)
    d_ff: int
    lora_rank: int = 64

    @property
    def head_size(self) -> int:
        return self.d_model // self.n_heads


def _uniform(gen: torch.Generator, shape, scale: float, shift: float,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * scale + shift


def rwkv_init(gen: torch.Generator, cfg: RWKVConfig, dtype=torch.bfloat16,
              device="cuda") -> Params:
    """Time-mix and channel-mix weights of one layer, the reference's
    shapes and scales; ``mu``, ``w0``, ``u``, ``ln_w`` and ``cm_mu`` stay
    float32, the rest take ``dtype``."""
    check_init_device(device)
    d, r, f = cfg.d_model, cfg.lora_rank, cfg.d_ff
    s = 1.0 / math.sqrt(d)

    def normal(shape, std):
        return _normal(gen, shape, std, dtype, device)

    return {
        # token-shift mixing coefficients (static part) for r, k, v, g, w
        "mu": _uniform(gen, (5, d), 0.5, 0.25, device),
        # data-dependent token-shift LoRA (shared A, per-stream B)
        "tm_a": normal((d, 5 * 32), s),
        "tm_b": normal((5, 32, d), 0.01),
        "wr": normal((d, d), s),
        "wk": normal((d, d), s),
        "wv": normal((d, d), s),
        "wg": normal((d, d), s),
        "wo": normal((d, d), s),
        # decay: w = exp(-exp(w0 + lora(x)))
        "w0": _uniform(gen, (d,), -1.0, -5.0, device),
        "wd_a": normal((d, r), s),
        "wd_b": normal((r, d), 0.01),
        "u": _uniform(gen, (d,), 0.5, 0.0, device),          # bonus
        "ln_w": torch.ones((d,), dtype=torch.float32, device=device),
        "cm_mu": _uniform(gen, (2, d), 0.5, 0.25, device),
        "cm_k": normal((d, f), s),
        "cm_v": normal((f, d), 1.0 / math.sqrt(f)),
        "cm_r": normal((d, d), s),
    }


def _token_shift(x: torch.Tensor, x_carry: torch.Tensor | None):
    """x shifted right by one along S, the carry (or zeros) in front; the
    concatenation promotes a bf16 carry against f32 x, as jnp's does."""
    if x_carry is None:
        x_carry = replicated_like(torch.zeros((x.shape[0], x.shape[2]),
                                              dtype=x.dtype, device=x.device),
                                  x)
    return torch.cat([x_carry[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_streams(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift mixed streams (r, k, v, g, w) per RWKV6, in float32.

    x: (B, S, d); x_prev: x shifted right by one (with carry for decode).
    """
    delta = (x_prev - x).float()
    tm = torch.tanh(project(x.float(), (_IN, p["tm_a"], _mm_f32)))
    tm = tm.reshape(*x.shape[:-1], 5, 32)
    dyn = local_einsum("bsni,nid->bsnd", tm, p["tm_b"].float())
    mixed = x[..., None, :].float() + delta[..., None, :] * (p["mu"] + dyn)
    return [mixed[..., i, :] for i in range(5)]


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: RWKVConfig,
                  x_carry: torch.Tensor | None = None,
                  state: torch.Tensor | None = None):
    """RWKV6 attention-free mixer.

    x: (B, S, d); x_carry (B, d): last token of the previous chunk; state
    (B, H, N, N) f32 WKV state.  Returns (out, (new_x_carry, new_state)).
    """
    B, S, d = x.shape
    H, N = cfg.n_heads, cfg.head_size
    xr, xk, xv, xg, xw = _rwkv_streams(p, x, _token_shift(x, x_carry))
    dt = x.dtype
    r = unflatten_last(project(xr.to(dt), (_IN, p["wr"], _mm)), H, N)
    k = unflatten_last(project(xk.to(dt), (_IN, p["wk"], _mm)), H, N)
    v = unflatten_last(project(xv.to(dt), (_IN, p["wv"], _mm)), H, N)
    g = F.silu(project(xg.to(dt), (_IN, p["wg"], _mm)))
    lora = torch.tanh(project(xw.to(dt), (_IN, p["wd_a"], _mm))).float()
    wlog = p["w0"] + project(lora, (_IN, p["wd_b"], _mm_f32))
    w = unflatten_last(torch.exp(-torch.exp(wlog)), H, N)  # decay in (0, 1)
    u = p["u"].reshape(H, N)
    if state is None:
        state = replicated_like(torch.zeros((B, H, N, N), dtype=torch.float32,
                                            device=x.device), x)
    r = logical(r, "batch", None, "heads", None)
    k = logical(k, "batch", None, "heads", None)
    v = logical(v, "batch", None, "heads", None)
    w = logical(w, "batch", None, "heads", None)
    state = logical(state, "batch", "heads", None, None)
    y, new_state = local_region(
        lambda *ts: rwkv6_ops.wkv6(*(t.contiguous() for t in ts)),
        (r, k, v, w, u, state),
        (_HEADS,) * 4 + (("heads",), ("batch", "heads")), (0, 5))
    # per-head group norm
    y = rms_norm(y.reshape(B, S, H, N), p["ln_w"].reshape(H, N), eps=1e-5)
    # gated per head (the gate split as the heads are), then merged
    y = (y * unflatten_last(g, H, N)).reshape(B, S, d)
    return project_out(y.to(dt), _OUT, p["wo"], _mm), (x[:, -1, :], new_state)


def rwkv_channel_mix(p: Params, x: torch.Tensor,
                     x_carry: torch.Tensor | None = None):
    """RWKV channel-mix FFN with token shift.  Returns (out, new_carry)."""
    x_prev = _token_shift(x, x_carry)
    mu = p["cm_mu"]
    xk = x + (x_prev - x) * mu[0].to(x.dtype)
    xr = x + (x_prev - x) * mu[1].to(x.dtype)
    kk = torch.square(torch.relu(project(xk, (_IN, p["cm_k"], _mm))))
    out = torch.sigmoid(project(xr, (_IN, p["cm_r"], _mm))) * project_out(
        kk, _OUT, p["cm_v"], _mm)
    return out, x[:, -1, :]
