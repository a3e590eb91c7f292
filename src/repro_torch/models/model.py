"""Decoder assembly: config -> params -> forward / prefill / decode.

Ports ``repro.models.model``: one generic decoder covers the reference's
whole architecture pool through a per-layer plan, each layer a (mixer
kind, ffn kind) from ``ArchConfig.layer_plan``:

  mixer: "attn" (global), "local" (sliding window), "rwkv", "rglru"
  ffn:   "swiglu" | "geglu" | "mlp" | "moe" | "rwkv_cm" (channel mix)

with the embeddings and heads of every family: tied or untied heads,
``sqrt(d)`` embedding scale, gemma2's post-norms, musicgen's summed
codebook embeddings with per-codebook heads and sinusoidal positions,
and qwen2-vl's projected patches prepended to the text under M-RoPE
positions.  A mixer or ffn the reference does not define raises
``NotImplementedError``.

The scoring `forward`, `prefill` and `decode_step` run without autograd.
The training pass is `forward_hidden` and `loss_fn`: differentiable, and
under ``ArchConfig.remat`` each layer and each loss chunk runs under
``torch.utils.checkpoint`` (recomputed in the backward), where the
reference checkpoints its scanned body (the port's layers are a plain
list, so it checkpoints per layer, head and tail layers included: the
same gradients, one layer's activations alive at a time).

The reference groups the layers as a head (the dense layers before the
MoE ones), a repeating body stacked under ``lax.scan`` and a tail;
PyTorch runs eagerly, so here the layers are a plain list walked by a
Python loop: ``params["layers"][i]`` and ``state["layers"][i]`` belong to
layer i.  `params_from_jax` and `state_from_jax` carry the reference's
trees across (unstacking its body).  Parameter layouts are the
reference's (``wq (d, H, hd)``, ...).  Every entry point takes
``device=``: "cuda" by default, which raises without a card, or "cpu" for
the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.engine.kernels import check_device
from . import layers as L
from .sharding import (is_dtensor, logical, lookup, project, replicated_like,
                       under_current_rules, vocab_parallel)

Params = dict

def _unknown(kind: str) -> NotImplementedError:
    return NotImplementedError(f"{kind!r} is not a layer kind of the "
                               "reference: no planned slice ports it")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's ArchConfig, field for field, without ``scan_unroll``
    (there is no scan to unroll) and its XLA attention's ``query_chunk``
    (the flash op tiles the whole sequence itself).  ``remat`` checkpoints
    the training pass (`forward_hidden`, `loss_fn`)."""
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block_pattern: tuple[str, ...] = ("attn",)
    window: int | None = None
    attn_cap: float | None = None
    logit_cap: float | None = None
    rope_theta: float = 1e4
    mrope_sections: tuple[int, int, int] | None = None
    qkv_bias: bool = False
    norm_plus_one: bool = False        # gemma-style (1+w) RMSNorm
    post_norm: bool = False            # gemma2 post-block norms
    mlp_kind: str = "swiglu"
    moe: L.MoEConfig | None = None
    first_k_dense: int = 0
    dense_ff: int | None = None
    n_codebooks: int = 1               # musicgen: EnCodec codebooks
    pos_embedding: str = "rope"        # rope | sinusoidal | none
    embed_scale: bool = False
    tie_embeddings: bool = True
    rwkv_head_size: int = 64
    rglru_width: int | None = None
    conv_width: int = 4
    vlm_patches: int = 0               # stub frontend: patches prepended
    subquadratic: bool = False         # supports long_500k decode
    remat: bool = True

    @property
    def vocab_padded(self) -> int:
        return (self.vocab + 255) // 256 * 256

    @property
    def layer_plan(self) -> list[tuple[str, str]]:
        plan = []
        for i in range(self.n_layers):
            mixer = self.block_pattern[i % len(self.block_pattern)]
            if mixer == "rwkv":
                ffn = "rwkv_cm"
            elif self.moe is not None and i >= self.first_k_dense:
                ffn = "moe"
            else:
                ffn = self.mlp_kind
            plan.append((mixer, ffn))
        return plan

    @property
    def groups(self) -> tuple[list, list, list]:
        """(head_plan, body_pattern, tail_plan) of the reference's stacked
        layout; the body repeats n_body times after the head."""
        plan = self.layer_plan
        head, rest = plan[:self.first_k_dense], plan[self.first_k_dense:]
        pat_len = len(self.block_pattern)
        return head, rest[:pat_len], rest[self.n_body * pat_len:]

    @property
    def n_body(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.block_pattern)

    def attn_cfg(self, mixer: str) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, mrope_sections=self.mrope_sections,
            window=self.window if mixer == "local" else None,
            cap=self.attn_cap, qkv_bias=self.qkv_bias,
            use_rope=self.pos_embedding == "rope")

    def rwkv_cfg(self) -> L.RWKVConfig:
        return L.RWKVConfig(d_model=self.d_model,
                            n_heads=self.d_model // self.rwkv_head_size,
                            d_ff=self.d_ff)

    def rglru_cfg(self) -> L.RGLRUConfig:
        return L.RGLRUConfig(d_model=self.d_model,
                             d_rnn=self.rglru_width or self.d_model,
                             conv_width=self.conv_width)

    def n_params(self) -> int:
        """Total parameter count (for 6ND model flops), from the shapes of
        `init_params` on the meta device."""
        shapes = init_params(self, torch.Generator(), device="meta")
        return sum(math.prod(x.shape) for x in _leaves(shapes))

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed experts count top_k/E)."""
        total = self.n_params()
        if self.moe is None:
            return total
        E, K = self.moe.n_experts, self.moe.top_k
        n_moe_layers = sum(1 for _, f in self.layer_plan if f == "moe")
        per_expert = 3 * self.d_model * self.moe.d_expert
        routed = n_moe_layers * E * per_expert
        return int(total - routed + n_moe_layers * K * per_expert)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

def _norm_w(cfg: ArchConfig, device) -> torch.Tensor:
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    return fill((cfg.d_model,), dtype=torch.float32, device=device)


def _block_init(gen: torch.Generator, cfg: ArchConfig, mixer: str, ffn: str,
                dtype, device) -> Params:
    d = cfg.d_model
    p: Params = {"ln1": _norm_w(cfg, device)}
    if mixer in ("attn", "local"):
        p["attn"] = L.attn_init(gen, cfg.attn_cfg(mixer), dtype, device)
    elif mixer == "rglru":
        p["rglru"] = L.rglru_init(gen, cfg.rglru_cfg(), dtype, device)
    elif mixer == "rwkv":
        p["rwkv"] = L.rwkv_init(gen, cfg.rwkv_cfg(), dtype, device)
    else:
        raise _unknown(mixer)
    p["ln2"] = _norm_w(cfg, device)
    if ffn == "moe":
        p["moe"] = L.moe_init(gen, d, cfg.moe, dtype, device)
    elif ffn == "rwkv_cm":
        pass            # rwkv_init already holds the channel-mix weights
    elif ffn in ("swiglu", "geglu", "mlp"):
        f = cfg.dense_ff if (cfg.moe is not None and cfg.dense_ff) \
            else cfg.d_ff
        p["mlp"] = L.mlp_init(gen, d, f, ffn, dtype, device)
    else:
        raise _unknown(ffn)
    if cfg.post_norm:
        p["pln1"] = _norm_w(cfg, device)
        p["pln2"] = _norm_w(cfg, device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Params:
    """Random weights with the reference's shapes and scales, drawn from
    ``gen`` (a ``torch.Generator`` on ``device``).  The numbers differ from
    the reference's ``jax.random`` draws; carry those across with
    `params_from_jax`.  ``device`` defaults to "cuda" and raises without a
    card; "meta" gives the shapes and dtypes alone."""
    L.check_init_device(device)
    device = torch.device(device)
    V, d, K = cfg.vocab_padded, cfg.d_model, cfg.n_codebooks
    params: Params = {
        "embed": L._normal(gen, (K, V, d) if K > 1 else (V, d), 0.02, dtype,
                           device),
        "final_ln": _norm_w(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(gen, (K, d, V) if K > 1 else (d, V),
                                      1.0 / math.sqrt(d), dtype, device)
    if cfg.vlm_patches:
        params["patch_proj"] = L._normal(gen, (d, d), 1.0 / math.sqrt(d),
                                         dtype, device)
    params["layers"] = [_block_init(gen, cfg, mixer, ffn, dtype, device)
                        for mixer, ffn in cfg.layer_plan]
    return params


# ----------------------------------------------------------------------
# carrying the reference's trees across
# ----------------------------------------------------------------------

#: the reference's top-level leaves other than the layers
_TOP_KEYS = ("embed", "final_ln", "lm_head", "patch_proj")


def _layer_keys(cfg: ArchConfig) -> list[tuple[str, int | None, str | None]]:
    """Where layer i lives in the reference's tree: (top key, body group
    index or None, key inside the group or None)."""
    head, body, tail = cfg.groups
    return ([(f"head{j}", None, None) for j in range(len(head))]
            + [("body", g, f"b{j}") for g in range(cfg.n_body)
               for j in range(len(body))]
            + [(f"tail{j}", None, None) for j in range(len(tail))])


def _leaves(node) -> list:
    if isinstance(node, dict):
        return [x for v in node.values() for x in _leaves(v)]
    if isinstance(node, list):
        return [x for v in node for x in _leaves(v)]
    return [node]


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    return fn(node)


def _to_torch(x, device, g: int | None = None) -> torch.Tensor:
    """One leaf as a tensor (row ``g`` of a stacked leaf); bfloat16 numpy
    arrays cross as their bits, a tensor (a restored checkpoint's leaf) as
    it is."""
    if isinstance(x, torch.Tensor):
        return (x if g is None else x[g]).detach().clone().to(device)
    arr = np.asarray(x)
    if g is not None:
        arr = arr[g]
    arr = np.array(arr, order="C")      # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _unstack(cfg: ArchConfig, tree: dict, device) -> list:
    out = []
    for top, g, key in _layer_keys(cfg):
        node = tree[top] if g is None else tree[top][key]
        out.append(_tree_map(lambda x, g=g: _to_torch(x, device, g), node))
    return out


def params_from_jax(cfg: ArchConfig, tree: dict, device="cuda") -> Params:
    """The reference's ``init_params`` tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) as this port's parameters: the head and
    tail layers and the stacked body, unstacked along axis 0, become one
    dict per layer; every leaf keeps its layout and dtype (a codebook
    model's embedding (K, V, d) and head (K, d, V) included)."""
    check_device(device)
    params = {key: _to_torch(tree[key], device)
              for key in _TOP_KEYS if key in tree}
    params["layers"] = _unstack(cfg, tree, device)
    return params


def state_from_jax(cfg: ArchConfig, tree: dict, device="cuda") -> Params:
    """The reference's decode-state tree (``init_decode_state`` / ``prefill``
    output) as this port's ``{"layers": [...]}`` state."""
    check_device(device)
    return {"layers": _unstack(cfg, tree, device)}


# ----------------------------------------------------------------------
# block application (shared by forward / prefill / decode)
# ----------------------------------------------------------------------

def _norm(x, w, cfg: ArchConfig):
    return L.rms_norm(x, w, plus_one=cfg.norm_plus_one)


def _apply_block(bp: Params, x: torch.Tensor, cfg: ArchConfig, mixer: str,
                 ffn: str, positions, mode: str, state, pos=None):
    """mode: train | prefill | decode.  Returns (x, new_state)."""
    new_state: dict = {}
    h = _norm(x, bp["ln1"], cfg)
    if mixer in ("attn", "local"):
        acfg = cfg.attn_cfg(mixer)
        if mode == "train":
            a = L.attn_forward(bp["attn"], h, acfg, positions)
        elif mode == "prefill":
            a, kv = L.attn_prefill(bp["attn"], h, acfg, positions)
            new_state["kv"] = kv
        else:
            a, kv = L.attn_decode(bp["attn"], h, acfg, state["kv"], pos)
            new_state["kv"] = kv
    elif mixer == "rglru":
        gcfg = cfg.rglru_cfg()
        st = state.get("rglru") if state else None
        a, (conv, hh) = L.rglru_block(bp["rglru"], h, gcfg,
                                      (st["conv"], st["h"]) if st else None)
        if mode != "train":
            new_state["rglru"] = {"conv": conv, "h": hh}
    elif mixer == "rwkv":
        st = state.get("rwkv") if state else None
        a, (xc, s1) = L.rwkv_time_mix(bp["rwkv"], h, cfg.rwkv_cfg(),
                                      st["x_tm"] if st else None,
                                      st["s"] if st else None)
        if mode != "train":
            new_state["rwkv"] = {"x_tm": xc, "s": s1}
    else:
        raise _unknown(mixer)
    if cfg.post_norm:
        # on a mesh the sublayer's partial sums are reduced into the
        # residual's layout before the norm, not whole
        a = _norm(logical(a, "batch", "seq", "embed"), bp["pln1"], cfg)
    x = x + a
    h = _norm(x, bp["ln2"], cfg)
    if ffn == "moe":
        f = L.moe_forward(bp["moe"], h, cfg.moe)
    elif ffn == "rwkv_cm":
        f, xc = L.rwkv_channel_mix(bp["rwkv"], h,
                                   state.get("rwkv_cm") if state else None)
        if mode != "train":
            new_state["rwkv_cm"] = xc
    elif ffn in ("swiglu", "geglu", "mlp"):
        f = L.mlp_forward(bp["mlp"], h, ffn)
    else:
        raise _unknown(ffn)
    if cfg.post_norm:
        f = _norm(logical(f, "batch", "seq", "embed"), bp["pln2"], cfg)
    return logical(x + f, "batch", "seq", "embed"), new_state


# ----------------------------------------------------------------------
# embedding / positions / heads
# ----------------------------------------------------------------------

def _embed(params: Params, cfg: ArchConfig, batch: dict):
    """batch {"tokens": (B, S) or (B, S, K) codes, "patches": (B, P, d)
    for a vision model} -> (x (B, P + S, d), positions)."""
    if cfg.n_codebooks > 1:
        codes = batch["tokens"]
        # summed left to right in the activation dtype, as the reference's
        # Python sum does
        x = lookup(params["embed"][0], codes[..., 0])
        for k in range(1, cfg.n_codebooks):
            x = x + lookup(params["embed"][k], codes[..., k])
    else:
        x = lookup(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    if cfg.vlm_patches:
        patches = project(batch["patches"].to(x.dtype),
                          ("bpe,ed->bpd", params["patch_proj"], L._mm))
        x = torch.cat([patches, x], dim=1)
        S = x.shape[1]
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype before the multiply
        x = x * replicated_like(torch.tensor(math.sqrt(cfg.d_model),
                                             dtype=x.dtype, device=x.device),
                                x)
    if cfg.pos_embedding == "sinusoidal":
        x = x + replicated_like(L.sinusoidal_positions(
            S, cfg.d_model, device=x.device).to(x.dtype)[None], x)
    return (logical(x, "batch", "seq", "embed"),
            replicated_like(_positions(cfg, B, S, x.device), x))


def _positions(cfg: ArchConfig, B: int, S: int, device) -> torch.Tensor:
    """(B, S) token positions, or (3, B, S) under M-RoPE: the P patches get
    a (t=0, h, w) grid of side floor(sqrt(P)), the text continues with
    t = h = w counting from 0 (the reference's grid: text token j sits at
    position j, not P + j)."""
    ar = torch.arange(S, device=device)
    if cfg.mrope_sections is None:
        return ar[None].expand(B, S)
    P = cfg.vlm_patches
    side = max(int(math.sqrt(max(P, 1))), 1)
    pa, text = torch.arange(P, device=device), ar[:S - P]
    pos = torch.stack([torch.cat([torch.zeros_like(pa), text]),
                       torch.cat([pa // side, text]),
                       torch.cat([pa % side, text])])          # (3, S)
    return pos[:, None, :].expand(3, B, S)


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor):
    """The LM head's product on the final-normed ``x``: (B, S, V), or
    (B, S, K, V) for codebooks.  On DTensors a region of its own
    (`project`): the batch stays split on the data axes, the vocab on the
    TP axes, the weight gathered over FSDP and ``x`` over the sequence."""
    x = _norm(x, params["final_ln"], cfg)
    if cfg.n_codebooks > 1:
        # (K, d, V), or the tied (K, V, d) embedding transposed
        if cfg.tie_embeddings:
            term = ("bsd,kvd->bskv", params["embed"], lambda x, w: torch.einsum(
                "bsd,kdv->bskv", x, w.transpose(1, 2)))
        else:
            term = ("bsd,kdv->bskv", params["lm_head"],
                    lambda x, w: torch.einsum("bsd,kdv->bskv", x, w))
    elif cfg.tie_embeddings:
        term = ("bsd,vd->bsv", params["embed"], lambda x, w: x @ w.T)
    else:
        term = ("bsd,dv->bsv", params["lm_head"], lambda x, w: x @ w)
    return project(x, term)


def _cap_and_mask(cfg: ArchConfig, logits: torch.Tensor, pad):
    """The logit softcap, then the padded vocab slots (``pad`` True) moved
    to -1e9, out of softmax and argmax."""
    if cfg.logit_cap is not None:
        logits = L.softcap(logits.float(), cfg.logit_cap)
    if pad is not None:
        logits = logits + pad * torch.tensor(-1e9, dtype=logits.dtype,
                                             device=logits.device)
    return logits


def _lm_logits(params: Params, cfg: ArchConfig, x: torch.Tensor):
    logits = _head(params, cfg, x)
    pad = None
    if cfg.vocab_padded != cfg.vocab:
        pad = replicated_like(torch.arange(cfg.vocab_padded,
                                           device=x.device) >= cfg.vocab, x)
    return logical(_cap_and_mask(cfg, logits, pad), "batch", None, "vocab")


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross entropy of local logits (..., V/n) float32 whose
    vocab shard starts at ``lo``, the shards combined over ``groups`` (a
    (mesh, dim) each): each shard's logsumexp, their max M and the sum of
    exp(lse_s - M) all-reduced, M + log of it; the gold logit a masked
    local gather, summed.  One shard (no group) keeps its own logsumexp,
    which the combination would give bit for bit (M + log(exp(lse - M))
    = lse), so a world-size-1 mesh equals the plain call.  The backward
    is local: softmax minus one-hot on the shard (Megatron's
    vocab-parallel cross entropy)."""

    @staticmethod
    def forward(ctx, lg, labels, lo: int, groups: tuple):
        from torch.distributed import _functional_collectives as fc

        def reduce(t, op):
            for g in groups:
                t = fc.wait_tensor(fc.all_reduce(t, op, g))
            return t
        lse = torch.logsumexp(lg, dim=-1)
        if groups:
            m = reduce(lse, "max")
            lse = m + torch.log(reduce(torch.exp(lse - m), "sum"))
        local = labels.long() - lo
        hit = (local >= 0) & (local < lg.shape[-1])
        idx = local.clamp(0, lg.shape[-1] - 1)[..., None]
        gold = reduce(torch.gather(lg, -1, idx)[..., 0] * hit, "sum")
        ctx.save_for_backward(lg, lse, idx, hit)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        lg, lse, idx, hit = ctx.saved_tensors
        d = g[..., None] * torch.exp(lg - lse[..., None])
        d.scatter_add_(-1, idx, (-g * hit)[..., None])
        return d, None, None, None


def _token_losses(cfg: ArchConfig, logits, labels):
    """Per-token cross entropy of raw head logits (DTensors, the vocab
    split on the TP axes) on local shards: `vocab_parallel` hands each
    rank its (B/dp, chunk, V/tp) logits, softcapped and masked there, and
    `_VocabParallelCE` combines the shards; no rank holds more than its
    own shard of a chunk's logits."""
    def body(lg, lab, lo, groups):
        pad = None
        if cfg.vocab_padded != cfg.vocab:
            pad = torch.arange(lo, lo + lg.shape[-1],
                               device=lg.device) >= cfg.vocab
        lg = _cap_and_mask(cfg, lg, pad).float()
        return _VocabParallelCE.apply(lg, lab, lo, groups)
    return vocab_parallel(body, logits, labels)


# ----------------------------------------------------------------------
# full passes
# ----------------------------------------------------------------------

@torch.no_grad()
def forward(params: Params, cfg: ArchConfig, batch: dict):
    """Scoring forward: logits (B, S, V), or (B, S, K, V) for codebooks,
    over the full sequence (patches included)."""
    x, positions = _embed(params, cfg, batch)
    for bp, (mixer, ffn) in zip(params["layers"], cfg.layer_plan):
        x, _ = _apply_block(bp, x, cfg, mixer, ffn, positions, "train", None)
    return _lm_logits(params, cfg, x)


def _train_block(bp: Params, x: torch.Tensor, cfg: ArchConfig, mixer: str,
                 ffn: str, positions) -> torch.Tensor:
    return _apply_block(bp, x, cfg, mixer, ffn, positions, "train", None)[0]


def forward_hidden(params: Params, cfg: ArchConfig, batch: dict):
    """The training pass's backbone: final hidden states (B, P + S, d),
    before the LM head, with autograd.  Under ``cfg.remat`` (and grad mode)
    each layer runs under ``torch.utils.checkpoint`` (non-reentrant): only
    its input is kept, and its activations are recomputed in the
    backward, under the activation rules of the forward (the backward of a
    CUDA tensor runs on autograd's own thread)."""
    x, positions = _embed(params, cfg, batch)
    remat = cfg.remat and torch.is_grad_enabled()
    block = under_current_rules(_train_block)
    for bp, (mixer, ffn) in zip(params["layers"], cfg.layer_plan):
        if remat:
            x = checkpoint(block, bp, x, cfg, mixer, ffn, positions,
                           use_reentrant=False)
        else:
            x = _train_block(bp, x, cfg, mixer, ffn, positions)
    return x


def _chunk_loss(params: Params, cfg: ArchConfig, x: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross entropy of one sequence chunk: the LM head,
    the float32 logsumexp, minus the gold logit; on DTensors the
    vocab-parallel cross entropy (`_token_losses`)."""
    if is_dtensor(x):
        return torch.sum(_token_losses(cfg, _head(params, cfg, x), labels))
    logits = _lm_logits(params, cfg, x).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def loss_fn(params: Params, cfg: ArchConfig, batch: dict,
            seq_chunk: int = 512) -> torch.Tensor:
    """Next-token cross entropy, the mean over tokens (times codebooks),
    float32 logsumexp.  As the reference, the LM head and the loss run in
    sequence chunks of ``seq_chunk`` (halved until it divides S), so the
    full (B, S, vocab) logits never exist at once; under ``cfg.remat``
    each chunk is checkpointed too, so one chunk's float32 logits are
    alive at a time in the backward as well.  A vision model's patch
    positions are sliced off before the head."""
    x = forward_hidden(params, cfg, batch)
    labels = batch["labels"]
    if cfg.vlm_patches:
        x = x[:, cfg.vlm_patches:]
    B, S = x.shape[:2]
    while S % seq_chunk != 0:
        seq_chunk //= 2
    remat = cfg.remat and torch.is_grad_enabled()
    chunk_loss = under_current_rules(_chunk_loss)
    total = replicated_like(torch.zeros((), dtype=torch.float32,
                                        device=x.device), x)
    for i in range(S // seq_chunk):
        part = slice(i * seq_chunk, (i + 1) * seq_chunk)
        if remat:
            total = total + checkpoint(chunk_loss, params, cfg, x[:, part],
                                       labels[:, part], use_reentrant=False)
        else:
            total = total + _chunk_loss(params, cfg, x[:, part],
                                        labels[:, part])
    n_tok = B * S * (cfg.n_codebooks if cfg.n_codebooks > 1 else 1)
    return total / n_tok


def init_decode_state(cfg: ArchConfig, B: int, S_max: int,
                      dtype=torch.bfloat16, device="cuda") -> Params:
    """Zeroed decode state for every layer (KV caches + recurrent states).
    A local layer's cache holds min(S_max, window) slots: a ring.  The
    recurrent states ``rglru.h`` and ``rwkv.s`` are float32, the rest
    ``dtype``; an ffn has no state except the RWKV channel-mix's carry."""
    L.check_init_device(device)
    layers = []
    for mixer, ffn in cfg.layer_plan:
        st: dict = {}
        if mixer in ("attn", "local"):
            KV, hd = cfg.n_kv_heads, cfg.head_dim
            S_eff = min(S_max, cfg.window) if (mixer == "local"
                                               and cfg.window) else S_max
            st["kv"] = {
                "k": torch.zeros((B, S_eff, KV, hd), dtype=dtype, device=device),
                "v": torch.zeros((B, S_eff, KV, hd), dtype=dtype, device=device)}
        elif mixer == "rglru":
            dr = cfg.rglru_width or cfg.d_model
            st["rglru"] = {
                "conv": torch.zeros((B, cfg.conv_width - 1, dr), dtype=dtype,
                                    device=device),
                "h": torch.zeros((B, dr), dtype=torch.float32, device=device)}
        elif mixer == "rwkv":
            N = cfg.rwkv_head_size
            H = cfg.d_model // N
            st["rwkv"] = {
                "x_tm": torch.zeros((B, cfg.d_model), dtype=dtype,
                                    device=device),
                "s": torch.zeros((B, H, N, N), dtype=torch.float32,
                                 device=device)}
        else:
            raise _unknown(mixer)
        if ffn == "rwkv_cm":
            st["rwkv_cm"] = torch.zeros((B, cfg.d_model), dtype=dtype,
                                        device=device)
        layers.append(st)
    return {"layers": layers}


@torch.no_grad()
def decode_step(params: Params, cfg: ArchConfig, state: Params,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step.  tokens (B, 1), or (B, 1, K) codes; pos (B,) write
    index (for a vision model it counts the prefilled patches).

    Returns (logits (B, 1, V...), new_state); KV caches are updated in
    place.  A vision model decodes text only (its patches are in the
    cache already); sinusoidal positions are added at ``pos``.
    """
    ecfg = cfg
    if cfg.vlm_patches:
        ecfg = dataclasses.replace(ecfg, vlm_patches=0)
    if cfg.pos_embedding == "sinusoidal":
        ecfg = dataclasses.replace(ecfg, pos_embedding="none")
    x, _ = _embed(params, ecfg, {"tokens": tokens})
    if cfg.pos_embedding == "sinusoidal":
        pe = L._sinusoid(pos.float(), cfg.d_model)             # (B, d)
        x = x + pe[:, None, :].to(x.dtype)
    n_head = len(cfg.groups[0])
    body = range(n_head, n_head + cfg.n_body * len(cfg.block_pattern))
    new_layers = []
    for i, (bp, st, (mixer, ffn)) in enumerate(zip(
            params["layers"], state["layers"], cfg.layer_plan)):
        x, nst = _apply_block(bp, x, cfg, mixer, ffn, None, "decode", st, pos)
        if i in body:
            # the reference carries the body's states in its scan carry,
            # which casts each new state back to the dtype it came in
            nst = _cast_like(nst, st)
        new_layers.append(nst)
    return _lm_logits(params, cfg, x), {"layers": new_layers}


def _cast_like(new, old):
    if isinstance(new, dict):
        return {k: _cast_like(v, old[k]) for k, v in new.items()}
    return new.to(old.dtype)


@torch.no_grad()
def prefill(params: Params, cfg: ArchConfig, batch: dict,
            last_only: bool = False):
    """Forward over a prompt (a vision model's patches first), returning
    (logits, decode state).

    last_only=True computes the LM head for the final position only: the
    serving configuration (full-sequence logits at 4k x 256k vocab would
    dwarf the backbone's memory).
    """
    x, positions = _embed(params, cfg, batch)
    new_layers = []
    for bp, (mixer, ffn) in zip(params["layers"], cfg.layer_plan):
        x, st = _apply_block(bp, x, cfg, mixer, ffn, positions, "prefill",
                             None)
        new_layers.append(st)
    if last_only:
        x = x[:, -1:]
    return _lm_logits(params, cfg, x), {"layers": new_layers}
