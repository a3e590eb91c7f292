"""AdamW with float32 master weights: a port of ``repro.optim.adamw``.

The state mirrors the parameter tree leaf for leaf (``m``, ``v`` and
``master`` float32, ``step`` an int32 scalar tensor), the port's layout of
dicts and lists (``params["layers"][i]``).  The arithmetic is the
reference's, op for op: a float32 global-norm clip, the linear-warmup /
cosine schedule and the bias corrections from the step in float32, weight
decay on the float32 master, parameters cast back to their dtype.

Unlike the reference's pure function, `apply_updates` updates the
parameters and the state in place (one leaf at a time, its temporaries
freed before the next), so a full-width model's state exists once: at
recurrentgemma-2b's 2.9e9 parameters ``m``, ``v`` and ``master`` take
34.7 GB.  It returns the same trees.

On DTensor parameters (a sharded step) ``m``, ``v`` and ``master`` keep
each parameter's placements, the step counter and the schedule's
scalars are replicated, and the global norm is summed over every shard
and comes out replicated.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.engine.kernels import check_device
from ..models import model as M
from ..models.sharding import as_partial, logical, replicated_like


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_weights: bool = True
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of dicts and lists that share one
    structure; returns the mapped tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, dict keys in sorted order
    (as ``jax.tree.leaves``), so trees with the same keys list their leaves
    alike whatever order their dicts were built in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_state(cfg: AdamWConfig, params) -> dict:
    """Zeroed ``m`` and ``v``, step 0 and (with master weights) a float32
    copy of every parameter, on the parameters' device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.master_weights:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def opt_state_from_jax(cfg, tree: dict, device="cuda") -> dict:
    """The reference's AdamW state (``m``, ``v``, ``master`` in its
    parameter layout, leaves as numpy arrays or tensors; ``step``) in this
    port's layout, as `model.params_from_jax` carries the parameters."""
    check_device(device)
    state = {k: M.params_from_jax(cfg, tree[k], device)
             for k in ("m", "v", "master") if k in tree}
    state["step"] = M._to_torch(tree["step"], device).to(torch.int32)
    return state


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step.  Returns (params, state, {"lr", "grad_norm"}), the
    trees updated in place.  A parameter whose gradient is None (no path
    to the loss) takes a zero gradient, as the reference's does."""
    p_leaves = tree_leaves(params)
    step = replicated_like(state["step"], p_leaves[0]) + 1
    lr = schedule(cfg, step)
    g_leaves = [torch.zeros_like(p) if g is None else g
                for p, g in zip(p_leaves, tree_leaves(grads))]
    # global-norm clip in fp32; on a mesh each leaf's square sum is laid
    # out as a partial sum over every mesh dim, so the sum over leaves is
    # local and reduced once (the layout does not depend on the leaves
    # that came before)
    gsq = sum(as_partial(torch.sum(torch.square(g.float()))) for g in g_leaves)
    gnorm = torch.sqrt(logical(gsq))
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    masters = (tree_leaves(state["master"]) if cfg.master_weights
               else [None] * len(p_leaves))
    for p, g, m, v, master in zip(p_leaves, g_leaves,
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"]), masters):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))           # b1 m + (1-b1) g
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)       # b2 v + (1-b2) g g
        del g
        mf = master if master is not None else p.float()
        den = torch.sqrt(v / b2c).add_(cfg.eps)         # sqrt(vh) + eps
        upd = (m / b1c).div_(den)                       # mh / (...)
        del den
        upd.add_(cfg.weight_decay * mf).mul_(lr)        # lr (... + wd mf)
        new_master = mf.sub_(upd) if master is not None else mf - upd
        del upd
        p.copy_(new_master)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
