"""Training step: loss -> grads -> AdamW, with gradient accumulation over
microbatches (a port of ``repro.train.step``).

Gradients come from ``loss.backward()`` through the model's training pass
(`model.loss_fn`), and on the card through the hand-written backward
kernels of flash attention and the RG-LRU scan.  With ``microbatches >
1`` the batch is cut into equal slices, taken in ``microbatch_order``
(the static permutation the DAGPS pipeline scheduler produces,
`train.pipeline`), each slice's gradients added into float32
accumulators, and the mean of the gradients and of the losses taken, as
the reference's ``lax.scan`` does; with one microbatch the gradients stay
in the parameters' dtype, as the reference's ``value_and_grad`` gives
them.  The step then applies AdamW (`optim.apply_updates`), which updates
the parameters and the optimizer state in place.

The same step runs a sharded program: with the parameters, the AdamW
state and the batch distributed as DTensors (`launch.sharding`'s
``distribute_tree`` and ``distribute_batch``) and the call made inside
``models.sharding.activation_sharding``, every tensor of the step keeps
its leaf's placements (the accumulators too), and the loss comes back
replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.engine.kernels import check_device
from ..models import model as M
from ..models.sharding import is_dtensor, logical, replicated_like
from ..optim import AdamWConfig, apply_updates, init_state, tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatches: int = 1
    microbatch_order: tuple[int, ...] | None = None   # from DAGPS


def _params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


def _as_param(g, p):
    """The gradient ``g`` in the layout of its parameter ``p``: on a mesh,
    DTensor's partial sums reduced here once, and not again at each use
    in AdamW; a plain tensor or None as it is."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(g.device_mesh, p.placements)


def loss_and_grads(params, cfg: M.ArchConfig, batch: dict,
                   microbatches: int = 1, order=None):
    """(loss, grads) of `model.loss_fn` on ``batch``: grads a list of
    tensors in the order of ``tree_leaves(params)`` (None where a
    parameter does not reach the loss).  ``microbatches > 1``: the mean
    over equal slices of the batch taken in ``order``, gradients summed
    into float32 accumulators and divided."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    try:
        if microbatches <= 1:
            loss = M.loss_fn(params, cfg, batch)
            loss.backward()
            return logical(loss.detach()), [_as_param(p.grad, p)
                                            for p in leaves]
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} "
                             "microbatches")
        mb = B // microbatches
        order = range(microbatches) if order is None else order
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        lsum = replicated_like(torch.zeros((), dtype=torch.float32,
                                           device=_params_device(params)),
                               leaves[0])
        for i in order:
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            li = M.loss_fn(params, cfg, part)
            li.backward()
            with torch.no_grad():
                for a, p in zip(acc, leaves):
                    if p.grad is not None:
                        a.add_(p.grad.float())
                        p.grad = None
            lsum = lsum + li.detach()
        for a in acc:
            a.div_(microbatches)
        return logical(lsum / microbatches), acc
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)


def make_train_step(cfg: M.ArchConfig, tcfg: TrainConfig,
                    device="cuda") -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics holds ``loss``, ``lr`` and ``grad_norm`` (float32
    scalar tensors).  The step updates ``params`` and ``opt_state`` in
    place and returns them.  It runs on ``device`` ("cuda" by default: a
    call raises without a card), where the parameters must lie."""

    def train_step(params, opt_state, batch):
        kind = check_device(device)
        if _params_device(params).type != kind:
            raise ValueError(f"the parameters are on "
                             f"{_params_device(params)}, the step on {kind}")
        loss, grads = loss_and_grads(params, cfg, batch, tcfg.microbatches,
                                     tcfg.microbatch_order)
        params, opt_state, om = apply_updates(tcfg.optimizer, params, grads,
                                              opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def init_train_state(cfg: M.ArchConfig, tcfg: TrainConfig,
                     gen: torch.Generator, dtype=torch.bfloat16,
                     device="cuda"):
    """Random parameters (`model.init_params` from ``gen``, a generator on
    ``device``) and their zeroed AdamW state.  ``device`` defaults to
    "cuda" and raises without a card."""
    params = M.init_params(cfg, gen, device=device, dtype=dtype)
    return params, init_state(tcfg.optimizer, params)
