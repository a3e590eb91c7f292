"""Serving engine: prefill + batched decode with explicit state.

Ports ``repro.serve.engine``.  `greedy_generate` prefills a batch of
prompts and decodes greedily; `Batcher` serves a request queue in
fixed-size decode batches, refilling finished rows from the queue (slot
reuse) and feeding each prompt token by token through the decode step, as
the reference does.  Both take ``device=``: "cuda" by default, which raises
without a card, or "cpu" for the plain PyTorch versions of the kernels.
Nothing falls back to the CPU on its own.

`greedy_generate` also runs a sharded program: called with DTensor
parameters (``launch.sharding.distribute_tree``, ``fsdp=False``) and a
DTensor prompt (``distribute_batch``) inside
``models.sharding.activation_sharding``, it prefills and decodes on the
mesh, and its argmax tokens come back replicated, the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..core.engine.kernels import check_device
from ..models import model as M
from ..models.sharding import is_dtensor, logical, replicated_like


@dataclasses.dataclass
class ServeConfig:
    """Decode slots and the KV-cache length of each (decoding is greedy)."""
    max_seq: int = 1024
    batch: int = 8


def _check_params(params, device) -> torch.device:
    kind = check_device(device)
    have = params["embed"].device
    if have.type != kind:
        raise ValueError(f"params are on {have}, but device={device!r}")
    return have


def pad_prefill_state(cfg: M.ArchConfig, state: dict, S_max: int) -> dict:
    """Grow prefill KV caches to S_max slots (recurrent states untouched).

    A local layer's padded cache is then larger than its window, so decode
    treats it as a plain cache with a window mask, not as a ring."""
    layers = []
    for st in state["layers"]:
        st = dict(st)
        if "kv" in st:
            pad = S_max - st["kv"]["k"].shape[-3]
            if pad < 0:
                raise ValueError(f"S_max={S_max} is below the prompt length "
                                 f"{st['kv']['k'].shape[-3]}")
            st["kv"] = {n: F.pad(t, (0, 0, 0, 0, 0, pad))
                        for n, t in st["kv"].items()}
        layers.append(st)
    return {"layers": layers}


def make_decode_fn(cfg: M.ArchConfig) -> Callable:
    """step(params, state, tokens, pos) -> (logits, state): one decode step
    (the reference jits it; PyTorch runs it eagerly)."""
    def step(params, state, tokens, pos):
        return M.decode_step(params, cfg, state, tokens, pos)
    return step


@torch.no_grad()
def greedy_generate(params, cfg: M.ArchConfig, prompt, n_new: int,
                    s_max: int | None = None, device="cuda") -> torch.Tensor:
    """Generate n_new tokens after ``prompt`` (B, S0), or (B, S0, K) codes
    for a codebook model.  Returns (B, n_new) int32, or (B, n_new, K), on
    the params' device.

    As in the reference, a vision model cannot be served here: its
    prefill reads ``patches``, which this entry point does not take (the
    reference's does not either); its decode steps take text alone (see
    `Batcher`).

    The reference prefills with full-sequence logits and reads only the
    last position's; this port calls ``prefill(last_only=True)``, which
    computes exactly those logits and yields the same tokens without the
    (B, S0, vocab) float32 tensor (16.8 GB at 4 x 4096 x 256,000).
    """
    dev = _check_params(params, device)
    if is_dtensor(params["embed"]) and not is_dtensor(prompt):
        raise TypeError("greedy_generate on DTensor parameters takes a "
                        "DTensor prompt (launch.sharding.distribute_batch): "
                        "a plain one may differ between ranks")
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    B, S0 = prompt.shape[:2]
    s_max = s_max or (S0 + n_new)
    logits, state = M.prefill(params, cfg, {"tokens": prompt},
                              last_only=True)
    state = pad_prefill_state(cfg, state, s_max)
    step = make_decode_fn(cfg)
    # (B, 1) or (B, 1, K); on a mesh, replicated
    last = logical(torch.argmax(logits[:, -1:], dim=-1))
    out = []
    pos = replicated_like(torch.full((B,), S0, dtype=torch.int64, device=dev),
                          prompt)
    for _ in range(n_new):
        logits, state = step(params, state, last, pos)
        last = logical(torch.argmax(logits[:, -1:], dim=-1))
        out.append(last)
        pos = pos + 1
    return torch.cat(out, dim=1).to(torch.int32)


class Batcher:
    """Slot-based continuous batching over a request queue."""

    def __init__(self, params, cfg: M.ArchConfig, scfg: ServeConfig,
                 device="cuda"):
        self.device = _check_params(params, device)
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.step = make_decode_fn(cfg)

    @torch.no_grad()
    def serve(self, prompts: list[np.ndarray], n_new: int) -> list[np.ndarray]:
        """Serve a list of (S0,) prompts; returns a list of (n_new,) outputs,
        or (n_new, K) for a codebook model.

        As in the reference, a codebook model's prompt token goes to all K
        codebooks, and a slot's decode state is not cleared when a
        new request takes it: the prompt restarts at position 0, the
        attention masks hide older cache entries, and the recurrent state
        carries over.  The decode state is made in bfloat16 (the
        reference's default), the recurrent ``h`` in float32.
        """
        cfg, scfg, dev = self.cfg, self.scfg, self.device
        results: list[np.ndarray | None] = [None] * len(prompts)
        queue = list(range(len(prompts)))
        B = scfg.batch
        state = M.init_decode_state(cfg, B, scfg.max_seq, device=dev)
        slot_req = [-1] * B
        slot_pos = np.zeros(B, np.int64)
        slot_out: list[list] = [[] for _ in range(B)]
        pending: dict[int, list] = {}

        def admit(slot):
            if not queue:
                slot_req[slot] = -1
                return
            rid = queue.pop(0)
            slot_req[slot] = rid
            # prefill by stepping the prompt's tokens through this slot
            slot_pos[slot] = 0
            slot_out[slot] = []
            pending[slot] = list(np.asarray(prompts[rid]).tolist())

        for s in range(B):
            admit(s)
        K = cfg.n_codebooks
        cur_np = np.zeros((B, 1) if K == 1 else (B, 1, K), np.int64)
        while any(r >= 0 for r in slot_req):
            # feed either the next prompt token or the last generated token
            for s in range(B):
                if slot_req[s] >= 0 and pending.get(s):
                    cur_np[s] = pending[s].pop(0)
            cur = torch.tensor(cur_np, device=dev)
            pos = torch.tensor(slot_pos, device=dev)
            logits, state = self.step(self.params, state, cur, pos)
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()  # (B[, K])
            for s in range(B):
                if slot_req[s] < 0:
                    continue
                slot_pos[s] += 1
                if not pending.get(s):
                    slot_out[s].append(nxt[s].copy())
                    cur_np[s] = nxt[s]
                    if len(slot_out[s]) >= n_new:
                        results[slot_req[s]] = np.array(slot_out[s], np.int32)
                        admit(s)
        return results  # type: ignore
