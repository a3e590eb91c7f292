"""Dry run: count every (arch x shape x mesh) cell on the meta device.

A port of ``repro.launch.dryrun``, which lowers and compiles each cell on
512 fake host devices.  Here one step of the cell's kind runs at the
cell's full global shape on meta tensors, which hold no data and compute
nothing, under an `AbstractMesh` of the production shape and its
activation rules; it needs no card, as the reference needed no TPU.  The
record keeps the reference's keys wherever ``launch/cluster.py``
`job_from_roofline` and ``launch/report.py`` read them
(``roofline.{compute_s, memory_s, collective_s, ...}``,
``memory.peak_live_bytes``), with ``count_s`` and ``aten_ops`` in place of
``compile_s`` and ``hlo_lines`` and ``memory.fits_80g`` in place of
``fits_16g``.  The terms, each per device:

  * **FLOPs.**  The step: train, `train.loss_and_grads` (forward and
    backward, with the recompute of its checkpoints) then AdamW's
    `apply_updates`; prefill, ``model.prefill(..., last_only=True)``;
    decode, ``model.decode_step``.  Counted under
    ``torch.utils.flop_counter.FlopCounterMode`` (its matrix products),
    plus the operations the LM ops' meta route charges (flash attention,
    the RG-LRU scan and WKV6, forward and backward, by the formulas in
    their ``ops.py``), divided by the mesh's device count: an even split,
    so compute a guard leaves replicated is not charged.
  * **Bytes.**  Per aten op, the bytes of its tensor operands and results
    (XLA's "bytes accessed" convention, on the unfused eager program the
    port runs; views and uninitialized allocations move none), plus the
    LM ops' charged bytes, divided by the device count.
  * **Collective bytes.**  `collectives_for`: the collectives the specs of
    ``launch/sharding.py`` and its `activation_rules` imply, each weighted
    by the ring cost of ``launch/roofline.py`` `collective_stats`.
  * **Peak memory.**  The exact local bytes, by the specs, of the
    parameters, AdamW's m, v and float32 master, the gradients (the
    parameters' dtype; with microbatches, float32 accumulators besides),
    the batch shard (and for serving the decode state), plus the
    activations the step keeps: each layer's checkpointed input, the
    residual stream's local shard (by `logical_spec` of ("batch", "seq",
    "embed")), n_layers + 1 of them, and one working set: the bytes
    autograd saves in one layer's forward (the largest layer kind) or in
    one loss chunk, whichever is more, measured on meta at a microbatch's
    global shape and split evenly over the devices.  Serving keeps no
    checkpoints; its working set is the same one-layer measure, an upper
    bound of what one layer's forward holds at once.

The meta run walks every layer (the port has no scanned body), so the
reference's unroll extrapolation (`roofline_cell`) is not needed.

Usage:
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out artifacts/dryrun]
  python -m repro_torch.launch.dryrun --arch mixtral_8x7b --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..data import batch_specs
from ..kernels import pin
from ..models import layers as L
from ..models import model as M
from ..models.sharding import activation_sharding, logical_spec
from . import roofline as RL
from .mesh import axis_size, data_axes, make_production_mesh, n_devices
from .sharding import (tree_items, activation_rules, batch_shardings,
                       local_shape, state_shardings, tp_axes, tree_shardings)

#: ops that move no bytes: they allocate without writing
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh"}


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Counts aten ops and the bytes of their tensor operands and results
    (a view, and an op that allocates without writing, moves none)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if not func.is_view and func.overloadpacket.__name__ not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in
                              _tensors((args, kwargs or {})) + _tensors(out))
        return out


def meta_params(cfg) -> dict:
    """The model's bf16 parameter tree on the meta device."""
    return M.init_params(cfg, torch.Generator(), device="meta")


def meta_batch(cfg, B: int, S: int, labels: bool = True) -> dict:
    specs = batch_specs(cfg, B, S)
    if not labels:
        specs.pop("labels")
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in specs.items()}


def _seq(cfg, S: int) -> int:
    """Positions the backbone sees: a vision model's patches come first."""
    return S + cfg.vlm_patches


def _saved_bytes(fn, exclude) -> int:
    """Bytes of the distinct storages autograd saves while ``fn()`` runs,
    those of ``exclude`` (parameters, the input) left out."""
    skip = {t.untyped_storage()._cdata for t in exclude}
    seen: dict = {}

    def pack(t):
        s = t.untyped_storage()
        if s._cdata not in skip:
            seen[s._cdata] = s.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def working_set(cfg, params, B: int, S_eff: int,
                loss_S: int | None = None) -> int:
    """Global bytes autograd saves in one layer's forward over (B, S_eff)
    (the largest layer kind) or, given the loss's ``loss_S`` positions,
    one loss chunk, whichever is more."""
    leaves = [t for _, t in tree_items(params)]
    dtype = params["embed"].dtype
    positions = M._positions(cfg, B, S_eff, "meta")
    best = 0
    done = set()
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            for bp, plan in zip(params["layers"], cfg.layer_plan):
                if plan in done:
                    continue
                done.add(plan)
                x = torch.empty((B, S_eff, cfg.d_model), dtype=dtype,
                                device="meta", requires_grad=True)
                best = max(best, _saved_bytes(
                    lambda: M._train_block(bp, x, cfg, *plan, positions),
                    leaves + [x]))
            if loss_S:
                chunk = 512
                while loss_S % chunk:
                    chunk //= 2
                x = torch.empty((B, chunk, cfg.d_model), dtype=dtype,
                                device="meta", requires_grad=True)
                tok = meta_batch(cfg, B, chunk)["labels"]
                best = max(best, _saved_bytes(
                    lambda: M._chunk_loss(params, cfg, x, tok), leaves + [x]))
        finally:
            for t in leaves:
                t.requires_grad_(False)
    return best


def _tree_local_bytes(tree, specs, mesh, itemsize=None) -> int:
    """Bytes of one device's shards of ``tree`` (``itemsize`` overrides the
    leaves' own)."""
    flat = dict(tree_items(specs))
    return sum(math.prod(local_shape(tuple(t.shape), flat[p], mesh))
               * (itemsize or t.element_size()) for p, t in tree_items(tree))


def memory_model(cfg, kind: str, B: int, S: int, mesh, rules: dict,
                 params, microbatches: int = 1) -> dict:
    """Peak live bytes per device, by component (the module docstring)."""
    train = kind == "train"
    specs = tree_shardings(params, mesh, cfg, fsdp=train)
    mem = {"param_bytes": _tree_local_bytes(params, specs, mesh)}
    n_dev = n_devices(mesh)
    if train:
        mem["opt_bytes"] = 3 * _tree_local_bytes(params, specs, mesh, 4)
        grads = mem["param_bytes"]
        if microbatches > 1:
            grads += _tree_local_bytes(params, specs, mesh, 4)
        mem["grad_bytes"] = grads
        bspec = batch_shardings(batch_specs(cfg, B, S), mesh)
        mem["batch_bytes"] = sum(
            math.prod(local_shape(shape, bspec[k], mesh)) * dt.itemsize
            for k, (shape, dt) in batch_specs(cfg, B, S).items())
        Bm = B // microbatches
        resid = (Bm, _seq(cfg, S), cfg.d_model)
        loc = local_shape(resid, logical_spec(resid, ("batch", "seq", "embed"),
                                              rules, mesh), mesh)
        mem["checkpoint_bytes"] = (cfg.n_layers + 1) * math.prod(loc) * 2
        mem["working_set_bytes"] = working_set(
            cfg, params, Bm, _seq(cfg, S), loss_S=S) // n_dev
    else:
        decode = kind == "decode"
        state = M.init_decode_state(cfg, B, S if decode else _seq(cfg, S),
                                    device="meta")
        sspec = state_shardings(state, mesh, B)
        mem["state_bytes"] = _tree_local_bytes(state, sspec, mesh)
        specs = batch_specs(cfg, B, 1 if decode else S)
        keep = ("tokens",) if decode else ("tokens", "patches")
        bspec = batch_shardings(specs, mesh)
        mem["batch_bytes"] = sum(
            math.prod(local_shape(shape, bspec[k], mesh)) * dt.itemsize
            for k, (shape, dt) in specs.items() if k in keep)
        # decode steps text alone: its patches sit in the cache already
        wcfg = dataclasses.replace(cfg, vlm_patches=0) if decode else cfg
        mem["working_set_bytes"] = working_set(
            wcfg, params, B, 1 if decode else _seq(cfg, S)) // n_dev
    mem["peak_live_bytes"] = int(sum(mem.values()))
    mem["fits_80g"] = bool(mem["peak_live_bytes"] <= RL.HBM_PER_DEVICE)
    return mem


def count_step(cfg, kind: str, B: int, S: int, microbatches: int = 1) -> dict:
    """Global FLOPs, bytes and aten ops of one step of ``kind`` at (B, S)
    on the meta device, the LM ops' charges included (the caller opens the
    mesh's activation rules)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..optim import AdamWConfig, apply_updates, init_state
    from ..train import loss_and_grads

    params = meta_params(cfg)
    if kind == "train":
        batch = meta_batch(cfg, B, S)
        opt = init_state(AdamWConfig(), params)
    elif kind == "prefill":
        batch = meta_batch(cfg, B, S, labels=False)
    else:
        state = M.init_decode_state(cfg, B, S, device="meta")
        K = cfg.n_codebooks
        tok = torch.empty((B, 1, K) if K > 1 else (B, 1), dtype=torch.int32,
                          device="meta")
        pos = torch.empty((B,), dtype=torch.int32, device="meta")
    fc = FlopCounterMode(display=False)
    bc = ByteCounter()
    with fc, bc, pin.meta_charges() as charges:
        if kind == "train":
            _, grads = loss_and_grads(params, cfg, batch, microbatches)
            apply_updates(AdamWConfig(), params, grads, opt)
        elif kind == "prefill":
            M.prefill(params, cfg, batch, last_only=True)
        else:
            M.decode_step(params, cfg, state, tok, pos)
    by_op: dict = {}
    for op, flops, nb in charges:
        row = by_op.setdefault(op, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nb
    return {"flops_counted": float(fc.get_total_flops()),
            "bytes_counted": float(bc.bytes), "aten_ops": bc.ops,
            "kernel_ops": by_op,
            "flops": float(fc.get_total_flops())
            + sum(r["flops"] for r in by_op.values()),
            "bytes": float(bc.bytes) + sum(r["bytes"] for r in by_op.values()),
            "params": params}


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------

def _axes_of(spec) -> set:
    out = set()
    for e in spec:
        if e is not None:
            out.update(e if isinstance(e, tuple) else (e,))
    return out


def collectives_for(cfg, shape: dict, mesh, fsdp: bool,
                    microbatches: int = 1) -> list:
    """The collectives one step of the cell implies, as records ``(kind,
    result_bytes, group_size, op)`` for `roofline.collective_stats`.

    * Train, FSDP: each parameter leaf whose spec uses "data": an
      all-gather of its data-gathered local size over the data group in
      the forward and another for the backward (its recompute under remat
      and its products), per microbatch, and a reduce-scatter of its
      float32 gradient; a leaf without "data": an all-reduce of its
      float32 gradient over "data"; with a "pod" axis, an all-reduce of
      every local gradient shard over "pod".
    * The residual stream (B/dp, S, d) in bf16, where "seq" maps to the TP
      axes and divides S: per layer an all-gather before the mixer and one
      before the FFN, a reduce-scatter after each; the backward mirrors
      them and the recompute repeats the forward's.  Where S does not
      divide (decode's S = 1): the TP all-reduce after each sublayer
      instead.
    * MoE: experts on a mesh axis, two all-to-alls of the (G, E, C, d)
      dispatch buffer in the forward (dispatch, combine) over that axis;
      few experts (expert-TP on d_ff), an all-gather of the buffer over
      TP before the experts and a reduce-scatter after; the backward
      mirrors, the recompute repeats.
    * Loss (train): the vocab-sharded loss's all-reduces of the
      (B/dp, S) float32 maximum, sum and gold logit, per pass over the
      chunks (forward and recompute).
    * Additions: the vocab-sharded embedding's reduce-scatter into the
      residual's layout (an all-reduce when S does not divide; its
      backward mirrors it); the LM head's all-gather of the final hidden
      state (its gradient's reduce-scatter in the backward); decode
      attention over a sequence-sharded cache (KV heads that do not divide
      TP): all-reduces of the softmax's float32 max and sum and of its
      float32 output.
    * Prefill and decode: TP only (``fsdp=False``), forward only.
    """
    B, S, kind = shape["batch"], shape["seq"], shape["kind"]
    train = kind == "train"
    dp = data_axes(mesh)
    n_tp = axis_size(mesh, tp_axes(mesh))
    n_data, n_pod = axis_size(mesh, "data"), axis_size(mesh, "pod")
    rules = activation_rules(mesh, B, n_kv=cfg.n_kv_heads)
    Bl = B // axis_size(mesh, dp) if rules["batch"] else B
    S_eff = 1 if kind == "decode" else _seq(cfg, S)
    d, act = cfg.d_model, 2
    recs: list = []

    def add(kind_, nbytes, group, op, times=1):
        if group > 1:
            recs.extend([(kind_, float(nbytes), int(group), op)] * times)

    if train:
        params = meta_params(cfg)
        specs = dict(tree_items(tree_shardings(params, mesh, cfg, fsdp)))
        for path, leaf in tree_items(params):
            spec = specs[path]
            n_loc = math.prod(local_shape(tuple(leaf.shape), spec, mesh))
            name = "/".join(str(k) for k in path)
            axes = _axes_of(spec)
            if "data" in axes:
                add("all-gather", n_loc * n_data * leaf.element_size(),
                    n_data, f"{name} gather", 2 * microbatches)
                add("reduce-scatter", n_loc * 4, n_data, f"{name} grad")
            else:
                add("all-reduce", n_loc * 4, n_data, f"{name} grad")
            add("all-reduce", n_loc * 4, n_pod, f"{name} grad pod")
    # forward passes over the activations: the forward, then under remat
    # the backward's recompute; the backward mirrors the forward once
    fwd = (2 if cfg.remat else 1) if train else 1
    bwd = 1 if train else 0
    full = Bl * S_eff * d * act
    seq_ok = rules["seq"] is not None and S_eff % n_tp == 0
    if seq_ok:
        per_layer = [("all-gather", full), ("reduce-scatter", full / n_tp)] * 2
        mirror = [("reduce-scatter", full / n_tp), ("all-gather", full)] * 2
    else:
        per_layer = [("all-reduce", full)] * 2
        mirror = per_layer
    for i in range(cfg.n_layers):
        for k, nb in per_layer:
            add(k, nb, n_tp, f"layer{i} residual", fwd)
        for k, nb in mirror:
            add(k, nb, n_tp, f"layer{i} residual grad", bwd)
    # MoE dispatch buffer
    n_moe = sum(1 for _, f in cfg.layer_plan if f == "moe")
    if n_moe:
        with activation_sharding(mesh, rules):
            G1, G2 = L._moe_groups(B // microbatches, S_eff)
        G = G1 * G2
        Tg = B * S_eff // (G * microbatches)
        C = L.moe_capacity(Tg, cfg.moe)
        E = cfg.moe.n_experts
        buf = G * E * C * d * act * microbatches / n_devices(mesh)
        ep_axis = "expert" if "expert" in mesh.mesh_dim_names else None
        ep = axis_size(mesh, ep_axis) if ep_axis else (
            n_tp if E % n_tp == 0 else 1)
        for i in range(n_moe):
            if ep > 1:
                add("all-to-all", buf, ep, f"moe{i} dispatch+combine",
                    2 * (fwd + bwd))
            else:
                add("all-gather", buf * n_tp, n_tp, f"moe{i} buffer",
                    fwd + bwd)
                add("reduce-scatter", buf, n_tp, f"moe{i} output", fwd + bwd)
    # embedding (vocab-sharded lookup) and, for training, the head
    V_ok = cfg.vocab_padded % n_tp == 0
    if V_ok:
        if seq_ok:
            add("reduce-scatter", full / n_tp, n_tp, "embed", 1)
            add("all-gather", full, n_tp, "embed grad", bwd)
        else:
            add("all-reduce", full, n_tp, "embed", 1 + bwd)
    if train and V_ok:
        S_txt = S
        stats = Bl * S_txt * 4 * max(cfg.n_codebooks, 1)
        add("all-reduce", stats, n_tp, "loss max/sum/gold", 3 * fwd)
        head = Bl * S_txt * d * act
        add("all-gather", head, n_tp, "head input", fwd)
        add("reduce-scatter", head / n_tp, n_tp, "head input grad", bwd)
    if kind == "decode" and cfg.n_kv_heads % n_tp != 0:
        n_attn = sum(1 for m, _ in cfg.layer_plan if m in ("attn", "local"))
        H = cfg.n_heads
        for i in range(n_attn):
            add("all-reduce", 2 * Bl * H * 4, n_tp, f"attn{i} softmax stats")
            add("all-reduce", Bl * H * cfg.head_dim * 4, n_tp,
                f"attn{i} output")
    return recs


# ----------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------

def count_cell(cfg, kind: str, B: int, S: int, mesh,
               microbatches: int = 1) -> dict:
    """The record's counted part for ``cfg`` at (B, S) on ``mesh``:
    ``roofline``, ``collectives``, ``memory``, ``counts``, ``count_s``,
    ``aten_ops``, ``model_flops``, ``n_params``, ``n_active_params``."""
    n_dev = n_devices(mesh)
    rules = activation_rules(mesh, B, n_kv=cfg.n_kv_heads)
    t0 = time.perf_counter()
    with activation_sharding(mesh, rules):
        counts = count_step(cfg, kind, B, S, microbatches)
        params = counts.pop("params")
        mem = memory_model(cfg, kind, B, S, mesh, rules, params,
                           microbatches)
    n_params = sum(t.numel() for _, t in tree_items(params))
    n_active = cfg.n_active_params()
    recs = collectives_for(cfg, dict(batch=B, seq=S, kind=kind), mesh,
                           fsdp=kind == "train", microbatches=microbatches)
    coll = RL.collective_stats(recs, n_dev)
    if kind == "train":
        model_flops = 6.0 * n_active * B * S
    elif kind == "prefill":
        model_flops = 2.0 * n_active * B * S
    else:
        model_flops = 2.0 * n_active * B
    cost = {"flops": counts["flops"] / n_dev,
            "bytes accessed": counts["bytes"] / n_dev}
    rl = RL.roofline_terms(cost, coll, n_dev, model_flops)
    roof = rl.to_json()
    roof["extrapolated"] = False
    return {"n_params": n_params, "n_active_params": n_active,
            "count_s": round(time.perf_counter() - t0, 3),
            "aten_ops": counts["aten_ops"], "memory": mem,
            "collectives": coll.to_json(), "roofline": roof,
            "counts": counts, "model_flops": model_flops}


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               perf_variant: str = "base", cfg=None) -> dict:
    """Count one cell; returns the JSON record."""
    if cfg is None:
        cfg = configs.get(arch_id)
    shape = configs.SHAPES[shape_name]
    B, S, kind = shape["batch"], shape["seq"], shape["kind"]
    expert_axis = 0
    if perf_variant.startswith("moe3d"):
        expert_axis = int(perf_variant[5:] or "8")
    mesh = make_production_mesh(multi_pod=multi_pod, expert_axis=expert_axis)
    rec = dict(arch=arch_id, shape=shape_name,
               mesh="multi" if multi_pod else "single",
               n_devices=n_devices(mesh), batch=B, seq=S, kind=kind,
               variant=perf_variant)
    rec.update(count_cell(cfg, kind, B, S, mesh))
    return rec


def roofline_cell(arch_id: str, shape_name: str, multi_pod: bool,
                  perf_variant: str = "base", cfg=None) -> dict:
    """The full cell record: `lower_cell`'s.  The reference extrapolates
    its scanned body from unroll 1 and 2; the meta run walks every layer,
    so its counts are whole already."""
    return lower_cell(arch_id, shape_name, multi_pod, perf_variant, cfg=cfg)


def run_cells(cells, meshes, out_dir: str, variant: str = "base",
              quiet: bool = False) -> list[dict]:
    os.makedirs(out_dir, exist_ok=True)
    records = []
    say = (lambda *a: None) if quiet else print
    for arch, shape in cells:
        for mesh_name in meshes:
            tag = f"{arch}_{shape}_{mesh_name}" + (
                "" if variant == "base" else f"_{variant}")
            path = os.path.join(out_dir, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
                say(f"[cached] {tag}: "
                    f"{rec.get('roofline', {}).get('dominant', rec.get('error', '?'))}")
                records.append(rec)
                continue
            try:
                rec = roofline_cell(arch, shape, mesh_name == "multi", variant)
                rl = rec["roofline"]
                say(f"[ok] {tag}: count={rec['count_s']}s "
                    f"dom={rl['dominant']} "
                    f"terms=({rl['compute_s']:.4f},{rl['memory_s']:.4f},"
                    f"{rl['collective_s']:.4f})s "
                    f"mem={rec['memory']['peak_live_bytes'] / 2**30:.2f}GiB "
                    f"fits={rec['memory']['fits_80g']}")
            except Exception as e:  # record and continue: these are bugs
                rec = dict(arch=arch, shape=shape, mesh=mesh_name,
                           variant=variant, error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
                say(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for a, s in configs.cells():
            print(a, s)
        return
    if args.all:
        cells = configs.cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    records = run_cells(cells, meshes, args.out, args.variant)
    n_fail = sum(1 for r in records if "error" in r)
    print(f"\n{len(records) - n_fail}/{len(records)} cells counted")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
