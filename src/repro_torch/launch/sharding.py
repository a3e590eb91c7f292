"""Sharding rules: parameter, optimizer, state and batch specs per mesh (a
port of ``repro.launch.sharding``).

Strategy (the reference's baseline):
  * batch over (pod, data); "pod" is pure DP across pods.
  * tensor parallelism over "model": attention heads, MLP hidden, experts
    (expert-parallel when n_experts divides the axis, expert-TP on d_ff
    otherwise), vocab for embedding/logits.
  * FSDP over "data": the non-"model" dim of every big matrix is sharded
    over the data axis; optimizer state mirrors params leaf for leaf, so
    ZeRO-style optimizer sharding falls out for free.
  * every rule is guarded by divisibility: an axis that does not divide a
    dim is dropped (e.g. kv_heads=4 < model=16 -> KV replicated; the KV
    *cache* falls back to sequence sharding instead).

A spec is a `P`: one entry per tensor dim, each None, a mesh axis name or
a tuple of axis names.  `spec_for_path` is pure (path, shape) -> `P`, so
the same rules apply to params, grads, AdamW's m/v/master and anything
tree-shaped.  A path is a tuple of the port's tree keys: dict keys, and
list indices for ``params["layers"][i]``; the last named key picks the
rule, and "moe" among the keys marks an MoE leaf.  The port holds one dict
per layer where the reference stacks its body with a leading (G, ...) dim:
given the stack (``stack=(G,)``, as `tree_shardings` does with the
model's config), a leaf's spec is the reference's spec of the stacked leaf
with the stack's entries dropped.  On top of the specs, `placements` maps
a spec to DTensor placements on a `DeviceMesh`; the boundary of a sharded
program distributes its inputs by them, as the reference's ``jax.jit``
takes ``in_shardings``: `distribute_tree` the parameters and the AdamW
state (its ``m``/``v``/``master`` take the parameters' specs),
`distribute_batch` a batch and `distribute_state` a decode state.  A
leaf already a DTensor is redistributed to its spec; a meta leaf becomes a
DTensor of a meta local shard (the dry run's program on a fake mesh).
"""

from __future__ import annotations

from typing import Any

from .mesh import MESH_AXES, axis_names, axis_size, data_axes

FSDP = "data"
TP = "model"


class P(tuple):
    """A partition spec: ``P("data", None, ("expert", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def tp_axes(mesh):
    """The tensor-parallel axes: ('expert', 'model') on expert-factorized
    meshes (a beyond-baseline variant for few-expert MoE), else 'model'."""
    return ("expert", TP) if "expert" in axis_names(mesh) else TP


def _resolve(rule: tuple, mesh) -> tuple:
    """Replace the TP sentinel with the mesh's actual TP axes."""
    tpa = tp_axes(mesh)
    if tpa == TP:
        return rule
    out = []
    for r in rule:
        if r == TP:
            out.append(tpa)
        elif isinstance(r, tuple):
            out.append(tuple(tpa if a == TP else a for a in r))
        else:
            out.append(r)
    return tuple(out)


def _guard(spec: tuple, shape: tuple[int, ...], mesh) -> P:
    """Drop axes that don't divide; never reuse a mesh axis twice."""
    names = axis_names(mesh)
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in names and a not in used)
        size = axis_size(mesh, axes)
        if size <= 1 or dim % size != 0:
            # try a shrinking prefix (e.g. ('data','model') -> ('data',))
            while axes and (axis_size(mesh, axes) <= 1
                            or dim % axis_size(mesh, axes) != 0):
                axes = axes[:-1]
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


# rules keyed by the *last named component* of the tree path; each is a
# spec tuple for the leaf's trailing dims (leading dims padded with None)
_PARAM_RULES: dict[str, tuple] = {
    "embed":      (TP, FSDP),             # (V, d); musicgen (K, V, d) padded
    "lm_head":    (FSDP, TP),             # (d, V); musicgen (K, d, V)
    "patch_proj": (FSDP, TP),
    "wq":         (FSDP, TP, None),       # (d, H, hd)
    "wk":         (FSDP, TP, None),       # (d, KV, hd): guard drops TP if KV<axis
    "wv":         (FSDP, TP, None),
    "wo":         (TP, None, FSDP),       # (H, hd, d)
    "bq":         (TP, None),
    "bk":         (TP, None),
    "bv":         (TP, None),
    "wg":         (FSDP, TP),             # mlp (d, f); moe (E, d, f) below
    "wu":         (FSDP, TP),
    "wd":         (TP, FSDP),             # mlp (f, d)
    "w1":         (FSDP, TP),
    "w2":         (TP, FSDP),
    "b1":         (TP,),
    "b2":         (None,),
    "router":     (FSDP, None),           # (d, E)
    # rwkv
    "wr":         (FSDP, TP),
    "cm_k":       (FSDP, TP),
    "cm_v":       (TP, FSDP),
    "cm_r":       (FSDP, TP),
    "tm_a":       (FSDP, None),
    "tm_b":       (None, None, FSDP),
    "wd_a":       (FSDP, None),
    "wd_b":       (None, FSDP),
    # rglru
    "w_in_x":     (FSDP, TP),
    "w_in_g":     (FSDP, TP),
    "w_out":      (TP, FSDP),
    "conv_w":     (None, TP),
    "conv_b":     (TP,),
    "wa":         (TP, None),
    "wx":         (TP, None),
    "ba":         (None,),
    "bx":         (None,),
    "lam":        (TP,),
}

_MOE_3D = {"wg": (TP, FSDP, None), "wu": (TP, FSDP, None),
           "wd": (TP, None, FSDP)}
_MOE_3D_FEW = {"wg": (None, FSDP, TP), "wu": (None, FSDP, TP),
               "wd": (None, TP, FSDP)}


def _names(path: tuple) -> list[str]:
    return [k for k in path if isinstance(k, str)]


def spec_for_path(path: tuple, shape: tuple[int, ...], mesh,
                  fsdp: bool = True, stack: tuple[int, ...] = ()) -> P:
    """The spec of the leaf at ``path`` of ``shape``.  ``stack``: the
    leading dims the reference stacks this leaf under ((n_body,) for a
    body layer's leaf); the rules then see the stacked shape, as the
    reference's do, and the stack's entries are dropped from the result.
    (So a stacked MoE body's shared experts, three dims deep there, take
    the MoE rule with the stack's depth read as the expert count.)"""
    shape = tuple(stack) + tuple(shape)
    names = _names(path)
    leaf = names[-1]
    rule = _PARAM_RULES.get(leaf)
    moe_leaf = leaf in ("wg", "wu", "wd") and len(shape) >= 3 and "moe" in names
    if moe_leaf:
        E = shape[-3]
        if "expert" in axis_names(mesh):
            # expert-factorized mesh: experts on their own axis, f on model
            rule = {"wg": ("expert", FSDP, TP), "wu": ("expert", FSDP, TP),
                    "wd": ("expert", TP, FSDP)}[leaf]
        else:
            rule = (_MOE_3D[leaf] if E % axis_size(mesh, TP) == 0
                    else _MOE_3D_FEW[leaf])
    if rule is not None and not moe_leaf:
        rule = _resolve(rule, mesh)
    if rule is None:
        return P()  # norms, scalars, step counters: replicated
    if not fsdp:
        # inference: TP only, replicated over the data axes (weights stay
        # resident, no per-layer gathers on the latency path)
        rule = tuple(None if r == FSDP else r for r in rule)
    pad = len(shape) - len(rule)
    spec = _guard((None,) * pad + tuple(rule), shape, mesh)
    return P(*spec[len(stack):])


def tree_items(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists (a `P` is a leaf),
    dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _stack_of(cfg, depth: int | None = None):
    """path -> the leading dims the reference stacks that leaf under: its
    body layers (n_body,), or (``depth``,), everything else none."""
    n_head = len(cfg.groups[0])
    body = range(n_head, n_head + cfg.n_body * len(cfg.block_pattern))
    depth = cfg.n_body if depth is None else depth

    def stack(path):
        if len(path) > 1 and path[0] == "layers" and path[1] in body:
            return (depth,)
        return ()
    return stack


def tree_shardings(tree: Any, mesh, cfg, fsdp: bool = True,
                   depth: int | None = None) -> Any:
    """A tree of specs matching ``tree`` (params, grads, or the AdamW
    state, whose ``m``/``v``/``master`` mirror the params) of the model
    ``cfg`` (for the reference's stacking of its body; ``depth``: the
    body's stacked depth if not ``cfg``'s own, the whole model's for one
    cut to fewer body periods)."""
    stack = _stack_of(cfg, depth)

    def f(path, leaf):
        # opt state: m/v/master/step prefix the params' own paths
        inner = path[1:] if path and path[0] in ("m", "v", "master") else path
        return spec_for_path(path, tuple(leaf.shape), mesh, fsdp,
                             stack(inner))
    return _map_with_path(f, tree)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on the `DeviceMesh` ``mesh``: for each
    mesh dim, ``Shard(tensor dim)`` if the spec names that axis, else
    ``Replicate()``.  A tuple of axes on one tensor dim shards it on each of
    them, major to minor in mesh order.  A mesh dim of size 1 is
    ``Replicate()``: sharding over one device is replication.  One of the
    axes that `launch.mesh` builds (`MESH_AXES`) that this mesh lacks is
    read as one of size 1 (`axis_size`) and shards nothing; any other
    axis name raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        bad = [a for a in axes if a not in names and a not in MESH_AXES]
        if bad:
            raise ValueError(f"axes {bad} of {spec} are neither in the mesh "
                             f"{names} nor among {MESH_AXES}")
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of {spec} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return out


def _place(x, mesh, spec):
    """``x`` as a DTensor on ``mesh`` with the placements of ``spec``: a
    plain tensor distributed, a DTensor redistributed.  A meta tensor (the
    dry run's) becomes a DTensor whose local shard is a meta tensor of
    `local_shape`: nothing moves to the mesh's device and no collective
    runs."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    want = placements(spec, mesh)
    if not isinstance(x, DTensor) and x.device.type == "meta":
        shard = torch.empty(local_shape(tuple(x.shape), spec, mesh),
                            dtype=x.dtype, device="meta")
        return DTensor.from_local(shard, mesh, want, run_check=False,
                                  shape=x.shape, stride=x.stride())
    if not isinstance(x, DTensor):
        return distribute_tensor(x, mesh, want)
    return x if tuple(x.placements) == tuple(want) else x.redistribute(
        mesh, want)


def _distribute_by(tree: Any, specs: Any, mesh) -> Any:
    flat = dict(tree_items(specs))
    return _map_with_path(lambda path, leaf: _place(leaf, mesh, flat[path]),
                          tree)


def distribute_tree(tree: Any, mesh, cfg, fsdp: bool = True,
                    depth: int | None = None) -> Any:
    """``tree`` (of the model ``cfg``: its parameters, or its AdamW state)
    with every leaf a DTensor on ``mesh`` with the placements of its spec
    (`tree_shardings`)."""
    return _distribute_by(tree, tree_shardings(tree, mesh, cfg, fsdp, depth),
                          mesh)


def local_shape(shape: tuple[int, ...], spec, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` leaf under ``spec``."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        out.append(dim if entry is None else dim // axis_size(mesh, entry))
    return tuple(out)


# ----------------------------------------------------------------------
# batch / decode-state shardings
# ----------------------------------------------------------------------

def _shape(v) -> tuple:
    """A batch spec's shape: ``data.batch_specs`` gives (shape, dtype)."""
    return tuple(v[0]) if isinstance(v, tuple) else tuple(v.shape)


def batch_shardings(specs: dict, mesh) -> dict:
    dp = data_axes(mesh)
    out = {}
    for k, v in specs.items():
        shape = _shape(v)
        spec = (dp,) + (None,) * (len(shape) - 1)
        out[k] = _guard(spec, shape, mesh)
    return out


def distribute_batch(batch: dict, mesh) -> dict:
    """A batch of tensors as DTensors on ``mesh`` by `batch_shardings`."""
    specs = batch_shardings(batch, mesh)
    return {k: _place(v, mesh, specs[k]) for k, v in batch.items()}


def decode_state_spec(path: tuple, shape: tuple[int, ...], mesh,
                      batch: int) -> P:
    """KV caches (.., B, S, KV, hd) and recurrent states.

    Heads are TP-sharded when they divide the axis; otherwise the cache is
    sharded along the *sequence* (flash-decoding style).  Batch over dp
    when divisible.
    """
    names = _names(path)
    dp = data_axes(mesh)
    leaf = names[-1]
    if leaf in ("k", "v") and len(shape) >= 4:
        B, S, KV, hd = shape[-4:]
        kv_tp = KV % axis_size(mesh, TP) == 0
        spec4 = (dp, None if kv_tp else TP, TP if kv_tp else None, None)
        spec = (None,) * (len(shape) - 4) + spec4
        return _guard(spec, shape, mesh)
    if leaf == "s" and len(shape) >= 4:        # rwkv state (.., B, H, N, N)
        spec = (None,) * (len(shape) - 4) + (dp, TP, None, None)
        return _guard(spec, shape, mesh)
    if leaf == "h" and len(shape) >= 2:        # rglru (.., B, dr)
        spec = (None,) * (len(shape) - 2) + (dp, TP)
        return _guard(spec, shape, mesh)
    if leaf == "conv" and len(shape) >= 3:     # (.., B, W-1, dr)
        spec = (None,) * (len(shape) - 3) + (dp, None, TP)
        return _guard(spec, shape, mesh)
    if leaf in ("x_tm", "rwkv_cm") and len(shape) >= 2:  # (.., B, d)
        spec = (None,) * (len(shape) - 2) + (dp, TP)
        return _guard(spec, shape, mesh)
    return P()                                 # fallback: shard nothing


def state_shardings(state_tree: Any, mesh, batch: int) -> Any:
    return _map_with_path(
        lambda path, leaf: decode_state_spec(path, tuple(leaf.shape), mesh,
                                             batch), state_tree)


def distribute_state(state: Any, mesh, batch: int) -> Any:
    """A decode state (``init_decode_state``, or a prefill's state, padded
    or not) as DTensors on ``mesh`` by `state_shardings`."""
    return _distribute_by(state, state_shardings(state, mesh, batch), mesh)


def activation_rules(mesh, batch: int, n_kv: int | None = None,
                     seq_shard: bool = True, embed_shard: bool = False) -> dict:
    """Logical-name -> mesh-axis mapping for `models.sharding.logical`.

    seq_shard=True gives Megatron-style sequence parallelism between
    blocks: the residual stream (and hence the checkpointed layer inputs,
    the biggest training-memory term) is sharded over the model axis, with
    an all-gather before each mixer and FFN and a reduce-scatter after
    (the dry run counts what the program issues, `dryrun.count_program`).
    """
    dp = data_axes(mesh)
    tpa = tp_axes(mesh)
    kv_tp = n_kv is not None and n_kv % axis_size(mesh, tpa) == 0
    dp_ok = batch % axis_size(mesh, dp) == 0
    return {
        "batch": dp if dp_ok else None,
        # recurrent archs shard the residual stream on the feature dim
        # (channels are independent); attention archs shard the sequence
        # (Megatron-SP).  Never both: logical() dedups per tensor.
        "seq": tpa if (seq_shard and not embed_shard) else None,
        "embed": tpa if embed_shard else None,
        "vocab": tpa,
        "heads": tpa,
        "kv_seq": None if kv_tp else tpa,
        "expert": "expert" if "expert" in axis_names(mesh) else TP,
        "capacity": tpa,
        "ffn": TP,
        # MoE dispatch groups cover the whole (data x model) grid; the
        # buffer between dispatch and the expert einsum keeps only the
        # data-axis part on its group dim (the TP part moves to experts)
        "moe_group": ((dp if dp_ok else ())
                      + (tpa if isinstance(tpa, tuple) else (tpa,))),
        "moe_batch": dp if dp_ok else None,
    }
