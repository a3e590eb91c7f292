"""Logical activation sharding annotations: a port of
``repro.models.sharding``.

Model code calls ``logical(x, "batch", "seq", None, ...)`` with one
logical name (or None) per tensor dim.  Outside a mesh context this is the
identity.  `activation_sharding` installs a mesh and a mapping from
logical names to mesh axes (``launch.sharding.activation_rules``); inside
it, `logical_spec` gives the spec the reference hands to
``with_sharding_constraint``, and `logical` redistributes a DTensor to that
spec's placements.  PyTorch has no compiler to hand a constraint to, so a
plain tensor passes through unchanged; the rules also steer the MoE's
dispatch groups (``layers._moe_groups``) and the dry run's collectives.

On DTensors the model runs its ops through DTensor's sharding
propagation, with two helpers for what that cannot carry: `replicated_like`
makes a tensor built inside the model (positions, masks, constants) a
replicated DTensor on the mesh of the DTensor it meets, and `local_region`
runs a hand-written kernel's op on the local shards in the layout the
kernel needs (``local_map``), so the kernel never sees a DTensor and never
a gathered whole tensor.  A plain tensor passes both unchanged.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
from typing import Optional

_state = threading.local()


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """rules: logical axis name -> mesh axis (str | tuple | None)."""
    prev_rules = getattr(_state, "rules", None)
    prev_mesh = getattr(_state, "mesh", None)
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev_rules, prev_mesh


def under_current_rules(fn):
    """``fn`` made to run under the mesh and rules active now on whatever
    thread calls it; ``fn`` itself when none are.  The rules are
    per-thread, and autograd recomputes a checkpointed function in the
    backward on its own device thread (a CUDA tensor's), where they are
    not set."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with activation_sharding(mesh, rules):
            return fn(*args, **kwargs)
    return run


def axis_prod(mesh, ax) -> int:
    """The device count of a mesh axis, a tuple of axes, or None (1)."""
    if ax is None:
        return 1
    axes = ax if isinstance(ax, (tuple, list)) else (ax,)
    names = tuple(mesh.mesh_dim_names)
    s = 1
    for a in axes:
        s *= mesh.shape[names.index(a)] if a in names else 1
    return s


def logical_spec(shape, names, rules: dict, mesh) -> tuple:
    """The spec (one entry per dim) for a tensor of ``shape`` named
    ``names`` (a prefix is allowed; the rest is unsharded): each name's
    axis, dropped where its size does not divide the dim (replicate rather
    than pad), and a mesh axis taken by an earlier dim dropped (the first
    dim wins a contested axis)."""
    names = tuple(names) + (None,) * (len(shape) - len(names))
    axes = []
    used: set = set()
    for dim, n in zip(shape, names):
        ax = rules.get(n) if n else None
        if ax is not None and dim % axis_prod(mesh, ax) != 0:
            ax = None
        if ax is not None:
            flat = ax if isinstance(ax, tuple) else (ax,)
            if any(a in used for a in flat):
                ax = None
            else:
                used.update(flat)
        axes.append(ax)
    from ..launch.sharding import P
    return P(*axes)


def is_dtensor(x) -> bool:
    # a DTensor exists only once torch.distributed.tensor is imported
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def logical(x, *names: Optional[str]):
    """A DTensor ``x`` redistributed to the layout of its dim names under
    the active rules (with no names: replicated, its partial sums
    reduced); a plain tensor, or any tensor outside the rules, as it is."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    from ..launch.sharding import placements

    spec = logical_spec(x.shape, names, rules, mesh)
    want = placements(spec, x.device_mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def replicated_like(t, like):
    """``t``, a plain tensor built inside the model, as a DTensor replicated
    over the mesh of ``like`` when ``like`` is a DTensor; else ``t`` as it
    is.  (Every rank builds the same ``t``: it derives from shapes and
    constants alone.)"""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def layout(x, *names: Optional[str]) -> tuple:
    """The placements of the DTensor ``x`` under the active rules with its
    dims named ``names`` (as `logical` would give it)."""
    rules = current_rules()
    if rules is None:
        raise RuntimeError("a DTensor reached a kernel region outside "
                           "activation_sharding: no rules give its layout")
    from ..launch.sharding import placements

    mesh = x.device_mesh
    return tuple(placements(logical_spec(x.shape, names, rules, mesh), mesh))


def names_layout(mesh, *names: Optional[str]) -> tuple:
    """The placements on ``mesh`` of a tensor whose dims are named
    ``names`` under the active rules, each name's axes taken whole (no
    shape to check them against, as a ``shard_map``'s ``out_specs``: the
    caller names dims that the axes divide); an axis an earlier dim took
    is dropped."""
    rules = current_rules()
    if rules is None:
        raise RuntimeError("a DTensor reached a kernel region outside "
                           "activation_sharding: no rules give its layout")
    from ..launch.sharding import P, placements

    axes, used = [], set()
    for n in names:
        ax = rules.get(n) if n else None
        flat = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        flat = tuple(a for a in flat if a not in used)
        used.update(flat)
        axes.append(flat or None)
    return tuple(placements(P(*axes), mesh))


def local_region(fn, args: tuple, names: tuple, outs: tuple):
    """``fn(*args)``: on plain tensors as it is; on DTensors on their local
    shards, each arg first redistributed to the layout of its dim names in
    ``names`` (`layout`), and each output coming back as a DTensor laid
    out as ``outs`` says: an int, as the arg it indexes; a tuple of dim
    names, by `names_layout`.  An input replicated over a mesh dim that
    an output is sharded on gets its gradient there as a partial sum (each
    shard computed its own part of it).  ``fn`` sees plain local tensors,
    so the kernel behind it launches on them."""
    dts = [is_dtensor(a) for a in args]
    if not any(dts):
        return fn(*args)
    if not all(dts):
        raise TypeError("a kernel region takes DTensors alone: make a "
                        "tensor built inside the model one with "
                        "replicated_like")
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    in_layouts = tuple(layout(a, *n) for a, n in zip(args, names))
    out_layouts = tuple(in_layouts[o] if isinstance(o, int)
                        else names_layout(mesh, *o) for o in outs)
    split = [any(not lay[i].is_replicate() for lay in out_layouts)
             for i in range(mesh.ndim)]
    grads = tuple(tuple(Partial() if split[i] and lay[i].is_replicate()
                        else lay[i] for i in range(mesh.ndim))
                  for lay in in_layouts)
    return local_map(fn, out_placements=out_layouts,
                     in_placements=in_layouts,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def axis_coord(mesh, ax) -> int:
    """This rank's coordinate along the mesh axis ``ax`` (a name or a tuple
    of names, major to minor)."""
    axes = ax if isinstance(ax, (tuple, list)) else (ax,)
    c = 0
    for a in axes:
        c = c * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return c
