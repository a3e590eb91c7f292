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
"""

from __future__ import annotations

import contextlib
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


def logical(x, *names: Optional[str]):
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    # a DTensor exists only once torch.distributed.tensor is imported
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is None or not isinstance(x, dt.DTensor):
        return x
    from ..launch.sharding import placements

    spec = logical_spec(x.shape, names, rules, mesh)
    want = placements(spec, x.device_mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)
