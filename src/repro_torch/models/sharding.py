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
a gathered whole tensor.  A plain tensor passes both unchanged.  The
products of a split activation with its weights (`project`,
`project_out`, `local_einsum`), the embedding lookup (`lookup`) and the
loss's cross entropy over a split vocab (`vocab_parallel`) run the same
way, on every torch and mesh, where DTensor's own op may not: a
head count that does not divide the TP axes, a mesh of three split dims,
a torch before 2.13.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
from typing import Optional

import torch

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


def unflatten_last(x, *sizes):
    """``x`` with its last dim split into ``sizes`` (a reshape); on a
    DTensor whose last dim a mesh dim splits into parts ``sizes[0]`` does
    not divide (4 heads over 16), that dim gathered first, as DTensor
    cannot split a sharded dim unevenly."""
    shape = (*x.shape[:-1], *sizes)
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate

    mesh, last = x.device_mesh, x.ndim - 1
    want = [Replicate() if (p.is_shard(last) and sizes[0] % mesh.size(i))
            else p for i, p in enumerate(x.placements)]
    if want != list(x.placements):
        x = x.redistribute(mesh, want)
    return x.reshape(shape)


def as_partial(x):
    """A DTensor ``x`` as a partial sum over every mesh dim (a replicated
    value divided among the ranks, a local step), so that sums of such
    values need no collective until one reduces the total; a plain
    tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Partial

    mesh, local, n = x.device_mesh, x.to_local(), 1
    for i, p in enumerate(x.placements):
        if p.is_replicate():
            n *= mesh.size(i)
        elif not p.is_partial():
            raise ValueError(f"{x.placements}: a sharded tensor is not a "
                             "partial sum")
    return DTensor.from_local(local / n if n > 1 else local, mesh,
                              [Partial()] * mesh.ndim, run_check=False)


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
    mesh = args[0].device_mesh
    in_layouts = tuple(layout(a, *n) for a, n in zip(args, names))
    out_layouts = tuple(in_layouts[o] if isinstance(o, int)
                        else names_layout(mesh, *o) for o in outs)
    return _local_call(fn, args, in_layouts, out_layouts, mesh)


def _eq_letters(eq: str) -> tuple[str, str, str]:
    """(x's letters, w's letters, the product's) of "xs,ws->out"."""
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    return a, b, out


def project(x, *terms):
    """The products of the activation ``x`` with weights, one per term
    ``(eq, w, fn)``: ``fn(x, w)`` computes it and ``eq``, an einsum
    equation with ``x``'s letters first, fixes the layouts and nothing
    else.  Returns a product, or a tuple of them in ``terms``'s order.  On
    plain tensors each ``fn`` as it is.  On DTensors on local shards
    (``local_map``), the weights that shard the same mesh dims in one
    region: each weight gathered over the FSDP axis and on its contracted
    dims, and kept sharded on its other dims as its rule shards it; ``x``
    gathered on its contracted dim and on each mesh dim the region's
    weights shard (column parallel: the residual's sequence shards
    gathered once before head- or ffn-sharded products; where no weight is
    split, ``x`` keeps them and the products come out sharded on the
    sequence); each product laid out by its equation.  DTensor never sees
    a product, so none of its strategies splits a merged dim it cannot
    unflatten (heads that do not divide the TP axes), flattens a dim split
    over one mesh dim with one split over another (which torch before
    2.13 refuses), or is searched for over the mesh's dims (minutes an op
    over three): one program on every torch."""
    plain = tuple(fn(x, w) for _eq, w, fn in terms) if not is_dtensor(x) \
        else None
    if plain is not None:
        return plain[0] if len(plain) == 1 else plain
    from torch.distributed.tensor import Replicate, Shard

    from ..launch.sharding import FSDP

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    w_lays = []
    for eq, w, _fn in terms:
        _xa, wa, out = _eq_letters(eq)
        w_lays.append(tuple(
            p if (isinstance(p, Shard) and names[i] != FSDP
                  and wa[p.dim] in out) else Replicate()
            for i, p in enumerate(w.placements)))
    groups: dict = {}
    for j, lay in enumerate(w_lays):
        groups.setdefault(tuple(not p.is_replicate() for p in lay),
                          []).append(j)
    outs: list = [None] * len(terms)
    for taken, idx in groups.items():
        eqs = [_eq_letters(terms[j][0]) for j in idx]
        x_lay = tuple(
            p if (isinstance(p, Shard) and not taken[i]
                  and all(xa[p.dim] in out for xa, _wa, out in eqs))
            else Replicate() for i, p in enumerate(x.placements))
        out_lays = []
        for j, (xa, wa, out) in zip(idx, eqs):
            lay = []
            for i in range(mesh.ndim):
                p, src = (x_lay[i], xa) if not x_lay[i].is_replicate() \
                    else (w_lays[j][i], wa)
                lay.append(Shard(out.index(src[p.dim]))
                           if isinstance(p, Shard) else Replicate())
            out_lays.append(tuple(lay))
        fns = [terms[j][2] for j in idx]

        def body(xl, *wl, fns=fns):
            return tuple(f(xl, w) for f, w in zip(fns, wl))
        got = _local_call(body, (x,) + tuple(terms[j][1] for j in idx),
                          (x_lay,) + tuple(w_lays[j] for j in idx),
                          tuple(out_lays), mesh)
        for j, o in zip(idx, got):
            outs[j] = o
    return outs[0] if len(outs) == 1 else tuple(outs)


def project_out(x, eq: str, w, fn):
    """``fn(x, w)``, the product of ``x`` with the weight ``w`` by the
    einsum equation ``eq`` (``x``'s letters first; it fixes the layouts and
    nothing else) that contracts ``x``'s split dims: the row-parallel
    product after a column-parallel one (attention's output projection,
    an MLP's down projection).  On plain tensors ``fn`` as it is.  On
    DTensors on local shards (``local_map``): ``x`` as it is laid out,
    ``w`` sliced to ``x``'s shards of the dims they contract and whole
    elsewhere (gathered over the FSDP axis); the product is a partial sum
    over each mesh dim that splits a contracted dim, which the caller's
    layout reduces (a reduce-scatter into the residual's sequence shards),
    and sharded where ``x``'s kept dims are; a partial sum in ``x`` stays
    one in the product."""
    if not is_dtensor(x):
        return fn(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    xa, wa, out = _eq_letters(eq)
    mesh = x.device_mesh
    w_lay, out_lay = [], []
    for p in x.placements:
        if isinstance(p, Shard) and xa[p.dim] not in out:
            w_lay.append(Shard(wa.index(xa[p.dim])))
            out_lay.append(Partial())
        elif p.is_partial():
            # a partial sum in is a partial sum out (the product is linear)
            w_lay.append(Replicate())
            out_lay.append(p)
        else:
            w_lay.append(Replicate())
            out_lay.append(Shard(out.index(xa[p.dim]))
                           if isinstance(p, Shard) else Replicate())
    return _local_call(lambda xl, wl: (fn(xl, wl),), (x, w),
                       (tuple(x.placements), tuple(w_lay)),
                       (tuple(out_lay),), mesh)[0]


def local_einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; on DTensors on local shards, laid out by
    a rule of its own rather than DTensor's search over the mesh's dims:
    on each mesh dim, a letter both inputs shard stays sharded (a partial
    sum where ``eq`` contracts it); a letter one input shards, the other
    is sliced to match where it has that letter; where the inputs shard
    different letters, the smaller input is gathered.  A partial sum in an
    input is reduced first."""
    if not is_dtensor(a):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard

    la, lb, out = _eq_letters(eq)

    def letter(p, ls):
        return ls[p.dim] if isinstance(p, Shard) else None
    a_lay, b_lay, o_lay = [], [], []
    for pa, pb in zip(a.placements, b.placements):
        xa, xb = letter(pa, la), letter(pb, lb)
        if xa and xb and xa != xb:
            if a.numel() >= b.numel():
                xb = None
            else:
                xa = None
        c = xa or xb
        if c is None:
            a_lay.append(Replicate())
            b_lay.append(Replicate())
            o_lay.append(Replicate())
            continue
        a_lay.append(Shard(la.index(c)) if c in la else Replicate())
        b_lay.append(Shard(lb.index(c)) if c in lb else Replicate())
        o_lay.append(Shard(out.index(c)) if c in out else Partial())
    return _local_call(lambda x, y: (torch.einsum(eq, x, y),), (a, b),
                       (tuple(a_lay), tuple(b_lay)), (tuple(o_lay),),
                       a.device_mesh)[0]


def lookup(table, ids):
    """``table[ids]``, rows of an embedding table; on a DTensor table the
    vocab-parallel lookup on local shards (DTensor's own lookup fails its
    backward before torch 2.13): the table gathered over every
    mesh dim but those that split its rows, each rank reading the ids that
    fall in its rows (zeros elsewhere), the result a partial sum over the
    mesh dims that split the rows and split as ``ids`` are elsewhere."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    t_lay = tuple(p if p.is_shard(0) else Replicate()
                  for p in table.placements)
    out_lay, lo, n = [], 0, 1
    for i, (pt, pi) in enumerate(zip(t_lay, ids.placements)):
        if pt.is_shard(0):
            out_lay.append(Partial())
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
        else:
            out_lay.append(Shard(pi.dim) if isinstance(pi, Shard)
                           else Replicate())
    lo *= table.shape[0] // n

    def body(tl, il):
        local = il.long() - lo
        hit = (local >= 0) & (local < tl.shape[0])
        rows = tl[local.clamp(0, tl.shape[0] - 1)]
        return (rows * hit[..., None].to(rows.dtype),)
    return _local_call(body, (table, ids), (t_lay, tuple(ids.placements)),
                       (tuple(out_lay),), mesh)[0]


def vocab_parallel(fn, logits, labels):
    """``fn(logits, labels, lo, groups)``, a per-token function of logits
    (..., V) whose last dim is the vocab and of labels (...), on local
    shards: the logits as they are laid out (sharded or replicated), the
    labels split as the logits' leading dims are and whole elsewhere;
    ``lo`` the first vocab slot of this rank's shard and ``groups`` the
    (mesh, dim) of each mesh dim above one device that splits the vocab,
    for ``fn`` to combine over.  The result is laid out as the labels.
    On plain tensors ``fn(logits, labels, 0, ())``."""
    if not is_dtensor(logits):
        return fn(logits, labels, 0, ())
    from torch.distributed.tensor import Replicate, Shard

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    lg_lay = tuple(logits.placements)
    lab_lay = tuple(p if isinstance(p, Shard) and p.dim < vdim
                    else Replicate() for p in lg_lay)
    lo, n, groups = 0, 1, []
    for i, p in enumerate(lg_lay):
        if p.is_shard(vdim):
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
            if mesh.size(i) > 1:
                groups.append((mesh, i))
    lo *= logits.shape[-1] // n
    return _local_call(lambda lg, lab: (fn(lg, lab, lo, tuple(groups)),),
                       (logits, labels), (lg_lay, lab_lay), (lab_lay,),
                       mesh)[0]


def _local_call(fn, args: tuple, in_layouts: tuple, out_layouts: tuple,
                mesh):
    """``local_map`` of ``fn`` over DTensor ``args`` redistributed to
    ``in_layouts``, its outputs laid out as ``out_layouts``; an input
    replicated over a mesh dim that an output is sharded on (or holds a
    partial sum over) gets its gradient there as a partial sum, and a
    partial-sum input its gradient whole."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    split = [any(not lay[i].is_replicate() for lay in out_layouts)
             for i in range(mesh.ndim)]
    # a partial sum's gradient is whole on every rank
    grads = tuple(tuple(Replicate() if lay[i].is_partial()
                        else Partial() if split[i] and lay[i].is_replicate()
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
