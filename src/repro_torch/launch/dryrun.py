"""Dry run: count every (arch x shape x mesh) cell of the port's own program.

A port of ``repro.launch.dryrun``, which lowers and compiles each cell's
SPMD program on 512 fake host devices and reads its collectives from the
compiled HLO and its per-device FLOPs and bytes from ``cost_analysis``.
Here one step of the cell's kind runs as the port's own sharded program
(DTensor, as on a real mesh) at the cell's full global shape
and full width, on a `DeviceMesh` of the production shape built over a
fake process group of the mesh's size (``launch/mesh.py`` `fake_mesh`):
this process is rank 0 and holds rank 0's local shards on the meta
device, which hold no data and compute nothing.  It needs no card, as
the reference needed no TPU; the process that counts owns the fake group
(the CLI below, or a child process of its caller).  The mesh is cuda-typed,
so DTensor picks the collectives it issues on NCCL (a ``Shard`` to
``Shard`` move is an all-to-all), as on the card.

One step: train, `train.loss_and_grads` (forward and backward, with the
recompute of its checkpoints) then AdamW's `apply_updates`, on parameters,
AdamW state and batch distributed by the specs of ``launch/sharding.py``;
prefill, ``model.prefill(..., last_only=True)``; decode,
``model.decode_step`` on a distributed decode state; all under the mesh's
`activation_rules`.  `ProgramCounter` reads, on rank 0, each term per
device:

  * **FLOPs.**  The local aten ops' (each counted once: an op on DTensors
    is counted as the local ops DTensor runs for it), by the formulas of
    ``torch.utils.flop_counter``, plus the operations the LM ops' meta
    route charges at the local shard shapes that their kernel regions
    (``models.sharding.local_region``) hand them (flash attention, the
    RG-LRU scan and WKV6, forward and backward, by the formulas in their
    ``ops.py``).  Compute a rule leaves replicated is charged on every
    device that runs it.
  * **Bytes.**  Per local aten op, the bytes of its tensor operands and
    results (XLA's "bytes accessed" convention, on the unfused eager
    program the port runs; views and uninitialized allocations move
    none), plus the LM ops' charged bytes.
  * **Collective bytes.**  Each collective op DTensor issues on rank 0
    (``launch/roofline.py`` `collective_record`: kind, result bytes, its
    group's size), weighted by the ring cost of `collective_stats`; the
    counterpart of the reference's ``parse_collectives``.
  * **Peak memory** is read, as the reference reads ``memory_analysis``:
    `MemoryReader` follows rank 0's local storages through the step.  The
    step's inputs (parameters, AdamW state, batch, decode state) are its
    arguments; every storage a local op allocates is live from that op
    until its last reference drops (a finalizer on the storage), rounded
    up to the caching allocator's 512-byte block; the LM ops' meta route
    allocates what their kernels allocate, scratch included.  The record
    keeps the reference's keys (``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``alias_bytes``: the outputs that are arguments updated
    in place, as the reference donates them; ``peak_live_bytes``, the
    arguments plus ``temp_bytes``, the most that was live beside them) and
    ``fits_80g``, ``peak_at`` (phase, op, the innermost frame of the port,
    the autograd node) and ``largest`` (the five largest buffers live at
    the peak).

On a mesh of one device `count_cell` counts the plain program on meta
tensors (the program the card runs at world size 1), in the calling
process, whatever process group it holds.

A DTensor gradient pass costs about a second a layer on the host, so
`roofline_cell` counts a model cut to one and to two periods of its body
(``ArchConfig.n_body``, its head and tail layers kept) and extrapolates
to its G periods, T(1) + (G - 1) (T(2) - T(1)), as the reference does
with its scan's unroll; the port has no scan, so there is no odd-G
remainder copy to correct for.  The peak memory is extrapolated the same
way where the peak falls at the same site at both depths; elsewhere the
cell is walked at its full depth (``memory.depth``).

Usage:
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out artifacts/dryrun]
  python -m repro_torch.launch.dryrun --arch mixtral_8x7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --shape train_4k   # one shape's cells
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..data import batch_specs
from ..kernels import pin
from ..models import model as M
from ..models.sharding import activation_sharding
from . import roofline as RL
from .mesh import AbstractMesh, fake_group, fake_mesh, make_production_mesh, \
    n_devices
from .sharding import (tree_items, activation_rules, distribute_batch,
                       distribute_state, distribute_tree)

#: ops that move no bytes: they allocate without writing, or wrap or wait
#: for a tensor another op wrote
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "wait_tensor",
             "_wrap_tensor_autograd"}


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t):
    """The local shard of a DTensor, a plain tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


#: the module in which DTensor propagates an op's sharding
_PROPAGATION = os.path.join("distributed", "tensor", "_sharding_prop.py")


def _in_propagation() -> bool:
    """True inside DTensor's sharding propagation (a frame of its module
    on the stack)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


#: the modules whose frames are never a collective's site: the sharding
#: helpers (their caller asked for the layout) and this counter
_NOT_SITES = ("repro_torch/models/sharding.py", "repro_torch/launch/dryrun.py")


def _site(frames) -> str | None:
    """``file:line function`` of the innermost frame of ``frames`` (file,
    line, function; outermost first) in the port and outside
    `_NOT_SITES`."""
    for file, line, fn in reversed(list(frames)):
        f = file.replace(os.sep, "/")
        if "/repro_torch/" in f and not f.endswith(_NOT_SITES):
            return f"{f.rsplit('/', 1)[1]}:{line} {fn}"
    return None


#: the caching allocator rounds every allocation up to a multiple of this
ALLOC_BLOCK = 512
#: ops that rewrap a collective's result (in a storage of their own)
_REWRAP = {"_wrap_tensor_autograd"}
#: the module whose frames recompute a checkpointed function
_CHECKPOINT = os.path.join("torch", "utils", "checkpoint.py")


def _block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _where() -> tuple:
    """(phase, site, autograd node) of the op being dispatched: the site
    the innermost frame of the port outside `_NOT_SITES`; the phase
    "forward", "recompute" (under an autograd node, a checkpointed
    function rerun), "backward" (under a node otherwise, or the step's
    gradient handling) or "optimizer" (AdamW)."""
    node = torch._C._current_autograd_node()
    f, site, ckpt = sys._getframe(3), None, False
    while f is not None:
        name = f.f_code.co_filename
        if site is None and "repro_torch" in name and not \
                name.replace(os.sep, "/").endswith(_NOT_SITES):
            site = f"{os.path.basename(name)}:{f.f_lineno} {f.f_code.co_name}"
            if node is None:
                break
        if node is not None and name.endswith(_CHECKPOINT):
            ckpt = True
            break
        f = f.f_back
    if node is not None:
        return ("recompute" if ckpt else "backward"), site, node.name()
    if site is not None and site.startswith("adamw.py"):
        return "optimizer", site, None
    if site is not None and site.startswith("step.py"):
        return "backward", site, None
    return "forward", site, None


class MemoryReader:
    """The live storages of one device type (``device``: "meta" for the dry
    run's local shards) through a program, as a caching allocator holds
    them.  `arguments` takes the program's inputs, live throughout;
    `note` sees each op's outputs and counts a storage that no input of
    the op holds and that is not known yet, rounded up to `ALLOC_BLOCK`,
    live until its last reference drops (a weak reference's callback: no
    sweep).  A collective's result that an op rewraps in a storage of its
    own (the data stays in the collective's on a real backend and moves to
    the wrapper's under the fake one) is the one buffer, live while either
    storage is.  ``peak``
    is the most live beside the arguments, reached at the allocation
    ``peak_rec``; every allocation is kept as a row (bytes, shape, dtype,
    op, phase, site, node, born, died) so that `largest` can list the
    buffers live at the peak."""

    def __init__(self, device: str = "meta"):
        self.device = device
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self.peak_rec = None
        self.rows: list = []
        self._args: set = set()
        self._known: dict = {}
        self._holders: dict = {}
        self._clock = 0

    def arguments(self, tree) -> None:
        """The program's inputs: the tensors of ``tree`` (a DTensor's local
        shard)."""
        for t in map(_local, _tensors(tree)):
            key = t.untyped_storage()._cdata
            if key not in self._args:
                self._args.add(key)
                self.argument_bytes += _nbytes(t)

    def is_argument(self, t) -> bool:
        return t.untyped_storage()._cdata in self._args

    def note(self, func, args, kwargs, out) -> None:
        ins = None
        for t in _tensors(out):
            if t.device.type != self.device:
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._known or key in self._args:
                continue
            if ins is None:
                ins = [x.untyped_storage()._cdata
                       for x in _tensors((args, kwargs))
                       if x.device.type == self.device]
            if key in ins:
                continue
            if func.overloadpacket.__name__ in _REWRAP and ins \
                    and ins[0] in self._known:
                self._follow(s, key, self._known[ins[0]][0])
            else:
                self._alloc(s, key, t, func)

    def _follow(self, s, key, i: int) -> None:
        """Follow the storage ``s`` as (one of) the buffer of row ``i``."""
        self._known[key] = (i, weakref.ref(
            s, lambda _ref, key=key: self._freed(key)))
        self._holders[i] = self._holders.get(i, 0) + 1

    def _alloc(self, s, key, t, func) -> None:
        n = _block(s.nbytes())
        self._clock += 1
        phase, site, node = _where()
        i = len(self.rows)
        self.rows.append([n, tuple(t.shape), str(t.dtype).split(".")[-1],
                          func.overloadpacket.__name__, phase, site, node,
                          self._clock, None])
        self._follow(s, key, i)
        self.live += n
        if self.live > self.peak:
            self.peak, self.peak_rec = self.live, i

    def _freed(self, key) -> None:
        entry = self._known.pop(key, None)
        if entry is None:
            return
        i = entry[0]
        self._holders[i] -= 1
        if self._holders[i]:
            return
        del self._holders[i]
        row = self.rows[i]
        self._clock += 1
        row[8] = self._clock
        self.live -= row[0]

    def close(self) -> None:
        """Stop following the storages still live."""
        self._known.clear()
        self._holders.clear()

    def largest(self, n: int = 5) -> list:
        """The ``n`` largest buffers live at the peak."""
        if self.peak_rec is None:
            return []
        at = self.rows[self.peak_rec][7]
        live = [r for r in self.rows
                if r[7] <= at and (r[8] is None or r[8] > at)]
        live.sort(key=lambda r: -r[0])
        return [_row_json(r) for r in live[:n]]

    def largest_allocation(self) -> dict | None:
        """The largest buffer allocated at any time."""
        return _row_json(max(self.rows, key=lambda r: r[0])) \
            if self.rows else None

    def peak_at(self) -> dict | None:
        return None if self.peak_rec is None else {
            k: v for k, v in _row_json(self.rows[self.peak_rec]).items()
            if k in ("op", "phase", "site", "node")}


def _row_json(r) -> dict:
    return dict(bytes=r[0], shape=list(r[1]), dtype=r[2], op=r[3],
                phase=r[4], site=r[5], node=r[6])


class ProgramCounter(TorchDispatchMode):
    """Counts one rank's program: its local aten ops on the meta device
    (the dry run's tensors; ``ops``), their bytes (``bytes``: tensor
    operands and results; a view, and an op that allocates without
    writing, moves none), their FLOPs (``flops``, by
    ``torch.utils.flop_counter``'s formulas) and its collectives, on any
    device.  An op on no meta tensor is not the program's: DTensor plans
    a layout the first time it meets it with small host tensors (a
    mesh's coordinates).

    An op on DTensors is left to DTensor (the mode declines it), which
    runs it as local ops and collectives that come back through the mode:
    each is counted once, at the shape this rank holds.  The ops DTensor
    runs to propagate an op's sharding (on fake or meta tensors, the
    first time it meets the op's signature) are no part of the program
    and are not counted.  Each collective
    (``launch/roofline.py`` `collective_record`) is kept as a record
    ``(kind, result_bytes, group_size, site)`` in ``collectives``, counted
    by kind (``count``, ``nbytes``: result bytes) and booked by ``sites``:
    (phase, site, kind) -> [count, bytes].  The site is the innermost
    frame of the port that issued it; in the backward, that of the forward
    op whose gradient issued it when anomaly mode recorded its stack
    (``torch.autograd.detect_anomaly``), else None.  The phase is
    "forward", "recompute" (a checkpointed layer rerun in the backward)
    or "backward".

    With ``memory`` (a device type), a `MemoryReader` of that device's
    storages (``reader``) sees every op of the program as well."""

    def __init__(self, memory: str | None = None):
        super().__init__()
        self.reader = None if memory is None else MemoryReader(memory)
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.ops = 0
        self.bytes = 0
        self.flops = 0.0
        self.collectives: list = []
        self.count: dict = defaultdict(int)
        self.nbytes: dict = defaultdict(float)
        self.sites: dict = defaultdict(lambda: [0, 0.0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        dt = sys.modules.get("torch.distributed.tensor")
        if dt is not None and any(issubclass(t, dt.DTensor) for t in types):
            return NotImplemented
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None \
                or _in_propagation():
            # DTensor's sharding propagation deriving an op's output
            # shape or strategy on fake or meta tensors (once per op
            # signature): no part of the program
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        rec = RL.collective_record(func, args, out)
        if rec is not None:
            self._book(*rec)
        if self.reader is not None:
            self.reader.note(func, args, kwargs, out)
        tensors = _tensors((args, kwargs)) + _tensors(out)
        if not any(t.is_meta for t in tensors):
            return out
        self.ops += 1
        packet = func.overloadpacket
        if not func.is_view and packet.__name__ not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in tensors)
        formula = self._flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out

    def _book(self, kind: str, nbytes: int, group: int) -> None:
        here = [(f.filename, f.lineno, f.name)
                for f in traceback.extract_stack()]
        site, phase = _site(here), "forward"
        node = torch._C._current_autograd_node()
        if node is not None:
            phase = "recompute"
            if site is None or site.split(":")[0] == "step.py":
                phase = "backward"
                site = _site(_FRAME.findall("".join(
                    node.metadata.get("traceback_", []))))
        self.collectives.append((kind, nbytes, group, site))
        self.count[kind] += 1
        self.nbytes[kind] += nbytes
        rec = self.sites[(phase, site, kind)]
        rec[0] += 1
        rec[1] += nbytes


def meta_params(cfg, dtype=torch.bfloat16, device="meta") -> dict:
    """The model's parameter tree (bf16, or ``dtype``) on the meta device
    (or drawn on ``device``)."""
    return M.init_params(cfg, torch.Generator().manual_seed(0),
                         device=device, dtype=dtype)


def meta_batch(cfg, B: int, S: int, labels: bool = True,
               device="meta") -> dict:
    """A batch of (B, S) on the meta device (or zeros on ``device``)."""
    specs = batch_specs(cfg, B, S)
    if not labels:
        specs.pop("labels")
    make = torch.empty if device == "meta" else torch.zeros
    return {k: make(shape, dtype=dt, device=device)
            for k, (shape, dt) in specs.items()}


def _step_inputs(cfg, kind: str, B: int, S: int, mesh, dtype, depth,
                 device="meta"):
    """The inputs of one step of ``kind`` on the meta device (or drawn on
    ``device``): (params, AdamW state or None, batch, decode state or
    None), distributed by their specs (the body stacked ``depth`` deep)
    when ``mesh`` is a `DeviceMesh` (meta local shards)."""
    from ..optim import AdamWConfig, init_state

    params = meta_params(cfg, dtype, device)
    opt = state = None
    if kind == "train":
        batch = meta_batch(cfg, B, S, device=device)
        opt = init_state(AdamWConfig(), params)
    elif kind == "prefill":
        batch = meta_batch(cfg, B, S, labels=False, device=device)
    else:
        state = M.init_decode_state(cfg, B, S, device=device)
        K = cfg.n_codebooks
        batch = {"tokens": torch.zeros((B, 1, K) if K > 1 else (B, 1),
                                       dtype=torch.int32, device=device),
                 "pos": torch.zeros((B,), dtype=torch.int32, device=device)}
    if isinstance(mesh, AbstractMesh):
        return params, opt, batch, state
    train = kind == "train"
    params = distribute_tree(params, mesh, cfg, fsdp=train, depth=depth)
    if opt is not None:
        opt = distribute_tree(opt, mesh, cfg, depth=depth)
    batch = distribute_batch(batch, mesh)
    if state is not None:
        state = distribute_state(state, mesh, B)
    return params, opt, batch, state


def read_memory(reader: MemoryReader, outputs) -> dict:
    """The memory record of a program that ``reader`` followed and that
    returned ``outputs`` (those among them that are its arguments,
    updated in place, are aliased as the reference donates them)."""
    keys, out_b, alias_b = set(), 0, 0
    for t in map(_local, _tensors(outputs)):
        key = t.untyped_storage()._cdata
        if key in keys:
            continue
        keys.add(key)
        out_b += _nbytes(t)
        if reader.is_argument(t):
            alias_b += _nbytes(t)
    peak = reader.argument_bytes + reader.peak
    return {"argument_bytes": reader.argument_bytes, "output_bytes": out_b,
            "temp_bytes": reader.peak, "alias_bytes": alias_b,
            "peak_live_bytes": peak,
            "fits_80g": bool(peak <= RL.HBM_PER_DEVICE),
            "peak_at": reader.peak_at(), "largest": reader.largest()}


def count_program(cfg, kind: str, B: int, S: int, mesh,
                  microbatches: int = 1, dtype=torch.bfloat16,
                  depth: int | None = None, device: str = "meta") -> dict:
    """FLOPs, bytes, aten ops, collectives and memory of one step of
    ``kind`` at (B, S) as rank 0 of ``mesh`` runs it (`ProgramCounter`,
    its `MemoryReader` on ``device``), the LM ops' meta charges included:
    the sharded program on a `DeviceMesh`, the plain program on an
    `AbstractMesh` of one device; parameters in ``dtype``, laid out with
    the body stacked ``depth`` deep (a cut model's: the whole model's,
    `cut_to_periods`).  The inputs are meta tensors, or drawn on
    ``device`` (FLOPs and bytes are then not counted; memory is).  The
    caller opens the mesh's activation rules."""
    from ..optim import AdamWConfig, apply_updates
    from ..train import loss_and_grads

    if isinstance(mesh, AbstractMesh) and n_devices(mesh) != 1:
        raise ValueError(f"{mesh}: a mesh of several devices is counted on "
                         "a DeviceMesh (`fake_mesh`)")
    params, opt, batch, state = _step_inputs(cfg, kind, B, S, mesh, dtype,
                                             depth, device)
    pc = ProgramCounter(memory=device)
    pc.reader.arguments((params, opt, batch, state))
    with pc, pin.meta_charges() as charges:
        if kind == "train":
            # as `train.make_train_step`'s step
            loss, grads = loss_and_grads(params, cfg, batch, microbatches)
            params, opt, om = apply_updates(AdamWConfig(), params, grads,
                                            opt)
            outputs = (params, opt, {"loss": loss, **om})
            del grads
        elif kind == "prefill":
            outputs = M.prefill(params, cfg, batch, last_only=True)
        else:
            outputs = M.decode_step(params, cfg, state, batch["tokens"],
                                    batch["pos"])
    memory = read_memory(pc.reader, outputs)
    pc.reader.close()
    by_op: dict = {}
    for op, flops, nb in charges:
        row = by_op.setdefault(op, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nb
    return {"flops_counted": float(pc.flops),
            "bytes_counted": float(pc.bytes), "aten_ops": pc.ops,
            "kernel_ops": by_op,
            "flops": float(pc.flops)
            + sum(r["flops"] for r in by_op.values()),
            "bytes": float(pc.bytes) + sum(r["bytes"] for r in by_op.values()),
            "collectives": pc.collectives,
            "result_bytes_by_kind": dict(pc.nbytes),
            "sites": [[phase, site, kind, n, b] for (phase, site, kind),
                      (n, b) in sorted(pc.sites.items(),
                                       key=lambda kv: -kv[1][1])],
            "memory": memory}


@contextlib.contextmanager
def program_mesh(mesh):
    """The mesh to run the program on: a `DeviceMesh` as it is, an
    `AbstractMesh` of one device as it is, and an `AbstractMesh` of more as
    a cuda-typed `fake_mesh` of its shape over a fake group that this
    process owns for the block (`fake_group`)."""
    if not isinstance(mesh, AbstractMesh) or n_devices(mesh) == 1:
        yield mesh
        return
    with fake_group(n_devices(mesh)):
        yield fake_mesh(mesh.shape, mesh.mesh_dim_names)


def _model_flops(cfg, kind: str, B: int, S: int) -> float:
    n_active = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_active * B * S
    if kind == "prefill":
        return 2.0 * n_active * B * S
    return 2.0 * n_active * B


def count_cell(cfg, kind: str, B: int, S: int, mesh,
               microbatches: int = 1, dtype=torch.bfloat16,
               periods: int | None = None) -> dict:
    """The record's counted part for ``cfg`` at (B, S) on ``mesh`` (an
    `AbstractMesh`, counted on its `program_mesh`, or a `DeviceMesh`),
    parameters in ``dtype``; the program of the model cut to ``periods``
    body periods if given (`cut_to_periods`; the parameter counts stay the
    whole model's): ``roofline``, ``collectives``, ``memory`` (the cut
    program's read), ``counts``, ``count_s``, ``aten_ops``,
    ``model_flops``, ``n_params``, ``n_active_params``, ``torch`` (the
    version that ran the program)."""
    n_dev = n_devices(mesh)
    rules = activation_rules(mesh, B, n_kv=cfg.n_kv_heads)
    t0 = time.perf_counter()
    run = cfg if periods is None else cut_to_periods(cfg, periods)
    with program_mesh(mesh) as pmesh, activation_sharding(pmesh, rules):
        counts = count_program(run, kind, B, S, pmesh, microbatches, dtype,
                               depth=cfg.n_body)
    mem = counts.pop("memory")
    coll = RL.collective_stats(counts["collectives"], n_dev)
    model_flops = _model_flops(cfg, kind, B, S)
    rl = RL.roofline_terms({"flops": counts["flops"],
                            "bytes accessed": counts["bytes"]}, coll, n_dev,
                           model_flops)
    n_params = sum(t.numel() for _, t in tree_items(
        M.init_params(cfg, torch.Generator(), device="meta")))
    return {"n_params": n_params,
            "n_active_params": cfg.n_active_params(),
            # the torch whose DTensor chose the program's collectives
            "torch": torch.__version__,
            "count_s": round(time.perf_counter() - t0, 3),
            "aten_ops": counts["aten_ops"], "memory": mem,
            "collectives": coll.to_json(),
            "roofline": dict(rl.to_json(), extrapolated=False),
            "counts": dict(counts, collectives=coll.to_json()),
            "model_flops": model_flops}


def cut_to_periods(cfg, periods: int):
    """``cfg`` with its body cut to ``periods`` repeats of its block
    pattern, its head (the first dense layers) and tail layers kept; each
    kept layer keeps its kind (a layer's mixer follows its index modulo
    the pattern)."""
    drop = (cfg.n_body - periods) * len(cfg.block_pattern)
    return dataclasses.replace(cfg, n_layers=cfg.n_layers - drop)


def _lin(a, b, G: int):
    """T(1) + (G - 1) (T(2) - T(1)), key by key through dicts."""
    if isinstance(a, dict):
        return {k: _lin(a.get(k, 0), b.get(k, 0), G) for k in a.keys() | b}
    return a + (G - 1) * (b - a)


def extrapolate_counts(c1: dict, c2: dict, G: int) -> dict:
    """The counts of a model of ``G`` body periods from those at one
    (``c1``) and two (``c2``) periods: every count, FLOP and byte term,
    the LM ops' charges and the collectives by kind, linear in G.  The
    costliest collectives and the sites listed are ``c2``'s."""
    keys = ("flops_counted", "bytes_counted", "aten_ops", "flops", "bytes",
            "kernel_ops")
    out = {k: _lin(c1[k], c2[k], G) for k in keys}
    s1, s2 = c1["collectives"], c2["collectives"]
    by_kind = _lin(s1["bytes_by_kind"], s2["bytes_by_kind"], G)
    out["collectives"] = RL.CollectiveStats(
        by_kind, float(sum(by_kind.values())),
        _lin(s1["count_by_kind"], s2["count_by_kind"], G),
        s2["top"]).to_json()
    out["result_bytes_by_kind"] = _lin(c1["result_bytes_by_kind"],
                                       c2["result_bytes_by_kind"], G)
    out["sites"] = c2["sites"]
    return out


def _cell(arch_id: str, shape_name: str, multi_pod: bool, perf_variant: str,
          cfg):
    if cfg is None:
        cfg = configs.get(arch_id)
    shape = configs.SHAPES[shape_name]
    expert_axis = 0
    if perf_variant.startswith("moe3d"):
        expert_axis = int(perf_variant[5:] or "8")
    mesh = make_production_mesh(multi_pod=multi_pod, expert_axis=expert_axis)
    rec = dict(arch=arch_id, shape=shape_name,
               mesh="multi" if multi_pod else "single",
               n_devices=n_devices(mesh), batch=shape["batch"],
               seq=shape["seq"], kind=shape["kind"], variant=perf_variant)
    return cfg, mesh, rec


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               perf_variant: str = "base", cfg=None,
               periods: int | None = None) -> dict:
    """Count one cell, its model cut to ``periods`` body periods if given
    (`cut_to_periods`; the parameter counts stay the whole model's);
    returns the JSON record."""
    cfg, mesh, rec = _cell(arch_id, shape_name, multi_pod, perf_variant, cfg)
    rec.update(count_cell(cfg, rec["kind"], rec["batch"], rec["seq"], mesh,
                          periods=periods))
    rec["periods"] = cfg.n_body if periods is None else periods
    return rec


#: the memory terms that grow with depth
_MEMORY_TERMS = ("argument_bytes", "output_bytes", "temp_bytes",
                 "alias_bytes", "peak_live_bytes")


def extrapolate_memory(m1: dict, m2: dict, G: int) -> dict | None:
    """The memory of a model of ``G`` body periods from its reads at one
    (``m1``) and two (``m2``) periods, each term linear in G, where the
    peak falls at the same site at both depths (``peak_at``); else None.
    ``peak_at`` and ``largest`` are ``m2``'s."""
    if m1["peak_at"] != m2["peak_at"]:
        return None
    out = dict(m2, **{k: _lin(m1[k], m2[k], G) for k in _MEMORY_TERMS})
    out["fits_80g"] = bool(out["peak_live_bytes"] <= RL.HBM_PER_DEVICE)
    return out


def roofline_cell(arch_id: str, shape_name: str, multi_pod: bool,
                  perf_variant: str = "base", cfg=None) -> dict:
    """The full cell record.  A model of G > 2 body periods is counted at
    one and at two (`lower_cell` with ``periods``) and its counts, FLOPs,
    bytes, collectives and memory extrapolated to G (`extrapolate_counts`,
    `extrapolate_memory`); where the peak memory falls at another site at
    the two depths the cell is walked at its full depth instead
    (``memory.depth``: "extrapolated" or "walked")."""
    if cfg is None:
        cfg = configs.get(arch_id)
    G = cfg.n_body
    if G <= 2:
        rec = lower_cell(arch_id, shape_name, multi_pod, perf_variant, cfg)
        rec["memory"]["depth"] = "walked"
        return rec
    one = lower_cell(arch_id, shape_name, multi_pod, perf_variant, cfg, 1)
    two = lower_cell(arch_id, shape_name, multi_pod, perf_variant, cfg, 2)
    mem = extrapolate_memory(one["memory"], two["memory"], G)
    if mem is None:
        rec = lower_cell(arch_id, shape_name, multi_pod, perf_variant, cfg)
        rec["memory"]["depth"] = "walked"
        rec["count_s"] = round(rec["count_s"] + one["count_s"]
                               + two["count_s"], 3)
        return rec
    counts = extrapolate_counts(one["counts"], two["counts"], G)
    coll = RL.CollectiveStats(**{k: counts["collectives"][k] for k in (
        "bytes_by_kind", "total_bytes", "count_by_kind", "top")})
    rl = RL.roofline_terms({"flops": counts["flops"],
                            "bytes accessed": counts["bytes"]}, coll,
                           one["n_devices"], one["model_flops"])
    rec = dict(one, counts=counts, aten_ops=counts["aten_ops"],
               collectives=coll.to_json(), periods=G,
               memory=dict(mem, depth="extrapolated"),
               count_s=round(one["count_s"] + two["count_s"], 3))
    rec["roofline"] = dict(rl.to_json(), extrapolated=True)
    rec["roofline_probe_periods2"] = two["roofline"]
    return rec


def count_one(arch: str, shape: str, mesh_name: str, variant: str) -> dict:
    """One cell's record, or, for a cell that fails, its error (these are
    bugs of the port's program: recorded, never modelled)."""
    try:
        return roofline_cell(arch, shape, mesh_name == "multi", variant)
    except Exception as e:  # record and continue: these are bugs
        return dict(arch=arch, shape=shape, mesh=mesh_name, variant=variant,
                    error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-4000:])


def _worker_init() -> None:
    torch.set_num_threads(1)
    _quiet()


def _quiet() -> None:
    """DTensor warns at each redistribution over several mesh dims."""
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def run_cells(cells, meshes, out_dir: str, variant: str = "base",
              quiet: bool = False, jobs: int = 1) -> list[dict]:
    """Count the cells not cached under ``out_dir`` (in ``jobs`` worker
    processes, each owning its fake groups, when above 1) and write each
    record there; returns them in order."""
    os.makedirs(out_dir, exist_ok=True)
    say = (lambda *a: None) if quiet else print
    todo, records = [], {}
    for arch, shape in cells:
        for mesh_name in meshes:
            tag = f"{arch}_{shape}_{mesh_name}" + (
                "" if variant == "base" else f"_{variant}")
            path = os.path.join(out_dir, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    records[tag] = json.load(f)
                rl = records[tag].get("roofline", {})
                say(f"[cached] {tag}: "
                    f"{rl.get('dominant', records[tag].get('error', '?'))}")
            else:
                todo.append((tag, (arch, shape, mesh_name, variant)))
    if jobs > 1 and len(todo) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        with cf.ProcessPoolExecutor(
                min(jobs, len(todo)), mp_context=mp.get_context("spawn"),
                initializer=_worker_init) as pool:
            done = zip(todo, pool.map(count_one, *zip(*(a for _, a in todo))))
            counted = [(tag, rec) for (tag, _), rec in done]
    else:
        counted = [(tag, count_one(*a)) for tag, a in todo]
    for tag, rec in counted:
        if "error" in rec:
            say(f"[FAIL] {tag}: {rec['error'][:300]}")
        else:
            rl = rec["roofline"]
            say(f"[ok] {tag}: count={rec['count_s']}s "
                f"dom={rl['dominant']} "
                f"terms=({rl['compute_s']:.4f},{rl['memory_s']:.4f},"
                f"{rl['collective_s']:.4f})s "
                f"mem={rec['memory']['peak_live_bytes'] / 2**30:.2f}GiB "
                f"fits={rec['memory']['fits_80g']}")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        records[tag] = rec
    order = [f"{a}_{s}_{m}" + ("" if variant == "base" else f"_{variant}")
             for a, s in cells for m in meshes]
    return [records[t] for t in order]


def main(argv=None):
    _quiet()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes counting cells side by side")
    args = ap.parse_args(argv)
    if args.list:
        for a, s in configs.cells():
            print(a, s)
        return
    if args.all:
        cells = [c for c in configs.cells()
                 if args.shape is None or c[1] == args.shape]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    records = run_cells(cells, meshes, args.out, args.variant,
                        jobs=args.jobs)
    n_fail = sum(1 for r in records if "error" in r)
    print(f"\n{len(records) - n_fail}/{len(records)} cells counted")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
