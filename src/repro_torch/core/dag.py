"""DAG-of-tasks data structures (paper §2.1, §4 definitions).

A job is a DAG G = {V, E}.  Each node is a task with a duration and a
d-dimensional resource demand (normalized so that one machine has capacity
1.0 in every dimension).  Tasks are grouped into *stages* (e.g. a map or a
reduce): tasks in a stage have similar durations / demands and identical
dependencies — the structural fact DAGPS leans on (§4.4, §6).

Bitset-based ancestor/descendant closures give O(n^2/64) reachability, which
the troublesome-task closure (§4.1), the subset split and NewLB (§6) all use.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

import numpy as np

NRES = 4  # cores, memory, network, disk (paper §2.1)


def dag_digest(dag: "DAG") -> bytes:
    """Canonical 128-bit content digest of a DAG.

    The one digest shared by the simulator's schedule cache, the build
    service's dedup front (core/buildsvc.py) and bench harnesses:
    ``build_schedule`` is a deterministic function of DAG *content*, so
    equal digests may share one constructed schedule exactly.

    Covers everything construction reads — per-task duration, demand,
    stage and the dependency structure — and nothing it does not (names,
    cached closures).  Parent lists are hashed as sorted id sets: edge
    insertion order is presentation, not content (every consumer treats
    a parent row as a set), so permuted-but-equal inputs collide by
    design.  Task *ids* stay positional: schedules are id-indexed, so two
    DAGs must only collide when every id means the same task — permuting
    identical sibling tasks leaves all arrays (and the digest) unchanged,
    while permuting distinguishable tasks changes them.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(dag.n).tobytes())
    h.update(np.int64(dag.d).tobytes())
    h.update(dag.duration.tobytes())
    h.update(dag.demand.tobytes())
    h.update(np.asarray(dag.stage_of, dtype=np.int64).tobytes())
    for p in dag.parents:
        h.update(np.sort(np.asarray(p, dtype=np.int64)).tobytes())
        h.update(b";")
    return h.digest()


def _pack_reach(n: int, adj: Sequence[np.ndarray]) -> np.ndarray:
    """Transitive closure as packed uint64 bitsets.

    adj[i] lists *direct* predecessors of i, and i must be topologically
    ordered so that all predecessors of i have index < i.
    Returns reach[n, ceil(n/64)] where bit j of row i => j is a strict
    ancestor of i under adj.
    """
    words = (n + 63) // 64
    reach = np.zeros((n, words), dtype=np.uint64)
    for i in range(n):
        row = reach[i]
        for p in adj[i]:
            row |= reach[p]
            row[p >> 6] |= np.uint64(1) << np.uint64(p & 63)
    return reach


def _bit_test(bits: np.ndarray, j: int) -> bool:
    return bool((bits[j >> 6] >> np.uint64(j & 63)) & np.uint64(1))


def _mask_to_ids(mask: np.ndarray) -> np.ndarray:
    return np.nonzero(mask)[0]


@dataclasses.dataclass
class DAG:
    """A job DAG over tasks, with stage grouping.

    All arrays are indexed by task id 0..n-1 in topological order.
    """

    duration: np.ndarray              # (n,) float seconds
    demand: np.ndarray                # (n, d) float in [0, 1] per machine
    stage_of: np.ndarray              # (n,) int
    parents: list[np.ndarray]         # direct predecessors per task
    name: str = "dag"

    def __post_init__(self) -> None:
        self.duration = np.asarray(self.duration, dtype=np.float64)
        self.demand = np.atleast_2d(np.asarray(self.demand, dtype=np.float64))
        self.stage_of = np.asarray(self.stage_of, dtype=np.int64)
        n = self.n
        if not (len(self.demand) == len(self.stage_of) == len(self.parents) == n):
            raise ValueError("inconsistent DAG arrays")
        self.parents = [np.asarray(p, dtype=np.int64) for p in self.parents]
        for i, ps in enumerate(self.parents):
            if len(ps) and ps.max() >= i:
                raise ValueError("tasks must be topologically ordered")
        self.children: list[np.ndarray] = [np.empty(0, np.int64) for _ in range(n)]
        kids: list[list[int]] = [[] for _ in range(n)]
        for i, ps in enumerate(self.parents):
            for p in ps:
                kids[int(p)].append(i)
        self.children = [np.asarray(k, dtype=np.int64) for k in kids]
        self.n_stages = int(self.stage_of.max()) + 1 if n else 0
        self.stages: list[np.ndarray] = [
            np.nonzero(self.stage_of == s)[0] for s in range(self.n_stages)
        ]
        self._anc_bits: np.ndarray | None = None
        self._desc_bits: np.ndarray | None = None

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.duration)

    @property
    def d(self) -> int:
        return self.demand.shape[1]

    @property
    def anc_bits(self) -> np.ndarray:
        if self._anc_bits is None:
            self._anc_bits = _pack_reach(self.n, self.parents)
        return self._anc_bits

    @property
    def desc_bits(self) -> np.ndarray:
        if self._desc_bits is None:
            # D[i, j] = "j is a descendant of i" = A[j, i]: transpose the
            # unpacked ancestor matrix and repack.
            n = self.n
            words = (n + 63) // 64
            anc = np.unpackbits(
                self.anc_bits.view(np.uint8), axis=1, bitorder="little"
            )[:, :n]
            packed = np.packbits(np.ascontiguousarray(anc.T), axis=1, bitorder="little")
            full = np.zeros((n, words * 8), dtype=np.uint8)
            full[:, : packed.shape[1]] = packed
            self._desc_bits = full.view(np.uint64)
        return self._desc_bits

    # -- set helpers (masks are (n,) bool) ------------------------------
    def ancestors_mask(self, ids: Iterable[int]) -> np.ndarray:
        mask = np.zeros(self.n, dtype=bool)
        bits = np.zeros_like(self.anc_bits[0])
        for i in ids:
            bits |= self.anc_bits[i]
        _bits_into_mask(bits, mask)
        return mask

    def descendants_mask(self, ids: Iterable[int]) -> np.ndarray:
        mask = np.zeros(self.n, dtype=bool)
        bits = np.zeros_like(self.desc_bits[0])
        for i in ids:
            bits |= self.desc_bits[i]
        _bits_into_mask(bits, mask)
        return mask

    def closure_mask(self, mask: np.ndarray) -> np.ndarray:
        """Closure(T) §4.1: T plus every task on a path between two T-tasks."""
        ids = _mask_to_ids(mask)
        if len(ids) == 0:
            return mask.copy()
        anc = self.ancestors_mask(ids)
        desc = self.descendants_mask(ids)
        return mask | (anc & desc)

    def split_subsets(self, t_mask: np.ndarray):
        """Given a *closed* T, return masks (T, O, P, C) per §4.1."""
        ids = _mask_to_ids(t_mask)
        anc = self.ancestors_mask(ids)
        desc = self.descendants_mask(ids)
        p_mask = anc & ~t_mask
        c_mask = desc & ~t_mask
        o_mask = ~(t_mask | p_mask | c_mask)
        return t_mask, o_mask, p_mask, c_mask

    # -- stage-level structure -------------------------------------------
    def stage_parents(self) -> list[set[int]]:
        sp: list[set[int]] = [set() for _ in range(self.n_stages)]
        for i in range(self.n):
            si = int(self.stage_of[i])
            for p in self.parents[i]:
                ps = int(self.stage_of[p])
                if ps != si:
                    sp[si].add(ps)
        return sp

    def work(self) -> float:
        """Total work: sum over tasks of duration * demand, maxed over resources."""
        return float((self.duration[:, None] * self.demand).sum(axis=0).max())

    def validate_order(self, order: Sequence[int]) -> bool:
        pos = {int(t): k for k, t in enumerate(order)}
        return all(
            pos[int(p)] < pos[i]
            for i in range(self.n)
            for p in self.parents[i]
        )


# ----------------------------------------------------------------------
# Graph mutation (dynamic DAGs): every op returns a NEW DAG plus a
# DagDelta describing the edit.  DAGs stay immutable values — digests,
# cached schedules and memo entries keyed by content never go stale.
# Reachability bits are carried over incrementally (new rows / inserted
# rows+columns / packed OR-propagation) instead of re-running the
# per-row python loop in _pack_reach over the whole graph.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DagDelta:
    """Record of one mutation: old/new identity plus the touched surface.

    ``touched`` lists new-dag task ids whose content or edge set changed
    (including newly created tasks); ``id_map`` maps every old task id to
    its new id (-1 = removed).  ``digest`` is the canonical key for
    dedup'ing *edits* (BuildService.resubmit): two submissions of the
    same edit to the same base collide, different edits never do.
    """

    kind: str                  # append_tasks|append_stage|resize_stage|...
    base_digest: bytes         # dag_digest of the DAG the edit applied to
    new_digest: bytes          # dag_digest of the mutated DAG
    touched: np.ndarray        # new-dag ids with changed content/edges
    id_map: np.ndarray         # (old_n,) old id -> new id, -1 if removed

    @property
    def digest(self) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(self.kind.encode())
        h.update(self.base_digest)
        h.update(self.new_digest)
        return h.digest()


def _grown_anc(old: "DAG", new: "DAG") -> np.ndarray | None:
    """Ancestor bitsets for a pure append: copy old rows, derive only the
    new ones (the _pack_reach recurrence, restricted to appended ids)."""
    if old._anc_bits is None:
        return None   # base never computed closures; stay lazy
    n, words = new.n, (new.n + 63) // 64
    anc = np.zeros((n, words), dtype=np.uint64)
    anc[: old.n, : old.anc_bits.shape[1]] = old.anc_bits
    for i in range(old.n, n):
        row = anc[i]
        for p in new.parents[i]:
            row |= anc[p]
            row[p >> 6] |= np.uint64(1) << np.uint64(p & 63)
    return anc


def _repack(mat: np.ndarray) -> np.ndarray:
    """Bool (n, n) reachability matrix -> packed uint64 (n, ceil(n/64))."""
    n = len(mat)
    words = (n + 63) // 64
    packed = np.packbits(np.ascontiguousarray(mat), axis=1, bitorder="little")
    full = np.zeros((n, words * 8), dtype=np.uint8)
    full[:, : packed.shape[1]] = packed
    return full.view(np.uint64)


def _unpack(bits: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(bits.view(np.uint8), axis=1,
                         bitorder="little")[:, :n].astype(bool)


def append_tasks(
    dag: DAG,
    duration: Sequence[float],
    demand: Sequence[Sequence[float]],
    stage_of: Sequence[int],
    parents: Sequence[Sequence[int]],
) -> tuple[DAG, DagDelta]:
    """Append k tasks at ids n..n+k-1 (task arrival into a live job).

    New tasks may depend on any earlier task (existing or earlier-appended)
    and may open new stages.  Ancestor rows are extended incrementally;
    descendant bits are re-derived lazily (already vectorized).
    """
    base = dag_digest(dag)
    n, k = dag.n, len(duration)
    if k == 0:
        raise ValueError("append_tasks: nothing to append")
    for j, ps in enumerate(parents):
        ps = np.asarray(ps, dtype=np.int64)
        if len(ps) and ps.max() >= n + j:
            raise ValueError(
                "appended task may only depend on earlier tasks "
                "(topological order / cycle guard)")
    new = DAG(
        duration=np.concatenate([dag.duration, np.asarray(duration, np.float64)]),
        demand=np.vstack([dag.demand, np.atleast_2d(np.asarray(demand, np.float64))]),
        stage_of=np.concatenate([dag.stage_of, np.asarray(stage_of, np.int64)]),
        parents=list(dag.parents) + [np.sort(np.asarray(p, np.int64)) for p in parents],
        name=dag.name,
    )
    new._anc_bits = _grown_anc(dag, new)
    delta = DagDelta("append_tasks", base, dag_digest(new),
                     touched=np.arange(n, n + k, dtype=np.int64),
                     id_map=np.arange(n, dtype=np.int64))
    return new, delta


def append_stage(
    dag: DAG,
    q: int,
    duration: float,
    demand: Sequence[float],
    parent_stages: Sequence[int] = (),
) -> tuple[DAG, DagDelta]:
    """Append one new q-task stage depending all-to-all on parent stages."""
    par = (np.sort(np.concatenate([dag.stages[int(s)] for s in parent_stages]))
           if len(parent_stages) else np.empty(0, np.int64))
    new, delta = append_tasks(
        dag,
        duration=[float(duration)] * q,
        demand=[np.asarray(demand, np.float64)] * q,
        stage_of=[dag.n_stages] * q,
        parents=[par] * q,
    )
    return new, dataclasses.replace(delta, kind="append_stage")


def resize_stage(dag: DAG, stage: int, new_q: int) -> tuple[DAG, DagDelta]:
    """Grow or shrink a stage to new_q interchangeable tasks.

    Growth clones the stage's last member (same duration, demand, parents
    AND children) immediately after it, so anc(clone) == anc(template) and
    desc(clone) == desc(template): the reachability update is an insert of
    copied rows/columns, not a recompute.  Shrink removes the highest-id
    members; every child of a removed task must keep at least one parent
    in the stage (all-to-all stage semantics), else ValueError.
    """
    base = dag_digest(dag)
    if not (0 <= stage < dag.n_stages) or len(dag.stages[stage]) == 0:
        raise ValueError(f"no such stage {stage}")
    ids = dag.stages[stage]
    q = len(ids)
    if new_q < 1:
        raise ValueError("a stage must keep at least one task")
    if new_q == q:
        raise ValueError("resize_stage: size unchanged")
    n = dag.n
    if new_q > q:
        k = new_q - q
        tmpl = int(ids[-1])
        pos = tmpl + 1                  # clones sit right after the template
        id_map = np.arange(n, dtype=np.int64)
        id_map[pos:] += k
        clone_ids = np.arange(pos, pos + k, dtype=np.int64)
        tmpl_kids = {int(c) for c in dag.children[tmpl]}
        parents: list[np.ndarray] = []
        for t in range(n):
            ps = id_map[dag.parents[t]]
            if t in tmpl_kids:          # children adopt every clone too
                ps = np.concatenate([ps, clone_ids])
            parents.insert(id_map[t], np.sort(ps))
            if t == tmpl:
                for _ in range(k):
                    parents.append(np.sort(id_map[dag.parents[tmpl]]))
        ins = np.full(k, pos, dtype=np.int64)
        new = DAG(
            duration=np.insert(dag.duration, ins, dag.duration[tmpl]),
            demand=np.insert(dag.demand, ins, dag.demand[tmpl], axis=0),
            stage_of=np.insert(dag.stage_of, ins, stage),
            parents=parents,
            name=dag.name,
        )
        if dag._anc_bits is not None:
            mat = _unpack(dag.anc_bits, n)
            mat = np.insert(mat, ins, mat[tmpl], axis=0)      # anc(clone)
            col = np.repeat(mat[:, tmpl][:, None], k, axis=1)
            mat = np.insert(mat, ins, col, axis=1)            # desc(clone)
            new._anc_bits = _repack(mat)
        touched = np.sort(np.concatenate(
            [clone_ids, id_map[sorted(tmpl_kids)]])) if tmpl_kids else clone_ids
        delta = DagDelta("resize_stage", base, dag_digest(new),
                         touched=np.asarray(touched, np.int64), id_map=id_map)
        return new, delta
    # shrink: drop the highest-id members
    drop = ids[new_q:]
    dropset = {int(t) for t in drop}
    keepset = {int(t) for t in ids[:new_q]}
    for r in drop:
        for c in dag.children[int(r)]:
            if not any(int(p) in keepset for p in dag.parents[int(c)]):
                raise ValueError(
                    f"shrinking stage {stage} would orphan task {int(c)} "
                    "from its stage dependency")
    keep = np.setdiff1d(np.arange(n), drop)
    id_map = np.full(n, -1, dtype=np.int64)
    id_map[keep] = np.arange(len(keep))
    parents = [
        np.sort(id_map[[p for p in dag.parents[int(t)] if int(p) not in dropset]])
        for t in keep
    ]
    new = DAG(
        duration=dag.duration[keep].copy(),
        demand=dag.demand[keep].copy(),
        stage_of=dag.stage_of[keep].copy(),
        parents=parents,
        name=dag.name,
    )
    if dag._anc_bits is not None:
        mat = _unpack(dag.anc_bits, n)
        new._anc_bits = _repack(mat[np.ix_(keep, keep)])
    kids = sorted({int(id_map[c]) for r in drop for c in dag.children[int(r)]
                   if id_map[c] >= 0})
    delta = DagDelta("resize_stage", base, dag_digest(new),
                     touched=np.asarray(kids, np.int64), id_map=id_map)
    return new, delta


def scale_durations(
    dag: DAG, scale: float, ids: Sequence[int] | None = None,
    kind: str = "scale_durations",
) -> tuple[DAG, DagDelta]:
    """Rescale task durations; structure and reachability carry over as-is."""
    if scale <= 0:
        raise ValueError("scale must be positive")
    base = dag_digest(dag)
    dur = dag.duration.copy()
    which = np.arange(dag.n) if ids is None else np.asarray(ids, np.int64)
    dur[which] = np.maximum(dur[which] * scale, 1e-9)
    new = DAG(duration=dur, demand=dag.demand.copy(),
              stage_of=dag.stage_of.copy(),
              parents=[p.copy() for p in dag.parents], name=dag.name)
    new._anc_bits = dag._anc_bits     # structure untouched: share closures
    new._desc_bits = dag._desc_bits
    delta = DagDelta(kind, base, dag_digest(new),
                     touched=np.sort(which.astype(np.int64)),
                     id_map=np.arange(dag.n, dtype=np.int64))
    return new, delta


def retarget_deadline(dag: DAG, factor: float) -> tuple[DAG, DagDelta]:
    """Deadline pull-in/push-out: durations are budget-relative, so moving
    the deadline by 1/factor rescales every duration by ``factor``."""
    return scale_durations(dag, factor, kind="retarget_deadline")


def scale_speeds(
    dag: DAG, factor: float, ids: Sequence[int] | None = None,
) -> tuple[DAG, DagDelta]:
    """Machine-fleet speed edit: durations are normalized machine-seconds,
    so a fleet running ``factor``x faster divides durations by it."""
    return scale_durations(dag, 1.0 / factor, ids, kind="scale_speeds")


def add_dependency(dag: DAG, parent: int, child: int) -> tuple[DAG, DagDelta]:
    """Add edge parent -> child.  ``parent < child`` is required: ids are
    topological, so a back-edge either closes a cycle outright or breaks
    the id-order invariant every consumer relies on — rejected."""
    base = dag_digest(dag)
    parent, child = int(parent), int(child)
    if not (0 <= parent < dag.n and 0 <= child < dag.n):
        raise ValueError("no such task")
    if parent >= child:
        raise ValueError(
            f"edge {parent}->{child} violates topological id order "
            "(would introduce a cycle)")
    if parent in dag.parents[child]:
        raise ValueError(f"edge {parent}->{child} already exists")
    parents = [p.copy() for p in dag.parents]
    parents[child] = np.sort(np.append(parents[child], parent))
    new = DAG(duration=dag.duration.copy(), demand=dag.demand.copy(),
              stage_of=dag.stage_of.copy(), parents=parents, name=dag.name)
    if dag._anc_bits is not None:
        # all new reachability passes through child: fold parent's closure
        # into child's row, then OR child's row into its descendants'
        anc = dag.anc_bits.copy()
        anc[child] |= anc[parent]
        anc[child, parent >> 6] |= np.uint64(1) << np.uint64(parent & 63)
        has_child = (anc[:, child >> 6] >> np.uint64(child & 63)) & np.uint64(1)
        rows = np.nonzero(has_child.astype(bool))[0]
        anc[rows] |= anc[child]
        new._anc_bits = anc
    delta = DagDelta("add_dependency", base, dag_digest(new),
                     touched=np.asarray([child], np.int64),
                     id_map=np.arange(dag.n, dtype=np.int64))
    return new, delta


def _bits_to_ids(bits: np.ndarray) -> np.ndarray:
    ids = []
    for w, word in enumerate(bits):
        word = int(word)
        while word:
            b = word & -word
            ids.append((w << 6) + b.bit_length() - 1)
            word ^= b
    return np.asarray(ids, dtype=np.int64)


def _bits_into_mask(bits: np.ndarray, mask: np.ndarray) -> None:
    n = len(mask)
    unpacked = np.unpackbits(bits.view(np.uint8), bitorder="little")
    mask |= unpacked[:n].astype(bool)


def dag_from_arrays(duration, demand, stage_of, parents,
                    name: str = "dag") -> DAG:
    """A DAG from another DAG's numpy fields (duration, demand, stage_of,
    parents, name) — how one job is handed between implementations that
    share this layout, with its content digest unchanged."""
    return DAG(np.array(duration, dtype=np.float64, copy=True),
               np.array(demand, dtype=np.float64, copy=True),
               np.array(stage_of, dtype=np.int64, copy=True),
               [np.array(p, dtype=np.int64, copy=True) for p in parents],
               name=str(name))


def from_stage_graph(
    stage_tasks: Sequence[int],
    stage_durations: Sequence[float],
    stage_demands: Sequence[Sequence[float]],
    stage_deps: Sequence[Sequence[int]],
    name: str = "dag",
    rng: np.random.Generator | None = None,
    duration_jitter: float = 0.0,
    demand_jitter: float = 0.0,
) -> DAG:
    """Expand a stage-level graph into a task-level DAG.

    Every task of stage s depends on *all* tasks of each parent stage
    (all-to-all shuffle semantics, the common case in data-parallel DAGs).
    """
    n_stages = len(stage_tasks)
    order = _topo_stage_order(stage_deps, n_stages)
    task_ids: list[np.ndarray] = [np.empty(0, np.int64)] * n_stages
    durations: list[float] = []
    demands: list[np.ndarray] = []
    stage_of: list[int] = []
    parents: list[np.ndarray] = []
    rng = rng or np.random.default_rng(0)
    next_id = 0
    for s in order:
        q = int(stage_tasks[s])
        ids = np.arange(next_id, next_id + q, dtype=np.int64)
        task_ids[s] = ids
        next_id += q
        par = np.concatenate([task_ids[p] for p in stage_deps[s]]) if stage_deps[s] else np.empty(0, np.int64)
        base_dur = float(stage_durations[s])
        base_dem = np.asarray(stage_demands[s], dtype=np.float64)
        for _ in range(q):
            dur = base_dur * (1.0 + duration_jitter * float(rng.standard_normal())) if duration_jitter else base_dur
            dem = base_dem * (1.0 + demand_jitter * rng.standard_normal(base_dem.shape)) if demand_jitter else base_dem
            durations.append(max(dur, 1e-3))
            demands.append(np.clip(dem, 1e-4, 1.0))
            stage_of.append(s)
            parents.append(np.sort(par))
    return DAG(
        duration=np.asarray(durations),
        demand=np.asarray(demands),
        stage_of=np.asarray(stage_of),
        parents=parents,
        name=name,
    )


def _topo_stage_order(stage_deps: Sequence[Sequence[int]], n: int) -> list[int]:
    state = [0] * n
    out: list[int] = []

    def visit(s: int) -> None:
        if state[s] == 2:
            return
        if state[s] == 1:
            raise ValueError("cycle in stage graph")
        state[s] = 1
        for p in stage_deps[s]:
            visit(int(p))
        state[s] = 2
        out.append(s)

    for s in range(n):
        visit(s)
    return out
