"""Offline schedule construction for one DAG (paper §4, Figs. 5-7).

BuildSchedule:
  1. CandidateTroublesomeTasks (§4.1): score tasks by LongScore (duration /
     max duration) and stages by FragScore (TWork / greedy execution time);
     sweep discriminative (l, f) thresholds; take the closure of each chosen
     set; split the DAG into subsets T (troublesome), P (parents), C
     (children), O (other).
  2. Place T first onto the virtual space, forward or backward, keep the
     more compact (§4.2).
  3. TrySubsetOrders (§4.3): the four dead-end-free orders
     T-OPC, T-OCP, T-COP, T-POC with the direction restrictions proved in
     Lemma 4 (P only backward, C only forward, O either).
  4. Keep the most compact schedule across all candidates; OrderTasks
     returns tasks sorted by start time, which the online component (§5)
     consumes as priScore.

All candidate (T-set, order, direction) variants are evaluated against ONE
shared Space through snapshot/restore (an undo log — O(cells written) per
variant, never a full grid clone), and the per-task fit queries go through
a pluggable placement backend (core/engine/): "reference" rescans the grid
per task, "batched" (default) answers whole ready-sets with one
(n_tasks, m, W) feasibility scan through the kernel-dispatch layer.

Cross-candidate reductions (all outcome-exact; parity suite locks them):

  * the order variants around a placed T run as a shared-prefix tree
    (``_try_orders``): each common (ids-prefix, direction) segment is
    placed once and branched via the Space undo log;
  * placement work is memoized across variants at pass and single-slot
    granularity (core/memo.py) — a segment or query re-reached on another
    branch replays its recorded outcome instead of searching; the
    windowed slot memo is content-addressed, so one memo serves every
    partitioned sub-build of a DAG (recurring pipelines hit across
    partitions);
  * candidate evaluation stops at a sound tick lower bound, and order
    subtrees whose dependency-chain bound already reaches the incumbent
    are skipped before any placement.

Disable the memo with ``build_schedule(..., memoize=False)`` or
``REPRO_BUILDER_MEMO=0`` (the parity tests diff both modes).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import os
from typing import Iterable

import numpy as np

from .dag import DAG, dag_digest
from .engine import (FORWARD, BACKWARD, PeerTask, PlacementBackend,
                     get_backend, kernels)
from .engine.base import ceil32
from .memo import COUNTERS, ConstructionMemo
from .space import Space

#: env var consulted when build_schedule is not given an explicit memoize
MEMO_ENV = "REPRO_BUILDER_MEMO"


def _memo_enabled(memoize: bool | None) -> bool:
    if memoize is not None:
        return memoize
    return os.environ.get(MEMO_ENV, "1") != "0"


@dataclasses.dataclass
class BuildInfo:
    """Provenance of one build: the inputs that parameterized it plus the
    per-partition results, content-keyed for delta rebuilds.

    ``parts`` maps (partition content digest, m, knobs) to the partition's
    relative build output.  ``_build_one`` derives its tick quantization
    from the *sub-DAG* horizon, so a digest-equal partition produces a
    bit-identical relative schedule no matter which enclosing DAG it came
    from — replaying a stored entry is exact, which is what
    ``build_schedule(..., reuse=prev)`` leans on after a graph mutation:
    untouched partitions replay, only dirty ones re-search.
    """

    m: int
    knobs: tuple             # (ticks, n_long, n_frag, max_candidates, use_partitions)
    parts: dict              # key -> (rel start, machine, tmask, makespan, tick)
    reused_parts: int = 0    # partitions replayed from ``reuse`` this build
    reused_tasks: int = 0    # task placements those partitions carried
    total_parts: int = 0


@dataclasses.dataclass
class Schedule:
    """A constructed schedule: placement of every task in the virtual space."""

    dag: DAG
    order: np.ndarray        # task ids sorted by start time
    start: np.ndarray        # (n,) start seconds (shifted so min == 0)
    machine: np.ndarray      # (n,) machine index in the virtual space
    makespan: float
    tick: float
    trouble_mask: np.ndarray | None = None
    label: str = "dagps"
    build_info: BuildInfo | None = None

    @property
    def pri_score(self) -> np.ndarray:
        """priScore in [0, 1]: 1 for the first task, ->0 for the last (§5)."""
        n = self.dag.n
        rank = np.empty(n, dtype=np.float64)
        rank[self.order] = np.arange(n)
        return 1.0 - rank / max(n, 1)

    def validate(self) -> None:
        """Dependencies respected and no over-commitment (test hook)."""
        d = self.dag
        end = self.start + d.duration
        for i in range(d.n):
            for p in d.parents[i]:
                if self.start[i] < end[p] - 1e-6 - self.tick:
                    raise AssertionError(f"dependency violated: {p} -> {i}")


# ----------------------------------------------------------------------
# Subset placement (Fig. 7)
# ----------------------------------------------------------------------

class _Placer:
    def __init__(self, dag: DAG, space: Space, dur_ticks: np.ndarray,
                 backend: PlacementBackend,
                 memo: ConstructionMemo | None = None):
        self.dag = dag
        self.space = space
        self.k = dur_ticks
        self.backend = backend
        self.memo = memo
        # structural tie-break: among equal durations, place tasks that
        # enable the most downstream work first (resolves Fig. 17's "red"
        # tasks, which are identical to their siblings except structurally).
        self.n_desc = np.array([len(dag.children[i]) for i in range(dag.n)])
        self.n_par = np.array([len(dag.parents[i]) for i in range(dag.n)])
        self.demand32 = ceil32(dag.demand)   # for float32-comparing sessions
        # demand rows as bytes, precomputed once: hint keys and memo keys
        # need them on every single placement
        self.vb64 = [row.tobytes() for row in dag.demand]
        self.vb32 = [row.tobytes() for row in self.demand32]
        # flat edge arrays: pending counts per pass become one bincount
        self.edge_child = np.concatenate(
            [np.full(len(p), i) for i, p in enumerate(dag.parents)]
        ).astype(np.int64) if dag.n else np.empty(0, np.int64)
        self.edge_parent = (np.concatenate(dag.parents).astype(np.int64)
                            if dag.n and len(self.edge_child) else np.empty(0, np.int64))
        self.placed_start = np.zeros(dag.n, dtype=np.int64)
        self.placed_end = np.zeros(dag.n, dtype=np.int64)
        self.machine = np.full(dag.n, -1, dtype=np.int64)
        self.is_placed = np.zeros(dag.n, dtype=bool)

    def branch(self) -> "_Placer":
        """Cheap variant copy: own task arrays, SHARED space (snapshot it)."""
        p = _Placer.__new__(_Placer)
        p.dag, p.k, p.backend = self.dag, self.k, self.backend
        p.memo = self.memo
        p.n_desc, p.n_par = self.n_desc, self.n_par
        p.demand32 = self.demand32
        p.vb64, p.vb32 = self.vb64, self.vb32
        p.edge_child, p.edge_parent = self.edge_child, self.edge_parent
        p.space = self.space
        p.placed_start = self.placed_start.copy()
        p.placed_end = self.placed_end.copy()
        p.machine = self.machine.copy()
        p.is_placed = self.is_placed.copy()
        return p

    def _save(self):
        return (self.placed_start.copy(), self.placed_end.copy(),
                self.machine.copy(), self.is_placed.copy())

    def _load(self, saved) -> None:
        self.placed_start, self.placed_end, self.machine, self.is_placed = (
            saved[0].copy(), saved[1].copy(), saved[2].copy(), saved[3].copy())

    def _commit(self, t: int, m: int, t0: int, check: bool = True) -> None:
        self.space.commit(t, m, t0, self.k[t], self.dag.demand[t], check)
        self.placed_start[t] = t0
        self.placed_end[t] = t0 + self.k[t]
        self.machine[t] = m
        self.is_placed[t] = True

    def _replay_commit(self, t: int, m: int, t0: int) -> None:
        """Re-commit a memoized placement: grow the grid to cover the slot,
        skip the over-commit guard (the original commit passed it against
        bit-identical window content)."""
        sp = self.space
        k = int(self.k[t])
        while t0 < sp.grid_start:
            sp._grow_front()
        while t0 + k > sp.grid_end:
            sp._grow_back()
        self._commit(t, m, t0, check=False)

    def _anchor(self, t: int, forward: bool) -> int:
        """Ready tick (forward) / deadline tick (backward) for one task.

        Unplaced parents *within the subset* gate readiness; parents outside
        the subset constrain the start only if already placed (see §4.3
        discussion of inter-subset dependencies).  Mirrored for backward.

        Scalar python loop on purpose: adjacency rows are short and this
        runs twice per commit, where numpy fancy-indexing overhead on
        10-element arrays dominates the actual work.
        """
        sp = self.space
        placed = self.is_placed
        if forward:
            best = None     # logical ticks may be negative: no -1 sentinel
            pe = self.placed_end
            for p in self.dag.parents[t]:
                if placed[p] and (best is None or pe[p] > best):
                    best = pe[p]
            if best is not None:
                return int(best)
            return sp._min_start if sp._min_start is not None else 0
        best = None
        ps = self.placed_start
        for c in self.dag.children[t]:
            if placed[c] and (best is None or ps[c] < best):
                best = ps[c]
        if best is not None:
            return int(best)
        if sp._max_end is not None:
            # unanchored task: pack against the occupied region instead of
            # drifting to the far end of the grid.
            return int(sp._max_end)
        return sp.grid_end  # logical end of the empty grid

    def ready_peers(self, ids: np.ndarray, direction: str,
                    cap: int = 24) -> list[PeerTask]:
        """Initial ready set of a pass as PeerTask prefetch hints.

        Used by the multi-variant node prescan (``PlacementBackend.
        sessions``): anchors are the same estimates ``place_pass`` itself
        announces, so prescanned bitmaps are hints only and can never
        change a placement result.
        """
        dag = self.dag
        forward = direction == FORWARD
        if len(ids) == 0:
            return []
        in_subset = np.zeros(dag.n, dtype=bool)
        in_subset[ids] = True
        adj_gate = dag.parents if forward else dag.children
        ready = [int(i) for i in ids if not in_subset[adj_gate[i]].any()]
        ready.sort(key=lambda i: (-dag.duration[i],
                                  -(self.n_desc if forward else self.n_par)[i], i))
        demand = self.demand32
        return [PeerTask(i, self._anchor(i, forward), demand[i], int(self.k[i]))
                for i in ready[:cap]]

    def place_pass(self, ids: np.ndarray, direction: str,
                   limit: int | None = None, sess=None) -> bool:
        """PlaceTasksF / PlaceTasksB: dependency order within the subset,
        longest task first, each task at its extreme feasible slot.

        ``limit`` prunes exactly: the occupied span only ever grows, so
        once it reaches the incumbent best the variant can never win and
        the pass aborts (the caller rolls the space back either way).  The
        derived per-placement ``cap`` lets a session stop searching early
        once every admissible slot is provably past the bound (see
        PlacementSession.place).

        ``sess`` injects a pre-seeded session (multi-variant node prescan);
        the memo layers consult core/memo.py before touching the session —
        a whole-segment hit replays the recorded plan with zero searches,
        a single-slot hit skips just that query.
        """
        dag, sp = self.dag, self.space
        memo = self.memo
        pass_key = None
        if memo is not None:
            pass_key = memo.pass_key(ids, direction)
            hit = memo.pass_get(pass_key)
            if hit is not None:
                span, plan = hit
                COUNTERS.add("passes_replayed")
                if limit is not None and span >= limit:
                    return False   # the live pass would abort mid-way
                for t, m, t0 in plan:   # replay is commit-only: no searches
                    self._replay_commit(t, m, t0)
                return True
        COUNTERS.add("passes_run")
        n_before = len(sp.placements)
        forward = direction == FORWARD
        in_subset = np.zeros(dag.n, dtype=bool)
        in_subset[ids] = True
        adj_open = dag.children if forward else dag.parents
        # pending in-subset gate-neighbors per task, as one bincount over
        # the flat edge list (parents gate forward passes, children gate
        # backward ones)
        ev, ew = ((self.edge_parent, self.edge_child) if forward
                  else (self.edge_child, self.edge_parent))
        pending = np.bincount(ew[in_subset[ev]], minlength=dag.n) \
            if len(ev) else np.zeros(dag.n, dtype=np.int64)
        tie = self.n_desc if forward else self.n_par
        dur = dag.duration
        # min-heap pops in the same (-duration, -tie, id) order the sorted
        # ready list did
        heap = [(-dur[i], -tie[i], int(i)) for i in ids if pending[i] == 0]
        heapq.heapify(heap)
        remaining = len(ids)
        if sess is None or sess.direction != direction:
            sess = self.backend.session(sp, direction)
        if sess.wants_f32:
            demand, vbytes = self.demand32, self.vb32
        else:
            demand, vbytes = dag.demand, self.vb64
        peers_fn = None
        est: dict[int, int] = {}
        if sess.wants_peers:
            # estimated anchors for prefetch (exact for anchored tasks; the
            # session re-clips against the real pop-time anchor regardless)
            est = {e[2]: self._anchor(e[2], forward) for e in heap}

            def peers_fn():
                return [PeerTask(e[2], est[e[2]], demand[e[2]], int(self.k[e[2]]))
                        for e in heap[:24]]
        while remaining:
            if not heap:
                return False  # cycle — cannot happen on a valid DAG
            t = heapq.heappop(heap)[2]
            anchor = self._anchor(t, forward)
            k = int(self.k[t])
            cap = None
            if limit is not None:
                # the exact start bound past which the new span >= limit
                if forward and sp._min_start is not None:
                    cap = limit + sp._min_start - k
                elif not forward and sp._max_end is not None:
                    cap = sp._max_end - limit
            vb = vbytes[t]
            hit = memo.place_get(direction, vb, k, anchor) if memo is not None else None
            if hit is not None:
                m, t0 = hit
                self._replay_commit(t, m, t0)
            else:
                COUNTERS.add("places_evaluated")
                key = (int(dag.stage_of[t]), float(anchor), self.vb64[t])
                m, t0 = sess.place(t, demand[t], k, anchor, key, peers_fn, cap)
                if memo is not None and m >= 0:
                    memo.place_put(direction, vb, k, anchor, forward, m, t0)
                if m < 0:
                    return False  # session proved the variant cannot win
                self._commit(t, m, t0)
            if limit is not None and sp.makespan_ticks >= limit:
                return False  # span is monotone: this variant cannot win
            remaining -= 1
            for c in adj_open[t]:
                if in_subset[c]:
                    pending[c] -= 1
                    if pending[c] == 0:
                        c = int(c)
                        if sess.wants_peers:
                            est[c] = self._anchor(c, forward)
                        heapq.heappush(heap, (-dur[c], -tie[c], c))
        if memo is not None:
            plan = [(p.task, p.machine, p.start)
                    for p in sp.placements[n_before:]]
            memo.pass_put(pass_key, sp.makespan_ticks, plan)
        return True

    # kept as thin aliases for readability at call sites / tests
    def place_forward(self, ids: np.ndarray, limit: int | None = None,
                      sess=None) -> bool:
        return self.place_pass(ids, FORWARD, limit, sess)

    def place_backward(self, ids: np.ndarray, limit: int | None = None,
                       sess=None) -> bool:
        return self.place_pass(ids, BACKWARD, limit, sess)

    def place_best(self, ids: np.ndarray, limit: int | None = None,
                   sess=None) -> bool:
        """PlaceTasks: min(forward, backward) by resulting span (Fig. 7 l.13).

        Tries both directions against the shared space (rolling back in
        between) and replays the winner's commits — no grid clone.  An
        aborted direction's true span provably exceeds ``limit``, so a
        completed direction always beats it and pruning stays exact.  The
        backward attempt runs under min(limit, forward span): forward wins
        ties, so backward only matters when strictly more compact.
        """
        if len(ids) == 0:
            return True
        sp = self.space
        snap = sp.snapshot()
        saved = self._save()
        okf = self.place_forward(ids, limit, sess)
        span_f = sp.makespan_ticks
        plan_f = [(p.task, p.machine, p.start)
                  for p in sp.placements[snap.n_placed:]] if okf else []
        # keep any growth: the forward plan may be replayed into it below
        sp.restore(snap, keep_extent=True)
        self._load(saved)
        blim = limit if not okf else \
            (span_f if limit is None else min(limit, span_f))
        okb = self.place_backward(ids, blim)
        if okf and (not okb or span_f <= sp.makespan_ticks):
            sp.restore(snap, keep_extent=True)
            self._load(saved)
            for t, m, t0 in plan_f:  # replay is commit-only: no searches
                self._commit(t, m, t0, check=False)
            return True
        return okb


# ----------------------------------------------------------------------
# Troublesome-task search (Fig. 6)
# ----------------------------------------------------------------------

def frag_scores(dag: DAG, m: int) -> np.ndarray:
    """FragScore per stage = TWork(s) / ExecutionTime(s) under greedy packing.

    Tasks of one stage are identical-ish and independent, so greedy packing
    runs them in waves: per machine, c = how many copies fit side by side.
    """
    out = np.ones(dag.n_stages, dtype=np.float64)
    for s, ids in enumerate(dag.stages):
        if len(ids) == 0:
            continue
        dur = float(dag.duration[ids].mean())
        dem = dag.demand[ids].mean(axis=0)
        peak = float(dem.max())
        if peak <= 0 or dur <= 0:
            continue
        per_machine = max(int(1.0 / max(peak, 1e-9) + 1e-9), 1)
        waves = math.ceil(len(ids) / (m * per_machine))
        exec_time = waves * dur
        twork = len(ids) * dur * peak / m
        out[s] = min(twork / exec_time, 1.0)
    return out


def candidate_troublesome(
    dag: DAG,
    m: int,
    n_long: int = 8,
    n_frag: int = 6,
    max_candidates: int = 24,
) -> list[np.ndarray]:
    """Enumerate closed candidate sets T (deduplicated, |candidates| capped)."""
    long_score = dag.duration / max(float(dag.duration.max()), 1e-12)
    frag = frag_scores(dag, m)[dag.stage_of]

    def _levels(vals: np.ndarray, k: int) -> np.ndarray:
        u = np.unique(vals)
        if len(u) <= k:
            return u
        qs = np.quantile(u, np.linspace(0, 1, k))
        return np.unique(qs)

    ls = _levels(long_score, n_long)
    fs = _levels(frag, n_frag)
    seen: set[bytes] = set()
    cands: list[np.ndarray] = []
    # T = empty => plain greedy packing of the whole DAG; always considered
    # so DAGPS can never lose to its own packer.
    empty = np.zeros(dag.n, dtype=bool)
    seen.add(empty.tobytes())
    cands.append(empty)
    pairs = [(l, f) for l in ls[::-1] for f in fs]
    # also pure-long and pure-frag sweeps
    pairs += [(l, -1.0) for l in ls[::-1]] + [(2.0, f) for f in fs]
    for l, f in pairs:
        t_mask = (long_score >= l) | (frag <= f)
        if not t_mask.any():
            continue
        t_mask = dag.closure_mask(t_mask)
        key = t_mask.tobytes()
        if key in seen:
            continue
        seen.add(key)
        cands.append(t_mask)
    if len(cands) > max_candidates:
        # keep a spread of candidate sizes (plus the empty set)
        sizes = np.array([c.sum() for c in cands])
        order = np.argsort(sizes, kind="stable")
        picks = order[np.unique(np.linspace(0, len(order) - 1, max_candidates).astype(int))]
        cands = [cands[i] for i in sorted(picks)]
    return cands


# ----------------------------------------------------------------------
# BuildSchedule (Fig. 5)
# ----------------------------------------------------------------------

def build_schedule(
    dag: DAG,
    m: int,
    ticks: int = 256,
    n_long: int = 8,
    n_frag: int = 6,
    max_candidates: int = 24,
    use_partitions: bool = True,
    backend: str | PlacementBackend | None = None,
    memoize: bool | None = None,
    reuse: "Schedule | dict | None" = None,
    device: str = "cuda",
) -> Schedule:
    """Construct DAGPS's preferred schedule for one DAG on m machines.

    `backend` selects the placement engine ("reference" | "batched");
    None resolves REPRO_PLACEMENT_BACKEND, defaulting to "batched".
    `device` is where the feasibility-scan kernel runs: "cuda" (the
    default; raises without a card) or "cpu" (its plain torch version).
    All backends produce tick-identical schedules.  `memoize` toggles the
    cross-candidate construction memo (None resolves REPRO_BUILDER_MEMO,
    default on), which is shared across the partitioned sub-builds of the
    DAG; memoized and plain builds are bit-identical.

    `reuse` seeds a *delta rebuild*: pass a previous `Schedule` (or its
    ``build_info.parts`` map) and any partition whose content digest,
    machine count and knobs match a stored entry replays that entry
    instead of re-searching — bit-identical to a full build, because a
    partition's relative schedule is a pure function of exactly that key
    (see `BuildInfo`).  After a graph mutation only the partitions the
    edit touched miss; `rebuild_schedule` wraps this for the common case.
    """
    with kernels.use_device(device):
        return _build_schedule(dag, m, ticks, n_long, n_frag, max_candidates,
                               use_partitions, backend, memoize, reuse)


def _build_schedule(dag, m, ticks, n_long, n_frag, max_candidates,
                    use_partitions, backend, memoize, reuse) -> Schedule:
    if dag.n == 0:
        return Schedule(dag, np.empty(0, np.int64), np.empty(0), np.empty(0, np.int64), 0.0, 1.0)
    be = get_backend(backend)
    # one memo for the whole build: the windowed place memo is content-
    # addressed (core/memo.py), so it carries across the partitioned
    # sub-builds of one DAG — each partition re-attaches it to its Space.
    memo = ConstructionMemo() if _memo_enabled(memoize) else None
    knobs = (int(ticks), int(n_long), int(n_frag), int(max_candidates),
             bool(use_partitions))
    prev_parts = reuse.build_info.parts if isinstance(reuse, Schedule) \
        and reuse.build_info is not None else (reuse if isinstance(reuse, dict)
                                               else None)
    if use_partitions:
        parts = partition_totally_ordered(dag)
        if len(parts) > 1 or prev_parts:
            return _concat_partition_schedules(dag, parts, m, knobs, be,
                                               memo, prev_parts)
    sched = _build_one(dag, m, ticks, n_long, n_frag, max_candidates, be,
                       memo)
    key = _part_key(_subdag(dag, np.arange(dag.n)), m, knobs)
    sched.build_info = BuildInfo(
        m, knobs, {key: _part_entry(sched)}, 0, 0, 1)
    return sched


def _part_key(sub: DAG, m: int, knobs: tuple) -> tuple:
    """Content key of one partition build: digest + machine count + knobs.

    The placement backend and the memo toggle are deliberately NOT part
    of the key — all backends are tick-identical and memoized builds are
    bit-identical to plain ones (both invariants locked by the parity
    suites), so entries recorded under any configuration replay exactly.
    """
    return (dag_digest(sub), int(m)) + knobs


def _part_entry(sched: Schedule) -> tuple:
    return (sched.start, sched.machine, sched.trouble_mask, sched.makespan,
            sched.tick)


def rebuild_schedule(
    prev: Schedule,
    dag: DAG,
    backend: str | PlacementBackend | None = None,
    memoize: bool | None = None,
    check_parity: bool = False,
    device: str = "cuda",
    **overrides,
) -> Schedule:
    """Delta rebuild after a graph mutation: same knobs as ``prev``,
    replaying every partition the edit did not touch.

    ``check_parity=True`` (or env REPRO_DELTA_PARITY=1) runs the bit-
    parity oracle: a from-scratch build of the mutated DAG must agree
    with the delta rebuild on every array, bit for bit.
    """
    info = prev.build_info
    if info is None:
        raise ValueError("previous schedule has no build_info to reuse")
    kw = dict(ticks=info.knobs[0], n_long=info.knobs[1], n_frag=info.knobs[2],
              max_candidates=info.knobs[3], use_partitions=info.knobs[4])
    m = overrides.pop("m", info.m)
    kw.update(overrides)
    sched = build_schedule(dag, m, backend=backend, memoize=memoize,
                           reuse=prev, device=device, **kw)
    if check_parity or os.environ.get("REPRO_DELTA_PARITY", "0") == "1":
        full = build_schedule(dag, m, backend=backend, memoize=memoize,
                              device=device, **kw)
        assert_schedules_equal(sched, full)
    return sched


def assert_schedules_equal(a: Schedule, b: Schedule) -> None:
    """Bit-parity oracle: every decision array identical, not just close."""
    assert (a.order == b.order).all(), "order diverged"
    assert (a.start == b.start).all(), "start times diverged"
    assert (a.machine == b.machine).all(), "machine assignment diverged"
    assert repr(a.makespan) == repr(b.makespan), (a.makespan, b.makespan)
    assert repr(a.tick) == repr(b.tick), (a.tick, b.tick)


def _span_lb_ticks(dag: DAG, m: int, dur_ticks: np.ndarray) -> int:
    """Sound tick lower bound on ANY schedule the builder can construct.

    Critical path in *rounded* ticks (chain tasks occupy disjoint tick
    ranges in the space) and per-dim total work over m unit-capacity
    machines.  Once the incumbent reaches this bound no later candidate
    can be strictly more compact, so the search may stop (``consider``
    replaces on strict < only, which also keeps tie-breaking exact).
    """
    n = dag.n
    finish = np.zeros(n, dtype=np.int64)
    for i in range(n):   # DAG guarantees topological index order
        ps = dag.parents[i]
        finish[i] = (finish[ps].max() if len(ps) else 0) + dur_ticks[i]
    cp = int(finish.max()) if n else 0
    work = (dur_ticks[:, None] * dag.demand).sum(axis=0)
    wb = int(np.ceil(work.max() / max(m, 1) - 1e-12)) if n else 0
    return max(cp, wb)


_INF = 1 << 60


def _span_bound(pl: _Placer) -> int:
    """Sound LB on the final span of any COMPLETED variant continuing
    from ``pl``'s partial placement.

    Every completed variant places all remaining tasks with dependencies
    holding as tick inequalities (parent end <= child start — the §4.3
    dead-end-free invariant), so chains rooted at already-placed tasks
    bound the final extent: a placed parent's end plus the longest k-chain
    below it must fit under max_end', and min_start' can only decrease.
    Unrooted chains bound the span directly.  If the bound reaches the
    incumbent, the whole subtree of order variants under this prefix is
    skipped — outcome-exact, since a completed variant's span would be
    >= the incumbent and ``consider`` replaces on strict < only (a live
    evaluation would have aborted on the monotone-span limit instead).
    """
    dag, sp = pl.dag, pl.space
    placed = pl.is_placed
    span_cur = sp.makespan_ticks
    if placed.all():
        return span_cur
    k = pl.k
    pe, ps_ = pl.placed_end, pl.placed_start
    parents, children = dag.parents, dag.children
    n = dag.n
    # forward sweep: finish-time LBs; rooted[i] iff the chain passes
    # through a placed task (only rooted chains bound absolute extents)
    fin = np.zeros(n, dtype=np.int64)
    rooted = np.zeros(n, dtype=bool)
    for i in range(n):
        if placed[i]:
            continue
        b, r = 0, False
        for p in parents[i]:
            v = pe[p] if placed[p] else fin[p]
            if v > b:
                b, r = v, bool(placed[p] or rooted[p])
            elif v == b and (placed[p] or rooted[p]):
                r = True
        fin[i] = b + k[i]
        rooted[i] = r
    top_rooted = 0
    pure = 0
    for i in range(n):
        if placed[i]:
            continue
        if rooted[i]:
            if fin[i] > top_rooted:
                top_rooted = fin[i]
        elif fin[i] > pure:
            pure = fin[i]
    bound = max(span_cur, pure)
    mn, mx = sp._min_start, sp._max_end
    if top_rooted and mn is not None:
        bound = max(bound, top_rooted - mn)
    # backward sweep: start-time UBs rooted at placed children
    if mx is not None:
        start_ub = np.full(n, _INF, dtype=np.int64)
        low = _INF
        for i in range(n - 1, -1, -1):
            if placed[i]:
                continue
            b = _INF
            for c in children[i]:
                v = ps_[c] if placed[c] else start_ub[c]
                if v < b:
                    b = v
            if b < _INF:
                start_ub[i] = b - k[i]
                if start_ub[i] < low:
                    low = start_ub[i]
        if low < _INF:
            bound = max(bound, mx - low)
    return bound


def _build_one(dag, m, ticks, n_long, n_frag, max_candidates, backend,
               memo=None) -> Schedule:
    from .bounds import cp_length, t_work  # local import, no cycle at module load

    horizon = max(cp_length(dag), t_work(dag, m))
    tick = max(horizon / ticks, 1e-9)
    dur_ticks = np.maximum(np.ceil(dag.duration / tick - 1e-9).astype(np.int64), 1)
    grid = int(dur_ticks.sum() / max(m, 1) + dur_ticks.max()) + 4
    grid = max(grid, int(1.25 * horizon / tick) + 4)

    # one shared space for every candidate variant: each (T-set, order,
    # direction) evaluation runs against a snapshot and is rolled back,
    # so variant cost is O(cells written), never O(grid) cloning.
    space = Space(m, dag.d, grid, tick)
    if memo is not None:
        memo.attach(space)
    lb = _span_lb_ticks(dag, m, dur_ticks)
    best_span: int | None = None
    best_state: tuple[np.ndarray, np.ndarray] | None = None
    best_mask: np.ndarray | None = None
    # adaptive gate for the chain-bound pruner: on work-dominated DAGs the
    # bound never reaches the incumbent, so after a few dry candidates the
    # O(n + e) sweeps stop (a perf-only choice — skipping a *computation*
    # of an exact pruner cannot change the search outcome)
    bound_gate = {"tries": 0, "hits": 0}
    cands = candidate_troublesome(dag, m, n_long, n_frag, max_candidates)
    for ci, t_mask in enumerate(cands):
        if best_span is not None and best_span <= lb:
            # the incumbent is provably unbeatable (strict-< consider)
            COUNTERS.add("candidates_lb_skipped", len(cands) - ci)
            break
        t_mask, o_mask, p_mask, c_mask = dag.split_subsets(t_mask)
        t_ids, o_ids = np.nonzero(t_mask)[0], np.nonzero(o_mask)[0]
        p_ids, c_ids = np.nonzero(p_mask)[0], np.nonzero(c_mask)[0]

        snap_cand = space.snapshot()
        base = _Placer(dag, space, dur_ticks, backend, memo)
        if base.place_best(t_ids, best_span):  # trouble goes first (Fig. 5 l.7)
            best_span, best_state, best_mask = _try_orders(
                space, base, o_ids, p_ids, c_ids, t_mask,
                best_span, best_state, best_mask, lb, bound_gate)
        space.restore(snap_cand)
    assert best_state is not None
    return _to_schedule(dag, best_state[0], best_state[1], tick, best_mask,
                        label="dagps")


#: segment ops: how one prefix-tree edge places its id set
_SEG_BEST, _SEG_FWD, _SEG_BWD = "best", "fwd", "bwd"


def _variant_tree(o_ids, p_ids, c_ids):
    """The four dead-end-free orders (Fig. 7 l.19-23) as a shared-prefix
    tree of (op, ids) placement segments.

    Exact-outcome normalizations before the trie is built:
      * empty segments are dropped (placing nothing is the identity);
      * sequences that coincide after dropping are deduplicated — e.g.
        with P empty, T-OPC and T-OCP are the same variant;
      * with P and C both empty every order degenerates to placing O, and
        place_best(O) already covers both directions, so one sequence
        remains.
    The trie preserves the paper's enumeration order, which ``consider``'s
    strict-< tie-breaking depends on.
    """
    segs = {
        "O": (_SEG_BEST, o_ids),       # either direction (Lemma 4)
        "P": (_SEG_BWD, p_ids),        # parents only backward
        "C": (_SEG_FWD, c_ids),        # children only forward
        "Ob": (_SEG_BWD, o_ids),
        "Of": (_SEG_FWD, o_ids),
    }
    orders = [
        ["O", "P", "C"],               # T-OPC (l.20)
        ["O", "C", "P"],               # T-OCP (l.21)
        ["C", "Ob", "P"],              # T-COP (l.22)
        ["P", "Of", "C"],              # T-POC (l.23)
    ]
    if len(p_ids) == 0 and len(c_ids) == 0:
        orders = [["O"]]
    seen: list[tuple] = []
    tree: dict = {}
    for order in orders:
        seq = tuple(s for s in order if len(segs[s][1]))
        if seq in seen:
            continue
        seen.append(seq)
        node = tree
        for s in seq:
            node = node.setdefault(s, {})
    return segs, tree


def _try_orders(space, base, o_ids, p_ids, c_ids, t_mask,
                best_span, best_state, best_mask, lb=None, bound_gate=None):
    """TrySubsetOrders around a placed T, as a shared-prefix-tree DFS.

    Each trie edge places one (ids, direction) segment; shared prefixes
    (e.g. the place_best(O) prefix of T-OPC/T-OCP) are placed once and
    branched through the Space undo log.  At every branch node:

      * the subtree is skipped when the dependency-chain bound of the
        prefix already reaches the incumbent (``_span_bound``) or the
        incumbent sits at the tick lower bound — both outcome-exact;
      * sibling segments' initial feasibility scans are stacked into one
        multi-variant backend pass (``PlacementBackend.sessions``).
    """
    def consider(pl):
        nonlocal best_span, best_state, best_mask
        span = space.makespan_ticks
        if best_span is None or span < best_span:
            best_span = span
            best_state = (pl.placed_start.copy(), pl.machine.copy())
            best_mask = t_mask

    segs, tree = _variant_tree(o_ids, p_ids, c_ids)

    def descend(pl, node):
        nonlocal best_span
        if not node:
            consider(pl)
            return
        bound = None
        kids = list(node.items())
        sessions = [None] * len(kids)
        if len(kids) > 1 and pl.backend.wants_prescan:
            # one stacked (n_variants, n_tasks, m, W) prescan for all
            # sibling first-segments off this node's shared grid state
            specs = []
            for name, _child in kids:
                op, ids = segs[name]
                d = BACKWARD if op == _SEG_BWD else FORWARD
                specs.append((d, pl.ready_peers(ids, d)))
            sessions = pl.backend.sessions(space, specs)
        gate_open = bound_gate is None or bound_gate["hits"] > 0 \
            or bound_gate["tries"] < 6
        for j, (name, child) in enumerate(kids):
            if best_span is not None:
                if lb is not None and best_span <= lb:
                    break
                if bound is None and gate_open:
                    bound = _span_bound(pl)
                    if bound_gate is not None:
                        bound_gate["tries"] += 1
                if bound is not None and bound >= best_span:
                    if bound_gate is not None:
                        bound_gate["hits"] += 1
                    # every remaining sibling subtree is abandoned (same
                    # all-skipped semantics as candidates_lb_skipped)
                    COUNTERS.add("variants_bound_skipped", len(kids) - j)
                    break
            op, ids = segs[name]
            snap = space.snapshot()
            pl2 = pl.branch()
            if op == _SEG_BEST:
                ok = pl2.place_best(ids, best_span, sessions[j])
            elif op == _SEG_FWD:
                ok = pl2.place_forward(ids, best_span, sessions[j])
            else:
                ok = pl2.place_backward(ids, best_span, sessions[j])
            if ok:
                descend(pl2, child)
            space.restore(snap)

    descend(base, tree)
    return best_span, best_state, best_mask


def _to_schedule(dag: DAG, placed_start: np.ndarray, machine: np.ndarray,
                 tick: float, t_mask, label: str) -> Schedule:
    start_ticks = placed_start.astype(np.float64)
    start_ticks -= start_ticks.min()
    start = start_ticks * tick
    order = np.lexsort((np.arange(dag.n), start))
    makespan = float((start + dag.duration).max() - start.min())
    return Schedule(
        dag=dag, order=order, start=start, machine=machine,
        makespan=makespan, tick=tick, trouble_mask=t_mask, label=label,
    )


# ----------------------------------------------------------------------
# §4.4 enhancement: split at barriers into totally ordered parts
# ----------------------------------------------------------------------

def partition_totally_ordered(dag: DAG) -> list[np.ndarray]:
    """Split V into V1..Vk where every task of Vi precedes all of Vi+1.

    A cut after topological prefix [0..i] is valid iff [0..i] ⊆ anc(j) for
    every j > i, i.e. the suffix-AND of ancestor bitsets from i+1 on contains
    the full prefix.  Computed vectorized in O(n * n/8) bytes.
    """
    n = dag.n
    if n <= 1:
        return [np.arange(n)]
    anc = np.unpackbits(dag.anc_bits.view(np.uint8), axis=1, bitorder="little")[:, :n]
    # suffix_and[i] = AND of anc rows i+1..n-1
    suffix = np.minimum.accumulate(anc[::-1], axis=0)[::-1]
    cuts = []
    for i in range(n - 1):
        if suffix[i + 1, : i + 1].all():
            cuts.append(i)
    parts = []
    prev = 0
    for c in cuts:
        parts.append(np.arange(prev, c + 1))
        prev = c + 1
    parts.append(np.arange(prev, n))
    return parts


def _concat_partition_schedules(dag, parts, m, knobs, backend,
                                memo=None, prev_parts=None) -> Schedule:
    ticks, n_long, n_frag, max_candidates, _ = knobs
    start = np.zeros(dag.n, dtype=np.float64)
    machine = np.zeros(dag.n, dtype=np.int64)
    offset = 0.0
    tick = None
    tmask = np.zeros(dag.n, dtype=bool)
    out_parts: dict = {}
    reused_parts = reused_tasks = 0
    for ids in parts:
        sub = _subdag(dag, ids)
        key = _part_key(sub, m, knobs)
        entry = prev_parts.get(key) if prev_parts else None
        if entry is None:
            sched = _build_one(sub, m, ticks, n_long, n_frag,
                               max_candidates, backend, memo)
            entry = _part_entry(sched)
        else:
            # untouched partition: replay the stored relative schedule
            reused_parts += 1
            reused_tasks += len(ids)
            COUNTERS.add("parts_reused")
            COUNTERS.add("placements_reused", len(ids))
        p_start, p_machine, p_tmask, p_makespan, p_tick = entry
        start[ids] = p_start + offset
        machine[ids] = p_machine
        if p_tmask is not None:
            tmask[ids] = p_tmask
        offset += p_makespan
        tick = p_tick if tick is None else max(tick, p_tick)
        out_parts[key] = entry
    order = np.lexsort((np.arange(dag.n), start))
    makespan = float((start + dag.duration).max() - start.min())
    out = Schedule(dag, order, start, machine, makespan, tick or 1.0,
                   trouble_mask=tmask, label="dagps")
    out.build_info = BuildInfo(m, knobs, out_parts, reused_parts,
                               reused_tasks, len(parts))
    return out


def _subdag(dag: DAG, ids: np.ndarray) -> DAG:
    remap = {int(t): k for k, t in enumerate(ids)}
    idset = set(remap)
    parents = [
        np.asarray(sorted(remap[int(p)] for p in dag.parents[int(t)] if int(p) in idset),
                   dtype=np.int64)
        for t in ids
    ]
    stages = dag.stage_of[ids]
    _, stage_renum = np.unique(stages, return_inverse=True)
    return DAG(
        duration=dag.duration[ids].copy(),
        demand=dag.demand[ids].copy(),
        stage_of=stage_renum,
        parents=parents,
        name=f"{dag.name}[part]",
    )
