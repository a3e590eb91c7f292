"""Baseline DAG schedulers + a common work-conserving executor (paper §8.1).

Experimental baselines:
  * bfs      — breadth-first stage order (Tez default)
  * cp       — critical-path-length priority (CPSched)
  * random   — random static priority
  * tetris   — multi-resource packing score (dot product), dependency-blind
  * cg       — Coffman-Graham labeling
  * strippart— level decomposition, levels run as barriers (StripPart [20])
  * dagps    — priScore order from the constructed schedule, softly combined
               with the packing score (the single-job slice of §5)

All of these run through `simulate_execution`, an event-driven,
work-conserving list-scheduling executor over m machines with d-resource
capacity — so comparisons measure the *order quality*, exactly as in Fig. 12.
Fit tests and packing scores go through `engine.packing`, the same kernels
the online matcher and the cluster simulator use.
"""

from __future__ import annotations

import heapq
from typing import Callable, Sequence

import numpy as np

from .dag import DAG
from .engine import packing


# ----------------------------------------------------------------------
# Static orders
# ----------------------------------------------------------------------

def bfs_order(dag: DAG) -> np.ndarray:
    """Breadth-first: by depth from sources, then stage, then id (Tez)."""
    depth = np.zeros(dag.n, dtype=np.int64)
    for i in range(dag.n):
        ps = dag.parents[i]
        depth[i] = (depth[ps].max() + 1) if len(ps) else 0
    return np.lexsort((np.arange(dag.n), dag.stage_of, depth))


def cp_order(dag: DAG) -> np.ndarray:
    """Critical-path scheduling: longest path to a sink first."""
    cp = critical_path_to_sink(dag)
    return np.lexsort((np.arange(dag.n), -cp))


def critical_path_to_sink(dag: DAG) -> np.ndarray:
    cp = np.zeros(dag.n, dtype=np.float64)
    for i in range(dag.n - 1, -1, -1):
        ch = dag.children[i]
        cp[i] = dag.duration[i] + (cp[ch].max() if len(ch) else 0.0)
    return cp


def random_order(dag: DAG, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(dag.n)


def cg_order(dag: DAG) -> np.ndarray:
    """Coffman-Graham labeling, generalized to arbitrary DAGs.

    Labels are assigned from 1 upward to tasks whose successors are all
    labeled, choosing the task whose decreasing sequence of successor labels
    is lexicographically smallest.  Execution priority = label descending.
    """
    n = dag.n
    label = np.zeros(n, dtype=np.int64)
    unlabeled_children = np.array([len(dag.children[i]) for i in range(n)])
    ready = [i for i in range(n) if unlabeled_children[i] == 0]
    next_label = 1
    while ready:
        def key(i: int):
            ls = sorted((int(label[c]) for c in dag.children[i]), reverse=True)
            return (ls, i)
        ready.sort(key=key)
        t = ready.pop(0)
        label[t] = next_label
        next_label += 1
        for p in dag.parents[t]:
            unlabeled_children[p] -= 1
            if unlabeled_children[p] == 0:
                ready.append(int(p))
    return np.lexsort((np.arange(n), -label))


# ----------------------------------------------------------------------
# Work-conserving executor
# ----------------------------------------------------------------------

def simulate_execution(
    dag: DAG,
    m: int,
    order: Sequence[int] | None = None,
    policy: str = "priority",
    pri_score: np.ndarray | None = None,
    fit_dims: Sequence[int] | None = None,
    barrier_levels: np.ndarray | None = None,
) -> float:
    """Event-driven list scheduling of one DAG on m machines.

    policy:
      * "priority" — start runnable tasks in static `order`, skipping tasks
        that do not fit (work-conserving).
      * "tetris"   — dynamic: among runnable+fitting tasks pick the max
        dot(demand, available) (Tetris's packing score).
      * "dagps"    — score = priScore * dot(demand, avail): softly follow
        the constructed schedule while packing (§5 single-job slice).
    barrier_levels: if given, a task may start only when all tasks of lower
      levels have finished (StripPart semantics — not work-conserving).
    """
    n = dag.n
    if n == 0:
        return 0.0
    fit = np.asarray(fit_dims if fit_dims is not None else range(dag.d))
    avail = np.ones((m, dag.d), dtype=np.float64)
    pending_parents = np.array([len(dag.parents[i]) for i in range(n)])
    runnable: set[int] = {i for i in range(n) if pending_parents[i] == 0}
    prio = np.zeros(n)
    if order is not None:
        prio[np.asarray(order)] = np.arange(n)
    done = np.zeros(n, dtype=bool)
    n_done = 0
    level_remaining = None
    cur_level = 0
    if barrier_levels is not None:
        level_remaining = np.bincount(barrier_levels)
    events: list[tuple[float, int, int]] = []  # (end_time, task, machine)
    t_now = 0.0

    def start_tasks() -> None:
        """Vectorized work-conserving allocation pass."""
        while True:
            if barrier_levels is not None:
                cands = np.array([i for i in runnable if barrier_levels[i] == cur_level],
                                 dtype=np.int64)
            else:
                cands = np.fromiter(runnable, dtype=np.int64, count=len(runnable))
            if len(cands) == 0:
                return
            ok, best_m, best_s = packing.best_fit_machines(avail, dag.demand[cands],
                                                           dims=fit)
            fit_any = ok.any(axis=1)
            if not fit_any.any():
                return
            if policy == "priority":
                pr = np.where(fit_any, prio[cands], np.inf)
                ci = int(np.argmin(pr))
            elif policy == "dagps":
                ps = pri_score[cands] if pri_score is not None else np.ones(len(cands))
                ci = int(np.argmax(np.where(fit_any, ps * (best_s + 1e-9), -np.inf)))
            else:  # tetris
                ci = int(np.argmax(np.where(fit_any, best_s, -np.inf)))
            chosen = int(cands[ci])
            mach = int(best_m[ci])
            runnable.discard(chosen)
            avail[mach] -= dag.demand[chosen]
            heapq.heappush(events, (t_now + dag.duration[chosen], chosen, mach))

    start_tasks()
    while events:
        t_now, i, mach = heapq.heappop(events)
        avail[mach] += dag.demand[i]
        done[i] = True
        n_done += 1
        for c in dag.children[i]:
            pending_parents[c] -= 1
            if pending_parents[c] == 0:
                runnable.add(int(c))
        if level_remaining is not None:
            level_remaining[barrier_levels[i]] -= 1
            while cur_level < len(level_remaining) - 1 and level_remaining[cur_level] == 0:
                cur_level += 1
        # batch-drain simultaneous completions before reallocating
        while events and events[0][0] <= t_now + 1e-12:
            t2, i2, m2 = heapq.heappop(events)
            avail[m2] += dag.demand[i2]
            done[i2] = True
            n_done += 1
            for c in dag.children[i2]:
                pending_parents[c] -= 1
                if pending_parents[c] == 0:
                    runnable.add(int(c))
            if level_remaining is not None:
                level_remaining[barrier_levels[i2]] -= 1
                while cur_level < len(level_remaining) - 1 and level_remaining[cur_level] == 0:
                    cur_level += 1
        start_tasks()
    assert n_done == n, f"executor finished {n_done}/{n} tasks"
    return float(t_now)


def strip_levels(dag: DAG) -> np.ndarray:
    """Longest-path level of each task (all edges cross levels)."""
    lev = np.zeros(dag.n, dtype=np.int64)
    for i in range(dag.n):
        ps = dag.parents[i]
        lev[i] = (lev[ps].max() + 1) if len(ps) else 0
    return lev


# ----------------------------------------------------------------------
# One-call comparisons
# ----------------------------------------------------------------------

def run_baseline(dag: DAG, m: int, scheme: str, seed: int = 0,
                 fit_dims: Sequence[int] | None = None,
                 pri_score: np.ndarray | None = None,
                 backend: str | None = None,
                 device: str = "cuda") -> float:
    """Makespan of `scheme` on dag with m machines."""
    if scheme == "bfs":
        return simulate_execution(dag, m, order=bfs_order(dag), fit_dims=fit_dims)
    if scheme == "cp":
        return simulate_execution(dag, m, order=cp_order(dag), fit_dims=fit_dims)
    if scheme == "random":
        return simulate_execution(dag, m, order=random_order(dag, seed), fit_dims=fit_dims)
    if scheme == "tetris":
        return simulate_execution(dag, m, policy="tetris", fit_dims=fit_dims)
    if scheme == "cg":
        return simulate_execution(dag, m, order=cg_order(dag), fit_dims=fit_dims)
    if scheme == "strippart":
        return simulate_execution(
            dag, m, policy="tetris", fit_dims=fit_dims, barrier_levels=strip_levels(dag)
        )
    if scheme == "dagps":
        from .builder import build_schedule

        sched = build_schedule(dag, m, backend=backend, device=device)
        return simulate_execution(
            dag, m, policy="dagps", pri_score=pri_score if pri_score is not None else sched.pri_score,
            fit_dims=fit_dims,
        )
    raise ValueError(f"unknown scheme {scheme!r}")
