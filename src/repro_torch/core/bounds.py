"""Lower bounds on DAG completion time (paper §6, Eq. 1a-1d).

  CPLen  — critical path length (1a)
  TWork  — total work / capacity, maxed over resources (1b)
  ModCP  — a path bound where exactly one stage on the path is upgraded from
           "one task must run" to "the whole stage must complete"
           (max(TWork_s, CPLen_s)), all other stages contribute their
           minimum task duration (1c)
  NewLB  — split the DAG into totally ordered partitions (§4.4) and sum the
           per-partition max(CPLen, TWork, ModCP) (1d)

All bounds are per-job, normalized to the job's capacity share of
m machines x 1.0 capacity per resource.
"""

from __future__ import annotations

import numpy as np

from .dag import DAG


def cp_length(dag: DAG) -> float:
    """Eq. 1a: longest path by task duration."""
    n = dag.n
    if n == 0:
        return 0.0
    finish = np.zeros(n, dtype=np.float64)
    for i in range(n):  # topological order
        ps = dag.parents[i]
        base = finish[ps].max() if len(ps) else 0.0
        finish[i] = base + dag.duration[i]
    return float(finish.max())


def t_work(dag: DAG, m: int) -> float:
    """Eq. 1b: total work normalized by capacity, maxed over resources."""
    if dag.n == 0:
        return 0.0
    per_res = (dag.duration[:, None] * dag.demand).sum(axis=0)  # (d,)
    return float(per_res.max() / m)


def _stage_quantities(dag: DAG, m: int):
    """Per stage: (min task duration, max task duration=CPLen_s, TWork_s)."""
    mins = np.zeros(dag.n_stages)
    maxs = np.zeros(dag.n_stages)
    works = np.zeros(dag.n_stages)
    for s, ids in enumerate(dag.stages):
        if len(ids) == 0:
            continue
        mins[s] = dag.duration[ids].min()
        maxs[s] = dag.duration[ids].max()
        works[s] = float(
            (dag.duration[ids, None] * dag.demand[ids]).sum(axis=0).max() / m
        )
    return mins, maxs, works


def mod_cp(dag: DAG, m: int) -> float:
    """Eq. 1c over the stage DAG.

    max over stage-paths p, max over s in p of
      max(TWork_s, CPLen_s) + sum_{s' in p - s} min-duration(s').
    Computed by a 2-state longest-path DP (upgrade used / not used).
    """
    if dag.n == 0:
        return 0.0
    mins, maxs, works = _stage_quantities(dag, m)
    upgraded = np.maximum(works, maxs)
    sp = dag.stage_parents()
    n_s = dag.n_stages
    order = _topo_stages(sp, n_s)
    best0 = np.full(n_s, -np.inf)  # path ending at s, no stage upgraded yet
    best1 = np.full(n_s, -np.inf)  # path ending at s, one stage upgraded
    for s in order:
        p0 = max((best0[p] for p in sp[s]), default=0.0)
        p1 = max((best1[p] for p in sp[s]), default=-np.inf)
        best0[s] = p0 + mins[s]
        best1[s] = max(p0 + upgraded[s], (p1 + mins[s]) if p1 > -np.inf else -np.inf)
    return float(max(best1.max(), best0.max()))


def _topo_stages(stage_parents, n_s: int) -> list[int]:
    state = [0] * n_s
    out: list[int] = []

    def visit(s: int):
        if state[s] == 2:
            return
        if state[s] == 1:
            raise ValueError("stage cycle")
        state[s] = 1
        for p in stage_parents[s]:
            visit(p)
        state[s] = 2
        out.append(s)

    for s in range(n_s):
        visit(s)
    return out


def new_lb(dag: DAG, m: int) -> float:
    """Eq. 1d: sum over totally ordered partitions of the best bound."""
    from .builder import partition_totally_ordered, _subdag

    if dag.n == 0:
        return 0.0
    parts = partition_totally_ordered(dag)
    total = 0.0
    for ids in parts:
        sub = _subdag(dag, ids) if len(parts) > 1 else dag
        total += max(cp_length(sub), t_work(sub, m), mod_cp(sub, m))
    return float(total)


def all_bounds(dag: DAG, m: int) -> dict[str, float]:
    return {
        "cplen": cp_length(dag),
        "twork": t_work(dag, m),
        "modcp": mod_cp(dag, m),
        "newlb": new_lb(dag, m),
    }
