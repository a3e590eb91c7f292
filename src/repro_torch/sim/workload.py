"""Workload generators matching the paper's evaluated DAG populations.

§2.3's characterization of production DAGs drives `production_dag`:
  * median depth 7 (number of tasks on the critical path),
  * complex structure: median in-degree 7, out-degree 1 (75th: 48 / 4),
  * CoV of resource demands ~ 1 across tasks (Table 1),
  * task durations from sub-second to hundreds of seconds,
  * tasks grouped into stages with similar profiles.

Other generators model the paper's other workloads: TPC-H / TPC-DS /
BigBench-style query DAGs (§8.1), mostly-2-stage E-Hive jobs, distributed
build systems and request-response workflows (§9).

Scale note: production DAGs have a median of ~1000 tasks; to keep the
single-core simulator tractable we default to tens-to-hundreds of tasks per
DAG with the same structural statistics.  The construction algorithm is
size-agnostic; `scale` lifts task counts when desired.
"""

from __future__ import annotations

import numpy as np

from ..core.dag import (DAG, append_stage, from_stage_graph, resize_stage,
                        retarget_deadline, scale_speeds)


def _lognormal(rng, median: float, sigma: float) -> float:
    return float(median * np.exp(sigma * rng.standard_normal()))


def _stage_demand(rng: np.random.Generator) -> np.ndarray:
    """Per-stage demand vector with CoV ~ 1 across stages (Table 1)."""
    kind = rng.random()
    base = np.array([0.12, 0.12, 0.08, 0.08])
    if kind < 0.3:    # compute heavy (user-defined code)
        base = np.array([0.35, 0.10, 0.05, 0.05])
    elif kind < 0.55:  # memory heavy (in-memory sorts / joins)
        base = np.array([0.10, 0.40, 0.05, 0.08])
    elif kind < 0.8:   # shuffle heavy (network + disk)
        base = np.array([0.08, 0.10, 0.30, 0.25])
    dem = base * np.exp(0.75 * rng.standard_normal(4))
    return np.clip(dem, 0.01, 0.9)


def production_dag(rng: np.random.Generator, scale: float = 1.0, share: int = 4,
                   name: str = "prod") -> DAG:
    """Production-like DAG: staged graph with embedded long/heavy motifs.

    Structure follows §2.3: median depth ~7, substantial unordered work,
    demands CoV ~1, durations spanning ~3 orders of magnitude.  Crucially it
    embeds the pathology the paper shows is common in production (Fig. 2,
    Figs. 17-19): *long, resource-heavy stages at staggered depths whose
    enabling (wide, cheap) stages conflict with them on a dominant resource*.
    A greedy/CP scheduler starts a long stage as soon as it is runnable,
    which blocks the enablers of the other long stages and serializes them;
    overlapping the long stages requires placing them deliberately.

    `share` is the cluster share (machines) the job is sized for: stage
    widths scale with it so the job's share is actually contended (the
    regime the paper's production DAGs live in).
    """
    m = max(int(share * scale), 2)
    n_groups = int(rng.integers(2, 5))          # overlap motifs
    stages, durs, dems, deps = [], [], [], []

    def add(q, dur, dem, parents):
        stages.append(max(int(q), 1))
        durs.append(float(dur))
        dems.append(np.clip(np.asarray(dem, dtype=np.float64), 0.01, 0.9))
        deps.append(sorted(set(int(p) for p in parents)))
        return len(stages) - 1

    long_res = rng.permutation(4)
    prev_tail: int | None = None
    long_ids = []
    for g in range(n_groups):
        r_long = int(long_res[g % 4])
        # wide enabler stage: cheap tasks dominant on this group's long
        # resource, so a running long stage blocks the *next* enablers.
        wide_dem = np.full(4, 0.05) * np.exp(0.4 * rng.standard_normal(4))
        wide_dem[r_long] = rng.uniform(0.35, 0.55)
        parents = [prev_tail] if prev_tail is not None else []
        w = add(int(rng.integers(3 * m, 6 * m)),
                max(1.0, _lognormal(rng, 3.0, 0.5)), wide_dem, parents)
        # long heavy stage (spans most of the share for a long time)
        long_dem = np.full(4, 0.05) * np.exp(0.4 * rng.standard_normal(4))
        long_dem[r_long] = rng.uniform(0.5, 0.75)
        l = add(int(rng.integers(max(m // 2, 1), m + 1)),
                _lognormal(rng, 50.0, 0.4), long_dem, [w])
        long_ids.append(l)
        # a medium processing stage continues the chain
        mid_dem = np.full(4, 0.07) * np.exp(0.5 * rng.standard_normal(4))
        mid_dem[int(rng.integers(0, 4))] = rng.uniform(0.25, 0.5)
        prev_tail = add(int(rng.integers(2 * m, 4 * m)),
                        max(0.5, _lognormal(rng, 6.0, 0.8)), mid_dem, [w])
    # join/aggregate tail over the long stages and the chain
    agg_dem = np.full(4, 0.1) * np.exp(0.4 * rng.standard_normal(4))
    agg_dem[int(rng.integers(0, 4))] = rng.uniform(0.2, 0.4)
    add(int(rng.integers(1, 4)), max(1.0, _lognormal(rng, 8.0, 0.6)),
        agg_dem, long_ids + ([prev_tail] if prev_tail is not None else []))
    # noise stages: unordered side work with CoV~1 demands, mixed durations
    for _ in range(int(rng.integers(2, 6))):
        par = [int(rng.integers(0, len(stages) - 1))] if rng.random() < 0.5 else []
        dd = np.full(4, 0.08) * np.exp(0.6 * rng.standard_normal(4))
        dd[int(rng.integers(0, 4))] = rng.uniform(0.2, 0.6)
        add(max(1, int(_lognormal(rng, 4.0, 0.9))),
            max(0.3, _lognormal(rng, 5.0, 1.1)), dd, par)
    return from_stage_graph(stages, durs, dems, deps, name=name, rng=rng,
                            duration_jitter=0.15, demand_jitter=0.1)


# ----------------------------------------------------------------------
# Appendix adversarial DAGs (Lemmas 1-2, Figs. 17-19)
# ----------------------------------------------------------------------

def lemma1_dag(d: int = 4, k: int = 6, t: float = 10.0) -> DAG:
    """Fig. 17: d groups of k tasks, each group's 'red' task gates the next.

    Group i's tasks each consume all of resource i; the red task is
    structurally identical except it parents every task of group i+1.
    Any dependency-blind scheduler is Omega(d) x OPT in expectation.
    """
    stages, durs, dems, deps = [], [], [], []
    red_prev: int | None = None
    for i in range(d):
        dem = np.full(d, 0.02)
        dem[i] = 0.9
        parents = [red_prev] if red_prev is not None else []
        # siblings first: a dependency-blind scheduler that breaks ties by
        # id runs the red task *last* (the adversary's choice in the proof).
        stages.append(k - 1); durs.append(t); dems.append(dem.copy()); deps.append(list(parents))
        red = len(stages)
        stages.append(1); durs.append(t); dems.append(dem.copy()); deps.append(list(parents))
        red_prev = red
    return from_stage_graph(stages, durs, dems, deps, name=f"lemma1-d{d}")


def tetris_trap_dag(d: int = 4, t: float = 30.0) -> DAG:
    """Fig. 19 spirit: long tasks score highest for Tetris but serialize.

    d-1 long tasks (one per resource) can all co-run; each long task's wide
    parent stage conflicts with the *previous* long task.  Tetris greedily
    runs each long task as soon as it appears, blocking the next group's
    wide parents -> ~(2d-2) x OPT.  Placing the long tasks first overlaps
    them.
    """
    stages, durs, dems, deps = [], [], [], []
    eps = 0.04
    for j in range(1, d):
        wide = np.full(d, eps)
        wide[j - 1] = 0.55          # conflicts with long task j-1
        stages.append(4); durs.append(t * 0.1); dems.append(wide); deps.append([])
        long = np.full(d, eps)
        long[j] = 0.8
        stages.append(1); durs.append(t); dems.append(long)
        deps.append([len(stages) - 2])
    return from_stage_graph(stages, durs, dems, deps, name=f"tetris-trap-d{d}")


def query_dag(rng: np.random.Generator, preset: str = "tpch", name: str | None = None) -> DAG:
    """Tree-shaped analytical query DAGs: scans -> joins -> aggregates.

    Presets vary structure: TPC-H (moderate joins), TPC-DS (deeper, bushier),
    BigBench (CP-dominant: long chains), E-Hive (mostly 2-stage map-reduce).
    """
    cfg = {
        "tpch":    dict(n_scans=(2, 5), join_depth=(1, 3), chain=0.0),
        "tpcds":   dict(n_scans=(3, 7), join_depth=(2, 4), chain=0.15),
        "bigbench": dict(n_scans=(2, 4), join_depth=(1, 3), chain=0.6),
        "ehive":   dict(n_scans=(1, 2), join_depth=(0, 1), chain=0.0),
    }[preset]
    tasks: list[int] = []
    durs: list[float] = []
    dems: list[np.ndarray] = []
    deps: list[list[int]] = []

    def add_stage(q, dur, dem, parents):
        tasks.append(q)
        durs.append(dur)
        dems.append(dem)
        deps.append(parents)
        return len(tasks) - 1

    scans = []
    for _ in range(int(rng.integers(*cfg["n_scans"]) + 1)):
        q = max(2, int(_lognormal(rng, 8, 0.7)))
        scans.append(add_stage(
            q, max(1.0, _lognormal(rng, 8, 0.8)),
            np.clip(np.array([0.1, 0.08, 0.05, 0.3]) * np.exp(0.5 * rng.standard_normal(4)), 0.01, 0.9),
            [],
        ))
    frontier = scans
    depth = int(rng.integers(cfg["join_depth"][0], cfg["join_depth"][1] + 1))
    for _ in range(depth):
        if len(frontier) < 2:
            break
        nxt = []
        it = iter(frontier)
        for a in it:
            b = next(it, None)
            parents = [a] if b is None else [a, b]
            q = max(1, int(_lognormal(rng, 5, 0.6)))
            nxt.append(add_stage(
                q, max(1.0, _lognormal(rng, 15, 0.9)),
                np.clip(np.array([0.2, 0.3, 0.2, 0.1]) * np.exp(0.5 * rng.standard_normal(4)), 0.01, 0.9),
                parents,
            ))
        frontier = nxt
    # aggregate tail; BigBench-style adds a CP-dominant chain
    tail = add_stage(
        max(1, int(rng.integers(1, 4))), max(2.0, _lognormal(rng, 20, 0.6)),
        np.clip(np.array([0.25, 0.2, 0.1, 0.1]) * np.exp(0.4 * rng.standard_normal(4)), 0.01, 0.9),
        frontier,
    )
    while rng.random() < cfg["chain"]:
        tail = add_stage(
            1, max(2.0, _lognormal(rng, 25, 0.5)),
            np.clip(np.array([0.3, 0.2, 0.05, 0.05]) * np.exp(0.4 * rng.standard_normal(4)), 0.01, 0.9),
            [tail],
        )
    return from_stage_graph(tasks, durs, dems, deps, name=name or preset, rng=rng,
                            duration_jitter=0.15, demand_jitter=0.1)


def build_system_dag(rng: np.random.Generator, size: str = "medium", name: str = "build") -> DAG:
    """Distributed build DAG (§9): compile -> lib link -> bin link -> tests."""
    n_modules = {"small": 3, "medium": 6, "large": 12}[size]
    tasks, durs, dems, deps = [], [], [], []

    def add(q, dur, dem, parents):
        tasks.append(q)
        durs.append(dur)
        dems.append(np.asarray(dem))
        deps.append(parents)
        return len(tasks) - 1

    compiles = [
        add(max(2, int(_lognormal(rng, 10, 0.6))), max(0.5, _lognormal(rng, 4, 0.7)),
            np.clip(np.array([0.3, 0.12, 0.02, 0.08]) * np.exp(0.3 * rng.standard_normal(4)), 0.01, 0.9), [])
        for _ in range(n_modules)
    ]
    libs = [
        add(1, max(1.0, _lognormal(rng, 10, 0.5)),
            [0.15, 0.35, 0.05, 0.2], [c])
        for c in compiles
    ]
    binary = add(1, max(2.0, _lognormal(rng, 20, 0.4)), [0.2, 0.5, 0.05, 0.3], libs)
    for _ in range(int(rng.integers(2, 6))):
        add(max(2, int(_lognormal(rng, 6, 0.6))), max(2.0, _lognormal(rng, 30, 0.8)),
            np.clip(np.array([0.25, 0.15, 0.1, 0.05]) * np.exp(0.3 * rng.standard_normal(4)), 0.01, 0.9),
            [binary])
    return from_stage_graph(tasks, durs, dems, deps, name=name, rng=rng,
                            duration_jitter=0.2, demand_jitter=0.1)


def workflow_dag(rng: np.random.Generator, name: str = "workflow") -> DAG:
    """Request-response workflow (§9): dependent RPCs, ms-scale, shared pool."""
    depth = int(rng.integers(3, 8))
    tasks, durs, dems, deps = [], [], [], []
    prev: list[int] = []
    for lvl in range(depth):
        width = 1 if lvl in (0, depth - 1) else int(rng.integers(1, 5))
        cur = []
        for _ in range(width):
            tasks.append(max(1, int(rng.integers(1, 4))))
            durs.append(max(0.001, _lognormal(rng, 0.020, 0.8)))
            dems.append(np.clip(
                np.array([0.15, 0.1, 0.25, 0.05]) * np.exp(0.5 * rng.standard_normal(4)),
                0.01, 0.9))
            parents = prev if prev else []
            deps.append(list(parents))
            cur.append(len(tasks) - 1)
        prev = cur
    return from_stage_graph(tasks, durs, dems, deps, name=name, rng=rng,
                            duration_jitter=0.1, demand_jitter=0.1)


def periodic_dag(rng: np.random.Generator, name: str = "periodic") -> DAG:
    """Recurring-pipeline DAG: one phase template repeated behind barriers.

    Production clusters run large fractions of *recurring* jobs — the same
    pipeline executed over successive data windows (the paper's §2 notes
    over 40% of cluster workload recurs), and iterative jobs have the same
    shape: identical phases separated by synchronization barriers.  Each
    period here is scan -> two parallel process stages -> a barrier
    aggregate, with every period drawn ONCE and repeated verbatim, so
    `partition_totally_ordered` splits the DAG into identical sub-builds —
    the regime the cross-partition construction memo serves (identical
    partitions quantize to the same ticks, so the windowed place memo of
    period 1 answers the placements of periods 2..P).
    """
    periods = int(rng.integers(3, 6))
    # the template is drawn once; periods repeat it bit-identically
    scan_q = int(rng.integers(6, 14))
    scan_dur = max(1.0, _lognormal(rng, 6.0, 0.5))
    scan_dem = _stage_demand(rng)
    proc = [(int(rng.integers(3, 9)),
             max(1.0, _lognormal(rng, 12.0, 0.5)),
             _stage_demand(rng)) for _ in range(2)]
    agg_dur = max(1.0, _lognormal(rng, 4.0, 0.4))
    agg_dem = _stage_demand(rng)

    tasks, durs, dems, deps = [], [], [], []

    def add(q, dur, dem, parents):
        tasks.append(q)
        durs.append(dur)
        dems.append(dem)
        deps.append(parents)
        return len(tasks) - 1

    barrier = None
    for _p in range(periods):
        s = add(scan_q, scan_dur, scan_dem, [barrier] if barrier is not None else [])
        ps = [add(q, dur, dem, [s]) for q, dur, dem in proc]
        barrier = add(1, agg_dur, agg_dem, ps)
    # no jitter: periods must stay bit-identical (that IS the workload)
    return from_stage_graph(tasks, durs, dems, deps, name=name, rng=rng)


# ----------------------------------------------------------------------
# Dynamic-DAG scenarios (s12): scripted mutations for SimConfig.mutations
# ----------------------------------------------------------------------

def mut_append_stage(q: int = 2, duration: float = 4.0, demand=None):
    """Curried `core.dag.append_stage`: a late-arriving stage hung off the
    DAG's last stage (the 'tasks added to a running job' production case)."""
    dem = np.full(4, 0.1) if demand is None else np.asarray(demand, float)

    def mut(dag: DAG):
        return append_stage(dag, q, duration, dem,
                            parent_stages=(int(dag.stage_of.max()),))
    return mut


def mut_resize_stage(stage: int = 1, delta_q: int = 1):
    """Curried `core.dag.resize_stage`: grow/shrink one stage by delta_q."""
    def mut(dag: DAG):
        q = int((dag.stage_of == stage).sum())
        return resize_stage(dag, stage, max(q + delta_q, 1))
    return mut


def mut_retarget(factor: float = 0.8):
    """Curried `core.dag.retarget_deadline`: pull every deadline in."""
    return lambda dag: retarget_deadline(dag, factor)


def mut_scale_speeds(factor: float = 1.5, ids=None):
    """Curried `core.dag.scale_speeds`: the job-share view of a machine
    speed edit (durations rescale)."""
    return lambda dag: scale_speeds(dag, factor, ids)


def s12_dynamic(kind: str, n_jobs: int = 6, seed: int = 0):
    """Recurring-pipeline population + scripted edits — the s12_dynamic
    scenario family.  One periodic template repeated ``n_jobs`` times (the
    paper's >40%-recurring regime) plus mutations per ``kind``:

      resize — a stage resize lands before each later arrival: the classic
               recurring-pipeline edit.  Only the edited period's partition
               re-searches; every other partition replays from the
               template's schedule (the >=50%-placement-reuse scenario).
      retime — a deadline pull-in lands before each later arrival: every
               duration changes, so nothing can replay (worst case; the
               contrast row for the reuse accounting).
      midrun — dynamics inside a running job: a task/stage arrival, a
               deadline pull-in, and a machine speed change.

    Returns ``(dags, mutations)`` for `run_workload(..., mutations=...)`.
    """
    rng = np.random.default_rng(seed)
    template = periodic_dag(rng, name="recurring")
    dags = [template] * n_jobs
    if kind == "resize":
        muts = [(0.0, k, mut_resize_stage(stage=1, delta_q=1))
                for k in range(1, n_jobs)]
    elif kind == "retime":
        muts = [(0.0, k, mut_retarget(0.8)) for k in range(1, n_jobs)]
    elif kind == "midrun":
        muts = [(1.0, 0, mut_append_stage()),
                (2.0, 0, mut_retarget(0.9)),
                (5.0, "speed", 0, 1.5)]
    else:
        raise ValueError(f"unknown s12_dynamic kind {kind!r}")
    return dags, muts


def online_mix_workload(n_jobs: int, seed: int = 0,
                        scale: float = 0.5) -> list[DAG]:
    """Cluster-scale online mix: alternating production + TPC-DS jobs.

    The population the s8/s9 online scenarios schedule — the paper's §8
    regime of heterogeneous query DAGs interleaved with production DAGs
    arriving at high rate on hundreds of machines.  `scale` sizes the
    production DAGs (0.5 keeps individual jobs small so the *count* of
    concurrent jobs, not any single DAG, is what stresses the scheduler).
    """
    rng = np.random.default_rng(seed)
    out: list[DAG] = []
    for k in range(n_jobs):
        if k % 2 == 0:
            out.append(production_dag(rng, scale=scale, name=f"prod-{k}"))
        else:
            out.append(query_dag(rng, "tpcds", name=f"tpcds-{k}"))
    return out


def make_workload(benchmark: str, n_jobs: int, seed: int = 0, scale: float = 1.0) -> list[DAG]:
    """n_jobs DAGs drawn from a benchmark family (§8.1)."""
    rng = np.random.default_rng(seed)
    out: list[DAG] = []
    for k in range(n_jobs):
        if benchmark == "production":
            out.append(production_dag(rng, scale=scale, name=f"prod-{k}"))
        elif benchmark in ("tpch", "tpcds", "bigbench", "ehive"):
            out.append(query_dag(rng, benchmark, name=f"{benchmark}-{k}"))
        elif benchmark == "build":
            out.append(build_system_dag(rng, name=f"build-{k}"))
        elif benchmark == "workflow":
            out.append(workflow_dag(rng, name=f"wf-{k}"))
        elif benchmark == "periodic":
            out.append(periodic_dag(rng, name=f"periodic-{k}"))
        elif benchmark == "mixed":
            kind = ["production", "tpch", "tpcds", "bigbench"][k % 4]
            out.extend(make_workload(kind, 1, seed=seed * 1000 + k, scale=scale))
        else:
            raise ValueError(f"unknown benchmark {benchmark!r}")
    return out
