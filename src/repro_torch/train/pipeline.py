"""DAGPS applied inside one training step: a port of
``repro.train.pipeline``.

A pipeline-parallel training step is a DAG: tasks F(s, m) / B(s, m) for
stage s and microbatch m, with F(s,m) <- F(s-1,m), B(s,m) <- B(s+1,m),
B(last,m) <- F(last,m).  Stages are exclusive executors, which maps onto
the paper's d-resource model by giving stage s its own resource dimension
with demand 1.0 (capacity 1 = one stage runs one task at a time).
`schedule_pipeline` runs the paper's BuildSchedule (the port's
`build_schedule`, its feasibility scan on ``device``) on this DAG and
returns the execution order and the makespan; `gpipe_makespan` and
`one_f_one_b_makespan` are the classical baselines in the same model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.builder import build_schedule
from ..core.dag import DAG


@dataclasses.dataclass
class PipelinePlan:
    order: list[tuple[str, int, int]]       # (F|B, stage, microbatch) by start
    makespan: float
    bubble_fraction: float
    microbatch_order: tuple[int, ...]        # stage-0 forward order


def pipeline_dag(n_stages: int, n_micro: int, t_fwd: float,
                 t_bwd: float | None = None) -> DAG:
    t_bwd = 2.0 * t_fwd if t_bwd is None else t_bwd
    n = 2 * n_stages * n_micro
    dur = np.empty(n)
    dem = np.zeros((n, n_stages))
    stage_of = np.empty(n, dtype=np.int64)
    parents: list = [None] * n

    def fid(s, m):
        return m * n_stages + s

    def bid(s, m):
        return n_stages * n_micro + m * n_stages + (n_stages - 1 - s)

    for m in range(n_micro):
        for s in range(n_stages):
            i = fid(s, m)
            dur[i] = t_fwd
            dem[i, s] = 1.0
            stage_of[i] = s
            parents[i] = (np.array([fid(s - 1, m)], np.int64) if s
                          else np.empty(0, np.int64))
    for m in range(n_micro):
        for s in range(n_stages - 1, -1, -1):
            i = bid(s, m)
            dur[i] = t_bwd
            dem[i, s] = 1.0
            stage_of[i] = n_stages + s
            ps = [bid(s + 1, m)] if s < n_stages - 1 else [fid(n_stages - 1, m)]
            parents[i] = np.array(sorted(ps), np.int64)
    return DAG(duration=dur, demand=dem, stage_of=stage_of, parents=parents,
               name=f"pipeline-{n_stages}x{n_micro}")


def _ideal(n_stages, n_micro, t_fwd, t_bwd):
    return n_micro * (t_fwd + t_bwd)  # perfectly full slowest-stage timeline


def schedule_pipeline(n_stages: int, n_micro: int, t_fwd: float,
                      t_bwd: float | None = None, ticks: int = 512,
                      device: str = "cuda") -> PipelinePlan:
    """The DAGPS plan of one pipeline step.  ``device`` is where the
    builder's feasibility scan runs ("cuda" by default, which raises
    without a card; "cpu" for its plain version)."""
    t_bwd = 2.0 * t_fwd if t_bwd is None else t_bwd
    dag = pipeline_dag(n_stages, n_micro, t_fwd, t_bwd)
    sched = build_schedule(dag, m=1, ticks=ticks, use_partitions=False,
                           device=device)
    order = []
    for t in sched.order:
        s = int(dag.stage_of[t])
        kind = "F" if s < n_stages else "B"
        stage = s if s < n_stages else s - n_stages
        micro = (int(t) % (n_stages * n_micro)) // n_stages
        order.append((kind, stage, micro))
    mb_order = tuple(m for (k, s, m) in order if k == "F" and s == 0)
    ideal = _ideal(n_stages, n_micro, t_fwd, t_bwd)
    return PipelinePlan(order=order, makespan=sched.makespan,
                        bubble_fraction=float(sched.makespan / ideal - 1.0),
                        microbatch_order=mb_order)


def gpipe_makespan(n_stages: int, n_micro: int, t_fwd: float,
                   t_bwd: float | None = None) -> float:
    """GPipe: all forwards (with fill bubble), barrier, all backwards."""
    t_bwd = 2.0 * t_fwd if t_bwd is None else t_bwd
    fwd = (n_stages - 1) * t_fwd + n_micro * t_fwd
    bwd = (n_stages - 1) * t_bwd + n_micro * t_bwd
    return fwd + bwd


def one_f_one_b_makespan(n_stages: int, n_micro: int, t_fwd: float,
                         t_bwd: float | None = None) -> float:
    """1F1B (non-interleaved) steady-state makespan (classical closed form):
    warmup fills the pipeline, then each microbatch costs t_fwd + t_bwd on
    the bottleneck stage, then drain."""
    t_bwd = 2.0 * t_fwd if t_bwd is None else t_bwd
    return (n_stages - 1) * (t_fwd + t_bwd) + n_micro * (t_fwd + t_bwd)


def ideal_makespan(n_stages: int, n_micro: int, t_fwd: float,
                   t_bwd: float | None = None) -> float:
    t_bwd = 2.0 * t_fwd if t_bwd is None else t_bwd
    return _ideal(n_stages, n_micro, t_fwd, t_bwd)
