"""The paper's worked examples on the port (``repro_torch.core``), on the CPU.

Twins of ``tests/test_paper_examples.py``: Fig. 2 (DAGPS at OPT while
CPSched and Tetris pay about 2x), Lemma 1's red-task DAG and the Tetris
trap, each claim checked on the port with ``device="cpu"`` and the port's
makespans, schedules and executions equal to the reference's (the same
arithmetic, so by ``==``).  The core's lower bounds (``new_lb``,
``all_bounds``) and the execution simulator (``simulate_execution``) are
held against the reference's on these DAGs and on generated ones.
"""

import numpy as np
import pytest
import torch

from repro.core import bounds as jbounds
from repro.core import build_schedule as j_build_schedule
from repro.core.baselines import simulate_execution as j_simulate
from repro.sim.workload import lemma1_dag as j_lemma1_dag
from repro.sim.workload import production_dag as j_production_dag
from repro.sim.workload import query_dag as j_query_dag
from repro.sim.workload import tetris_trap_dag as j_tetris_trap_dag
from repro_torch.core import DAG, all_bounds, build_schedule, new_lb
from repro_torch.core.baselines import (bfs_order, cp_order,
                                        simulate_execution, strip_levels)
from repro_torch.sim.workload import (lemma1_dag, production_dag, query_dag,
                                      tetris_trap_dag)

torch.set_num_threads(1)

T, EPS = 100.0, 0.02


def fig2_dag() -> DAG:
    """The construction of ``tests/test_paper_examples.py``: three pairwise
    conflicting tasks {t0, t1, t3}, long tasks {t0, t2, t4} that OPT
    overlaps."""
    dur = np.array([T, EPS * T, T * (1 - 4 * EPS), EPS * T,
                    T * (1 - 2 * EPS)])
    dem = np.array([
        [0.80, 0.05],   # t0: long
        [0.75, 0.10],   # t1 -> t2
        [0.10, 0.80],   # t2: long
        [0.70, 0.25],   # t3 -> t4 (conflicts t2 on r1)
        [0.05, 0.10],   # t4: long
    ])
    parents = [np.array([], int), np.array([], int), np.array([1]),
               np.array([], int), np.array([3])]
    return DAG(duration=dur, demand=dem, stage_of=np.arange(5),
               parents=parents, name="fig2")


def _ref(dag):
    """The same DAG as the reference's type."""
    from repro.core.dag import DAG as JDAG
    return JDAG(duration=dag.duration.copy(), demand=dag.demand.copy(),
                stage_of=dag.stage_of.copy(),
                parents=[p.copy() for p in dag.parents], name=dag.name)


def _same_schedule(a, b):
    assert a.makespan == b.makespan
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.machine, b.machine)
    assert np.array_equal(a.order, b.order)


def test_fig2_dagps_matches_opt():
    dag = fig2_dag()
    sched = build_schedule(dag, m=1, ticks=400, device="cpu")
    sched.validate()
    assert sched.makespan <= T * (1 + 2 * EPS) * 1.02
    _same_schedule(sched, j_build_schedule(_ref(dag), m=1, ticks=400))


def test_fig2_cp_and_tetris_pay_2x():
    dag = fig2_dag()
    opt = T * (1 + 2 * EPS)
    cp = simulate_execution(dag, 1, order=cp_order(dag))
    tet = simulate_execution(dag, 1, policy="tetris")
    assert cp >= 1.8 * opt and tet >= 1.8 * opt
    assert cp == j_simulate(_ref(dag), 1, order=cp_order(dag))
    assert tet == j_simulate(_ref(dag), 1, policy="tetris")


def test_fig2_online_follows_schedule():
    dag = fig2_dag()
    sched = build_schedule(dag, m=1, ticks=400, device="cpu")
    dg = simulate_execution(dag, 1, policy="dagps", pri_score=sched.pri_score)
    assert dg <= T * (1 + 2 * EPS) * 1.02
    assert dg == j_simulate(_ref(dag), 1, policy="dagps",
                            pri_score=sched.pri_score)


def test_lemma1_dependency_blind_loses():
    """Fig. 17: a scheduler blind to structure pays about d times on the
    red-task DAG; DAGPS's structural tie-break finds the red tasks."""
    dag = lemma1_dag(d=4, k=6, t=10.0)
    jdag = j_lemma1_dag(d=4, k=6, t=10.0)
    lb = new_lb(dag, 1)
    assert lb == jbounds.new_lb(jdag, 1)
    blind = simulate_execution(dag, 1, order=bfs_order(dag))
    sched = build_schedule(dag, m=1, device="cpu")
    sched.validate()
    dagps = simulate_execution(dag, 1, policy="dagps",
                               pri_score=sched.pri_score)
    assert blind > 1.5 * lb and dagps <= blind
    assert sched.makespan <= 1.35 * lb
    _same_schedule(sched, j_build_schedule(jdag, m=1))


def test_tetris_trap():
    """Fig. 19's spirit: greedy packing serialises long tasks that DAGPS
    overlaps."""
    dag = tetris_trap_dag(d=4)
    sched = build_schedule(dag, m=1, device="cpu")
    sched.validate()
    tet = simulate_execution(dag, 1, policy="tetris")
    assert sched.makespan <= tet * 1.05
    jdag = j_tetris_trap_dag(d=4)
    _same_schedule(sched, j_build_schedule(jdag, m=1))
    assert tet == j_simulate(jdag, 1, policy="tetris")


def _generated(seed):
    """A production and a tpcds DAG from ``seed``: the port's and the
    reference's generators draw the same DAG."""
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    return [(production_dag(rng, scale=0.3, share=3),
             j_production_dag(jrng, scale=0.3, share=3)),
            (query_dag(rng, preset="tpcds"),
             j_query_dag(jrng, preset="tpcds"))]


@pytest.mark.parametrize("m", [1, 3])
def test_bounds_match_reference(m):
    """``new_lb`` and every entry of ``all_bounds`` equal the reference's
    by ``==`` on the worked examples and on generated DAGs; NewLB is never
    below the critical path or the total work bound."""
    pairs = [(fig2_dag(), _ref(fig2_dag())),
             (lemma1_dag(d=4, k=6, t=10.0), j_lemma1_dag(d=4, k=6, t=10.0)),
             (tetris_trap_dag(d=4), j_tetris_trap_dag(d=4))]
    pairs += _generated(m + 40)
    for dag, jdag in pairs:
        got, want = all_bounds(dag, m), jbounds.all_bounds(jdag, m)
        assert got == want, dag.name
        assert new_lb(dag, m) == jbounds.new_lb(jdag, m)
        assert got["newlb"] >= max(got["cplen"], got["twork"]) - 1e-9


@pytest.mark.parametrize("policy", ["priority", "tetris", "dagps"])
def test_simulate_execution_matches_reference(policy):
    """Each policy of the execution simulator on generated DAGs (on 1 and
    3 machines, with and without dimension subsets and strip barriers)
    gives the reference's makespan by ``==``."""
    for seed in (5, 6):
        for port, jdag in _generated(seed):
            for m in (1, 3):
                kw = {}
                if policy == "priority":
                    kw = dict(order=cp_order(port))
                elif policy == "dagps":
                    kw = dict(pri_score=np.linspace(1.0, 2.0, port.n))
                got = simulate_execution(port, m, policy=policy, **kw)
                assert got == j_simulate(jdag, m, policy=policy, **kw)
                if policy == "priority":
                    lv = strip_levels(port)
                    assert simulate_execution(
                        port, m, barrier_levels=lv, fit_dims=[0, 1], **kw) \
                        == j_simulate(jdag, m, barrier_levels=lv,
                                      fit_dims=[0, 1], **kw)
