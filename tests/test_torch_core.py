"""The port's DAGPS core (``repro_torch.core``) on the CPU: a twin of
``tests/test_core.py``.

The same unit tests of DAG operations, the space, the builder, the bounds
and the online matcher, run on the port's classes with ``device="cpu"``
(the builder's scan through its plain torch version); where the reference
computes the same thing on the same input (a schedule, candidate sets,
frag scores, bounds, a matcher's picks), the port's result equals it by
``==``.
"""

import numpy as np
import pytest
import torch

from repro.core import all_bounds as j_all_bounds
from repro.core import build_schedule as j_build_schedule
from repro.core.builder import candidate_troublesome as j_candidates
from repro.core.builder import frag_scores as j_frag_scores
from repro.sim.workload import production_dag as j_production_dag
from repro_torch.core import (DAG, DeficitCounters, Matcher, MatcherConfig,
                              PendingTask, JobView, Space, all_bounds,
                              bfs_order, build_schedule, cp_length, mod_cp,
                              new_lb, partition_totally_ordered,
                              simulate_execution, t_work)
from repro_torch.core.builder import candidate_troublesome, frag_scores
from repro_torch.sim.workload import production_dag

torch.set_num_threads(1)


def chain_dag(n=4, dur=2.0, dem=0.5):
    return DAG(duration=np.full(n, dur), demand=np.full((n, 2), dem),
               stage_of=np.arange(n),
               parents=[np.array([], int)] + [np.array([i]) for i in range(n - 1)])


def diamond_dag():
    #     0
    #   1   2
    #     3
    return DAG(duration=np.array([1.0, 2.0, 3.0, 1.0]),
               demand=np.full((4, 2), 0.4),
               stage_of=np.arange(4),
               parents=[np.array([], int), np.array([0]), np.array([0]),
                        np.array([1, 2])])


class TestDAG:
    def test_closure(self):
        d = diamond_dag()
        mask = np.array([True, False, False, True])  # {0, 3}
        closed = d.closure_mask(mask)
        assert closed.all()  # 1 and 2 are on paths 0->3

    def test_split_subsets_disjoint_cover(self):
        d = diamond_dag()
        t = np.array([False, True, False, False])
        t2, o, p, c = d.split_subsets(d.closure_mask(t))
        total = t2.astype(int) + o.astype(int) + p.astype(int) + c.astype(int)
        assert (total == 1).all()
        assert p[0] and c[3] and o[2]

    def test_partition_chain(self):
        d = chain_dag(5)
        parts = partition_totally_ordered(d)
        assert len(parts) == 5

    def test_partition_diamond(self):
        parts = partition_totally_ordered(diamond_dag())
        assert len(parts) == 3  # {0}, {1,2}, {3}

    def test_validate_order(self):
        d = diamond_dag()
        assert d.validate_order([0, 1, 2, 3])
        assert not d.validate_order([1, 0, 2, 3])


class TestSpace:
    def test_commit_and_makespan(self):
        s = Space(m=2, d=2, horizon=10)
        m, t = s.earliest_fit(np.array([0.6, 0.6]), 3, 0)
        s.commit(0, m, t, 3, np.array([0.6, 0.6]))
        m2, t2 = s.earliest_fit(np.array([0.6, 0.6]), 3, 0)
        s.commit(1, m2, t2, 3, np.array([0.6, 0.6]))
        assert s.makespan_ticks == 3  # second machine
        m3, t3 = s.earliest_fit(np.array([0.6, 0.6]), 3, 0)
        assert t3 == 3 or m3 not in (m, m2)

    def test_grow_back(self):
        s = Space(m=1, d=1, horizon=8)
        m, t = s.earliest_fit(np.array([1.0]), 30, 0)
        s.commit(0, m, t, 30, np.array([1.0]))
        assert s.T >= 30

    def test_latest_fit_packs_before_deadline(self):
        s = Space(m=1, d=1, horizon=20)
        m, t = s.latest_fit(np.array([0.9]), 4, 10)
        assert t == 6
        s.commit(0, m, t, 4, np.array([0.9]))
        m2, t2 = s.latest_fit(np.array([0.9]), 4, 10)
        assert t2 == 2

    def test_front_growth_negative_coords(self):
        s = Space(m=1, d=1, horizon=8)
        m, t = s.latest_fit(np.array([0.5]), 20, 4)
        assert t < 0  # grew the front; logical coords go negative
        s.commit(0, m, t, 20, np.array([0.5]))
        assert s.makespan_ticks == 20

    def test_overcommit_raises(self):
        s = Space(m=1, d=1, horizon=8)
        s.commit(0, 0, 0, 4, np.array([0.9]))
        with pytest.raises(RuntimeError):
            s.commit(1, 0, 0, 4, np.array([0.9]))

    def test_runs_of_k_window_shorter_than_run(self):
        from repro_torch.core.space import runs_of_k
        ok = np.ones((3, 5), dtype=bool)
        # window shorter than the run: nothing can start (used to mis-slice
        # the cumsum and raise on long tasks scanned near the grid end)
        assert runs_of_k(ok, 7).shape == (3, 0)
        assert runs_of_k(ok, 6).shape == (3, 0)
        # boundary: window exactly k long has the single start position
        out = runs_of_k(ok, 5)
        assert out.shape == (3, 1) and out.all()
        # a gap still blocks the run
        ok[1, 2] = False
        assert not runs_of_k(ok, 5)[1, 0]


class TestBuilder:
    def test_schedule_valid_on_random_dags(self):
        for seed in range(4):
            dag = production_dag(np.random.default_rng(seed))
            sched = build_schedule(dag, m=4, device="cpu")
            sched.validate()
            assert dag.validate_order(sched.order)

    def test_deterministic(self):
        dag = production_dag(np.random.default_rng(7))
        a = build_schedule(dag, m=4, device="cpu")
        b = build_schedule(dag, m=4, device="cpu")
        assert a.makespan == b.makespan
        assert (a.order == b.order).all()

    def test_candidates_deduped(self):
        dag = production_dag(np.random.default_rng(3))
        cands = candidate_troublesome(dag, m=4)
        seen = {c.tobytes() for c in cands}
        assert len(seen) == len(cands)

    def test_frag_scores_bounded(self):
        dag = production_dag(np.random.default_rng(5))
        fs = frag_scores(dag, 4)
        assert ((fs > 0) & (fs <= 1.0)).all()

    def test_empty_candidate_always_present(self):
        dag = chain_dag(3)
        cands = candidate_troublesome(dag, m=2)
        assert any(not c.any() for c in cands)


class TestBounds:
    def test_chain(self):
        d = chain_dag(4, dur=2.0, dem=0.5)
        assert cp_length(d) == pytest.approx(8.0)
        assert t_work(d, 2) == pytest.approx(4 * 2 * 0.5 / 2)
        assert new_lb(d, 2) == pytest.approx(8.0)

    def test_bounds_are_lower_bounds(self):
        for seed in range(4):
            dag = production_dag(np.random.default_rng(100 + seed))
            m = 4
            lb = new_lb(dag, m)
            for scheme_makespan in [
                simulate_execution(dag, m, order=bfs_order(dag)),
                simulate_execution(dag, m, policy="tetris"),
            ]:
                assert scheme_makespan >= lb * 0.999

    def test_newlb_tightest(self):
        for seed in range(4):
            dag = production_dag(np.random.default_rng(200 + seed))
            b = all_bounds(dag, 4)
            assert b["newlb"] >= max(b["cplen"], b["twork"]) - 1e-9


class TestOnline:
    def _tasks(self, n, group=0, pri=None):
        return [PendingTask(job_id=group, task_id=i,
                            demand=np.array([0.3, 0.3, 0.1, 0.1]),
                            duration=1.0,
                            pri_score=(pri[i] if pri is not None else 1.0))
                for i in range(n)]

    def test_bundling_fills_machine(self):
        m = Matcher(MatcherConfig(), capacity=10, shares={0: 1.0})
        jobs = {0: JobView(0, 0, 10.0)}
        picks = m.find_tasks_for_machine(0, np.ones(4), self._tasks(8), jobs)
        assert len(picks) == 3  # 0.3 cores each -> 3 fit

    def test_overbooking_only_fungible(self):
        cfg = MatcherConfig(max_overbook=1.5)
        m = Matcher(cfg, capacity=10, shares={0: 1.0})
        jobs = {0: JobView(0, 0, 1.0)}
        t_net = [PendingTask(0, 0, np.array([0.1, 0.1, 0.9, 0.1]), 1.0)]
        picks = m.find_tasks_for_machine(0, np.array([1.0, 1.0, 0.5, 1.0]),
                                         t_net, jobs)
        assert picks and picks[0][1] is True  # overbooked network
        t_cpu = [PendingTask(0, 0, np.array([0.9, 0.1, 0.1, 0.1]), 1.0)]
        picks = m.find_tasks_for_machine(0, np.array([0.5, 1.0, 1.0, 1.0]),
                                         t_cpu, jobs)
        assert not picks  # cores are rigid

    def test_deficit_bounds_unfairness(self):
        dc = DeficitCounters({0: 1.0, 1: 1.0}, capacity=10, kappa=0.1)
        for _ in range(10):
            dc.allocated(0, 1.0)  # group 0 hogs
        g, d = dc.most_deprived()
        assert g == 1
        assert dc.must_serve() == 1  # deficit 5 >= kappa*C = 1

    def test_set_groups_add_remove_mid_run(self):
        dc = DeficitCounters({0: 1.0, 1: 1.0}, capacity=10, kappa=0.1)
        for _ in range(4):
            dc.allocated(0, 1.0)          # group 0 hogs -> 1 deprived
        assert dc.must_serve() == 1
        # a queue joins mid-run: zero deficit, shares renormalized
        dc.set_groups({0: 1.0, 1: 1.0, 2: 2.0})
        assert dc.deficit[2] == 0.0
        assert abs(sum(dc.share.values()) - 1.0) < 1e-12
        assert dc.share[2] == pytest.approx(0.5)
        assert dc.must_serve() == 1       # existing deprivation survives churn
        # the deprived queue leaves: its deficit is dropped entirely
        dc.set_groups({0: 1.0, 2: 1.0})
        assert 1 not in dc.deficit and 1 not in dc.share
        assert set(dc.deficit) == {0, 2}
        for _ in range(6):
            dc.allocated(0, 1.0)
        assert dc.must_serve() == 2
        # each allocation is conservative: shares sum to 1, so one call
        # moves the total deficit by sum(share)*w - w = 0
        before = sum(dc.deficit.values())
        dc.allocated(2, 1.0)
        assert sum(dc.deficit.values()) == pytest.approx(before)

    def test_jain_index_edge_cases(self):
        dc = DeficitCounters({0: 1.0, 1: 3.0}, capacity=10, kappa=0.1)
        # zero usage everywhere -> degenerate window counts as fair
        assert dc.jain_index({}) == 1.0
        assert dc.jain_index({0: 0.0, 1: 0.0}) == 1.0
        # usage proportional to share -> perfectly fair
        assert dc.jain_index({0: 1.0, 1: 3.0}) == pytest.approx(1.0)
        # one group starved -> n-group worst case is 1/n
        assert dc.jain_index({0: 4.0, 1: 0.0}) == pytest.approx(0.5)
        # single group is always perfectly fair, whatever its usage
        solo = DeficitCounters({7: 2.0}, capacity=4, kappa=0.1)
        assert solo.jain_index({7: 0.0}) == 1.0
        assert solo.jain_index({7: 123.0}) == pytest.approx(1.0)

    def test_priority_steers_choice(self):
        m = Matcher(MatcherConfig(use_srpt=False), capacity=10, shares={0: 1.0})
        jobs = {0: JobView(0, 0, 1.0)}
        pri = np.array([0.1, 0.9, 0.5])
        tasks = self._tasks(3, pri=pri)
        picks = m.find_tasks_for_machine(0, np.ones(4), tasks, jobs)
        assert picks[0][0].task_id == 1  # highest priScore first


class TestAgainstReference:
    """The port's builder outputs equal the reference's on the same DAGs."""

    @pytest.mark.parametrize("seed", [0, 7])
    def test_schedule_equals_reference(self, seed):
        dag = production_dag(np.random.default_rng(seed), scale=0.4)
        jdag = j_production_dag(np.random.default_rng(seed), scale=0.4)
        a = build_schedule(dag, m=4, device="cpu")
        b = j_build_schedule(jdag, m=4)
        assert a.makespan == b.makespan
        assert np.array_equal(a.start, b.start)
        assert np.array_equal(a.machine, b.machine)
        assert np.array_equal(a.order, b.order)

    def test_candidates_and_frag_scores_equal_reference(self):
        for seed in (3, 5):
            dag = production_dag(np.random.default_rng(seed))
            jdag = j_production_dag(np.random.default_rng(seed))
            got, want = candidate_troublesome(dag, m=4), j_candidates(jdag,
                                                                     m=4)
            assert len(got) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
            assert np.array_equal(frag_scores(dag, 4), j_frag_scores(jdag, 4))

    def test_bounds_equal_reference(self):
        for seed in range(200, 204):
            dag = production_dag(np.random.default_rng(seed))
            jdag = j_production_dag(np.random.default_rng(seed))
            assert all_bounds(dag, 4) == j_all_bounds(jdag, 4)
