"""The port's construction memo (``repro_torch.core.memo``) and the
builder's tie handling on the CPU: a twin of ``tests/test_memo.py``.

The same edge cases of the memo's exactness (set-digest pass keys,
windowed place entries valid only on bit-equal windows, cross-partition
hits, degenerate DAGs) and of frag scores and candidate enumeration, run
on the port's classes; the placement backends' scan ops run their plain
torch versions (`kernels.use_device("cpu")` around every test, and
``device="cpu"`` for `build_schedule`).  The memoized periodic build is
also held against the reference's schedule.
"""

import numpy as np
import pytest
import torch

from repro.core import build_schedule as j_build_schedule
from repro.sim.workload import periodic_dag as j_periodic_dag
from repro_torch.core import DAG, Space, build_schedule, get_backend
from repro_torch.core.builder import (_Placer, _span_lb_ticks,
                                      candidate_troublesome, frag_scores,
                                      partition_totally_ordered)
from repro_torch.core.engine import BACKWARD, FORWARD
from repro_torch.core.engine import kernels as tk
from repro_torch.core.memo import (COUNTERS, ConstructionMemo, item_hash)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tk.use_device("cpu"):
        yield


def _placer(dag, m=2, horizon=64, memo=True):
    space = Space(m, dag.d, horizon)
    mo = ConstructionMemo(space) if memo else None
    k = np.maximum(dag.duration.astype(np.int64), 1)
    return _Placer(dag, space, k, get_backend("batched"), mo), space, mo


def _chain_dag(durs, demand=0.5):
    n = len(durs)
    return DAG(duration=np.asarray(durs, float),
               demand=np.full((n, 2), demand),
               stage_of=np.arange(n),
               parents=[np.empty(0, np.int64)] + [np.array([i]) for i in range(n - 1)])


def _par_dag(durs, demand=0.5):
    n = len(durs)
    return DAG(duration=np.asarray(durs, float),
               demand=np.full((n, 2), demand),
               stage_of=np.zeros(n, np.int64),
               parents=[np.empty(0, np.int64) for _ in range(n)])


class TestPassKeyDigest:
    def test_permuted_ids_same_key_and_same_replay(self):
        """Permuted-but-equal id sets digest identically, and the replayed
        pass is bit-identical to the live one."""
        dag = _par_dag([3, 2, 4, 2, 3])
        pl, space, memo = _placer(dag)
        ids = np.array([0, 1, 2, 3, 4])
        perm = np.array([4, 2, 0, 3, 1])
        assert memo.pass_key(ids, FORWARD) == memo.pass_key(perm, FORWARD)
        assert memo.pass_key(ids, FORWARD) != memo.pass_key(ids, BACKWARD)

        snap = space.snapshot()
        assert pl.place_forward(ids)
        live = [(p.task, p.machine, p.start) for p in space.placements]
        space.restore(snap)
        before = COUNTERS["passes_replayed"]
        pl2 = pl.branch()
        pl2.is_placed[:] = False
        assert pl2.place_forward(perm)       # same set, permuted order
        assert COUNTERS["passes_replayed"] == before + 1
        replay = [(p.task, p.machine, p.start) for p in space.placements]
        assert replay == live

    def test_different_sets_different_keys(self):
        dag = _par_dag([3, 2, 4])
        _pl, _space, memo = _placer(dag)
        a = memo.pass_key(np.array([0, 1]), FORWARD)
        b = memo.pass_key(np.array([0, 2]), FORWARD)
        assert a != b

    def test_item_hash_sensitivity(self):
        """Every component of a placement triple perturbs the hash."""
        h = item_hash(3, 1, 10)
        assert h != item_hash(4, 1, 10)
        assert h != item_hash(3, 2, 10)
        assert h != item_hash(3, 1, 11)
        assert h == item_hash(3, 1, 10)


class TestWindowedPlaceMemo:
    def test_hit_requires_bit_equal_window(self):
        """A commit inside the recorded window invalidates the entry; one
        outside leaves it valid (that is the whole point of windowing)."""
        space = Space(2, 1, 64)
        memo = ConstructionMemo(space)
        vb = np.float32(0.5).tobytes()
        memo.place_put(FORWARD, vb, 3, 0, True, m=0, t0=4)  # window [0, 7)
        assert memo.place_get(FORWARD, vb, 3, 0) == (0, 4)
        snap = space.snapshot()
        space.commit(9, 0, 2, 2, np.array([0.5]))           # inside window
        assert memo.place_get(FORWARD, vb, 3, 0) is None
        space.restore(snap)
        assert memo.place_get(FORWARD, vb, 3, 0) == (0, 4)  # rollback exact
        space.commit(9, 0, 30, 2, np.array([0.5]))          # outside window
        assert memo.place_get(FORWARD, vb, 3, 0) == (0, 4)

    def test_memo_invalidation_after_deadline_growth(self):
        """The stale-bitmap bug class, replayed against the memo: a
        backward placement recorded under a short grid must not leak into
        a query whose deadline grew the grid — the memoized and plain
        builds of both queries stay identical to the reference backend."""
        for memoize in (True, False):
            results = {}
            for name in ("reference", "batched"):
                s = Space(m=1, d=1, horizon=10)
                memo = ConstructionMemo(s) if memoize else None
                dag = _par_dag([2, 6], demand=0.5)
                dag = DAG(duration=np.array([2.0, 6.0]),
                          demand=np.array([[0.5], [0.5]]),
                          stage_of=np.array([0, 1]),
                          parents=[np.empty(0, np.int64), np.empty(0, np.int64)])
                k = np.array([2, 6], dtype=np.int64)
                pl = _Placer(dag, s, k, get_backend(name), memo)
                sess = get_backend(name).session(s, BACKWARD)
                a = sess.place(0, np.array([0.5]), 2, 8, (0, 0.0, b"a"))
                s.commit(0, a[0], a[1], 2, np.array([0.5]))
                # deadline 12 grows the grid past the recorded horizon
                sess2 = get_backend(name).session(s, BACKWARD)
                results[name] = sess2.place(1, np.array([0.5]), 6, 12,
                                            (1, 0.0, b"b"))
            assert results["batched"] == results["reference"]

    def test_anchor_is_part_of_the_key(self):
        space = Space(1, 1, 32)
        memo = ConstructionMemo(space)
        vb = np.float32(0.5).tobytes()
        memo.place_put(FORWARD, vb, 2, 0, True, m=0, t0=0)
        assert memo.place_get(FORWARD, vb, 2, 5) is None
        assert memo.place_get(BACKWARD, vb, 2, 0) is None
        assert memo.place_get(FORWARD, vb, 3, 0) is None


class TestCrossPartitionMemo:
    def test_periodic_dag_hits_across_partitions_bit_identical(self):
        """A recurring-pipeline DAG (identical phases behind barriers)
        splits into identical sub-builds; the content-addressed place memo
        of period 1 must serve periods 2..P — and stay bit-identical to
        the no-memo build on every backend."""
        from repro_torch.core.memo import reset_counters
        from repro_torch.sim.workload import periodic_dag

        dag = periodic_dag(np.random.default_rng(2))
        assert len(partition_totally_ordered(dag)) > 3
        reset_counters()
        memo = build_schedule(dag, 4, memoize=True, device="cpu")
        assert COUNTERS["places_memoized_xpart"] > 0, \
            "cross-partition lever is dead on its home workload"
        plain = build_schedule(dag, 4, memoize=False, device="cpu")
        ref = build_schedule(dag, 4, memoize=False, backend="reference",
                             device="cpu")
        for other in (plain, ref):
            assert memo.makespan == other.makespan
            assert np.array_equal(memo.start, other.start)
            assert np.array_equal(memo.machine, other.machine)

    def test_attach_keeps_place_memo_drops_pass_memo(self):
        s1 = Space(2, 1, 32)
        memo = ConstructionMemo(s1)
        vb = np.float32(0.5).tobytes()
        memo.place_put(FORWARD, vb, 2, 0, True, m=0, t0=0)
        memo.pass_put(memo.pass_key(np.array([0]), FORWARD), 2, [(0, 0, 0)])
        assert len(memo._pass) == 1
        s2 = Space(2, 1, 32)
        memo.attach(s2)
        assert memo.space is s2 and memo._n == 0 and memo.ckey == 0
        assert len(memo._pass) == 0, "pass plans must not cross partitions"
        # the place entry survives and now counts as a cross-partition hit
        before = COUNTERS["places_memoized_xpart"]
        assert memo.place_get(FORWARD, vb, 2, 0) == (0, 0)
        assert COUNTERS["places_memoized_xpart"] == before + 1

    def test_duplicate_slot_digest_multiplicity(self):
        """Two identical tasks legally sharing one (machine, start) slot:
        the additive digest must distinguish 0, 1 and 2 copies (an XOR
        multiset hash cancels the pair — the bug class the periodic
        workload exposed)."""
        space = Space(1, 1, 32)
        memo = ConstructionMemo(space)
        v = np.array([0.3])
        d0 = memo._window_digest(0, 8)
        space.commit(0, 0, 2, 3, v)
        d1 = memo._window_digest(0, 8)
        space.commit(1, 0, 2, 3, v)      # identical content, same slot
        d2 = memo._window_digest(0, 8)
        assert d0 != d1 and d1 != d2 and d0 != d2

    def test_digest_is_content_addressed_not_task_addressed(self):
        """Same (machine, start, k, demand) committed under different task
        ids must digest identically — that is what makes cross-partition
        hits sound."""
        a, b = Space(1, 1, 32), Space(1, 1, 32)
        ma, mb = ConstructionMemo(a), ConstructionMemo(b)
        a.commit(3, 0, 2, 3, np.array([0.4]))
        b.commit(7, 0, 2, 3, np.array([0.4]))   # different task id
        assert ma.ckey == mb.ckey
        b2 = Space(1, 1, 32)
        mb2 = ConstructionMemo(b2)
        b2.commit(7, 0, 2, 3, np.array([0.5]))  # different demand
        assert mb2.ckey != ma.ckey


class TestDegenerateDags:
    def test_zero_task_dag(self):
        d = DAG(duration=np.empty(0), demand=np.empty((0, 2)),
                stage_of=np.empty(0, int), parents=[])
        for memoize in (True, False):
            s = build_schedule(d, 2, memoize=memoize, device="cpu")
            assert s.makespan == 0.0 and len(s.order) == 0

    def test_single_partition_single_task(self):
        d = DAG(duration=np.array([2.0]), demand=np.array([[0.5, 0.5]]),
                stage_of=np.array([0]), parents=[np.empty(0, np.int64)])
        assert len(partition_totally_ordered(d)) == 1
        a = build_schedule(d, 2, memoize=True, device="cpu")
        b = build_schedule(d, 2, memoize=False, device="cpu")
        assert a.makespan == b.makespan == pytest.approx(2.0)
        assert np.array_equal(a.start, b.start)
        assert np.array_equal(a.machine, b.machine)

    def test_span_lb_ticks_degenerate(self):
        d = _chain_dag([2, 3, 4])
        k = np.array([2, 3, 4], dtype=np.int64)
        assert _span_lb_ticks(d, 4, k) == 9          # pure chain
        p = _par_dag([1, 1, 1, 1], demand=1.0)
        kk = np.ones(4, dtype=np.int64)
        assert _span_lb_ticks(p, 2, kk) == 2         # pure work bound


class TestFragAndCandidateTies:
    def test_frag_scores_all_equal_durations(self):
        """All-equal durations collapse the long-score levels to one value;
        frag scores stay in (0, 1] and the sweep still yields candidates."""
        dag = _par_dag([5.0] * 8, demand=0.3)
        fs = frag_scores(dag, 4)
        assert fs.shape == (1,)
        assert 0.0 < fs[0] <= 1.0
        cands = candidate_troublesome(dag, 4)
        assert len(cands) >= 1                       # at least the empty set
        assert not cands[0].any()                    # empty set first
        seen = {c.tobytes() for c in cands}
        assert len(seen) == len(cands)               # deduplicated

    def test_frag_scores_empty_stage(self):
        """A stage index with no tasks keeps its neutral score of 1."""
        d = DAG(duration=np.array([2.0, 3.0]), demand=np.full((2, 2), 0.4),
                stage_of=np.array([0, 2]),           # stage 1 is empty
                parents=[np.empty(0, np.int64), np.empty(0, np.int64)])
        fs = frag_scores(d, 2)
        assert fs.shape == (3,)
        assert fs[1] == 1.0

    def test_candidate_levels_k_larger_than_task_count(self):
        """n_long/n_frag far above the distinct-value count must not
        produce duplicate thresholds or crash the quantile path."""
        dag = _chain_dag([1.0, 2.0, 3.0])
        cands = candidate_troublesome(dag, 2, n_long=50, n_frag=50)
        assert 1 <= len(cands) <= 24
        seen = {c.tobytes() for c in cands}
        assert len(seen) == len(cands)
        for c in cands:                              # all candidates closed
            assert np.array_equal(c, dag.closure_mask(c))

    def test_candidate_zero_duration_guard(self):
        """Degenerate near-zero durations: long_score stays finite."""
        dag = _par_dag([1e-3, 1e-3], demand=0.2)
        cands = candidate_troublesome(dag, 2)
        assert len(cands) >= 1
        sched = build_schedule(dag, 2, device="cpu")
        sched.validate()

    def test_max_candidates_cap_keeps_spread_and_empty(self):
        rng = np.random.default_rng(5)
        from repro_torch.sim.workload import production_dag
        dag = production_dag(rng, scale=0.5, share=4)
        cands = candidate_troublesome(dag, 4, max_candidates=5)
        assert len(cands) <= 5
        assert not cands[0].any()                    # empty set survives


def _space_interleaving_oracle(seed: int, n_ops: int) -> None:
    """Random snapshot/branch/restore interleavings vs a clone oracle.

    Seeded twin of tests/test_property.py::
    test_space_restore_matches_clone_oracle (the hypothesis sweep), kept
    here too so the invariant runs even where hypothesis is absent.
    """
    rng = np.random.default_rng(seed)
    s = Space(m=int(rng.integers(1, 4)), d=int(rng.integers(1, 3)),
              horizon=int(rng.integers(8, 24)))
    stack = []
    tid = 0
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.45:
            v = rng.uniform(0.05, 0.9, s.d)
            k = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                m, t0 = s.earliest_fit(v, k, int(rng.integers(0, 12)))
            else:
                m, t0 = s.latest_fit(v, k, int(rng.integers(4, 16)))
            s.commit(tid, m, t0, k, v)
            tid += 1
        elif op < 0.6:
            (s._grow_front if rng.random() < 0.5 else s._grow_back)()
        elif op < 0.8 or not stack:
            stack.append((s.snapshot(), s.clone()))
        else:
            depth = int(rng.integers(0, len(stack)))
            snap, oracle = stack[depth]
            del stack[depth + 1:]
            s.restore(snap)
            assert s.T == oracle.T and s.off == oracle.off
            assert np.array_equal(s.avail, oracle.avail), \
                "grid not bit-identical to clone oracle after restore"
            assert len(s.placements) == len(oracle.placements)
            assert s._min_start == oracle._min_start
            assert s._max_end == oracle._max_end
    while stack:
        snap, oracle = stack.pop()
        s.restore(snap)
        assert np.array_equal(s.avail, oracle.avail)
        assert s.T == oracle.T and s.off == oracle.off


def test_space_restore_matches_clone_oracle_seeded():
    for seed in range(25):
        _space_interleaving_oracle(seed, 40)


class TestCounters:
    def test_counters_move_and_reset(self):
        from repro_torch.core.memo import counters_snapshot, reset_counters
        reset_counters()
        dag = _par_dag([3, 2, 4, 2, 3])
        build_schedule(dag, 2, memoize=True, device="cpu")
        snap = counters_snapshot()
        assert snap["passes_run"] > 0
        assert snap["places_evaluated"] > 0
        reset_counters()
        assert sum(counters_snapshot().values()) == 0


def test_periodic_build_equals_reference():
    """The memoized periodic build (cross-partition hits) is the
    reference's memoized build, start for start."""
    from repro_torch.sim.workload import periodic_dag
    dag = periodic_dag(np.random.default_rng(2))
    a = build_schedule(dag, 4, memoize=True, device="cpu")
    b = j_build_schedule(j_periodic_dag(np.random.default_rng(2)), 4,
                         memoize=True)
    assert a.makespan == b.makespan
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.machine, b.machine)
