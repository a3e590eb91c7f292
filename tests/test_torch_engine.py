"""The port's placement engine and space (``repro_torch.core.engine``,
``repro_torch.core.space``) on the CPU: a twin of ``tests/test_engine.py``.

Every test runs under ``kernels.use_device("cpu")``, so the scans take the
plain torch route.  On the reference's own seeded DAGs the port's
backends place tick for tick as the reference's backend does (schedules
equal by ``==``: makespan, starts, machines, order); the scan's plain
route equals ``Space._fit_starts`` and the reference's ``scan_starts``;
the Space and partition edge cases hold on the port's classes and, where
the reference computes the same thing, equal its results.

Left out on purpose: the reference's jit backend is ``jax.jit`` over XLA
(the port dropped the xla impls); the port's ``jit`` backend is the
resident-mirror one, held here against the port's batched backend.  The
production parity runs at every fifth of the reference's 20 seeds, so
the file stays near 15 s on one thread.
"""

import numpy as np
import pytest
import torch

from repro.core import Space as JSpace
from repro.core import build_schedule as j_build_schedule
from repro.core import get_backend as j_get_backend
from repro.core.engine import BACKWARD as J_BACKWARD
from repro.core.engine import FORWARD as J_FORWARD
from repro.core.engine import PeerTask as JPeerTask
from repro.core.engine import scan_starts as j_scan_starts
from repro.sim.workload import production_dag as j_production_dag
from repro.sim.workload import query_dag as j_query_dag
from repro_torch.core import (DAG, Space, available_backends, build_schedule,
                              get_backend)
from repro_torch.core.builder import partition_totally_ordered
from repro_torch.core.engine import (BACKWARD, FORWARD, PeerTask,
                                     scan_starts)
from repro_torch.core.engine import kernels as tk
from repro_torch.core.engine.base import ceil32
from repro_torch.sim.workload import production_dag, query_dag


@pytest.fixture(autouse=True)
def _cpu():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with tk.use_device("cpu"):
        yield
    torch.set_num_threads(prev)


def _assert_same_schedule(a, b, ctx=""):
    assert a.makespan == b.makespan, f"makespan differs {ctx}"
    assert np.array_equal(a.start, b.start), f"starts differ {ctx}"
    assert np.array_equal(a.machine, b.machine), f"machines differ {ctx}"
    assert np.array_equal(a.order, b.order), f"order differs {ctx}"


class TestBackendParity:
    @pytest.mark.parametrize("seed", range(0, 20, 5))
    def test_production_dags_tick_identical(self, seed):
        """The port's batched backend against the reference's reference
        backend (per-task grid rescans, the semantic oracle), bit for bit,
        on the reference's seeded production DAGs."""
        want = j_build_schedule(
            j_production_dag(np.random.default_rng(seed), scale=0.35,
                             share=3), 3, ticks=96, backend="reference")
        dag = production_dag(np.random.default_rng(seed), scale=0.35, share=3)
        bat = build_schedule(dag, 3, ticks=96, backend="batched",
                             device="cpu")
        _assert_same_schedule(want, bat, f"(production seed={seed})")

    @pytest.mark.parametrize("seed", [2])
    def test_port_reference_backend_tick_identical(self, seed):
        dag = production_dag(np.random.default_rng(seed), scale=0.35, share=3)
        ref = build_schedule(dag, 3, ticks=96, backend="reference",
                             device="cpu")
        bat = build_schedule(dag, 3, ticks=96, backend="batched",
                             device="cpu")
        _assert_same_schedule(ref, bat, f"(production seed={seed})")

    @pytest.mark.parametrize("seed", range(4))
    def test_tpcds_dags_tick_identical(self, seed):
        """TPC-DS style DAGs have low-jitter stages: the hint path."""
        want = j_build_schedule(
            j_query_dag(np.random.default_rng(seed), preset="tpcds"), 4,
            ticks=128, backend="reference")
        dag = query_dag(np.random.default_rng(seed), preset="tpcds")
        bat = build_schedule(dag, 4, ticks=128, backend="batched",
                             device="cpu")
        _assert_same_schedule(want, bat, f"(tpcds seed={seed})")

    @pytest.mark.parametrize("seed", [0, 7])
    def test_jit_backend_tick_identical(self, seed):
        dag = production_dag(np.random.default_rng(seed), scale=0.35, share=3)
        bat = build_schedule(dag, 3, ticks=96, backend="batched",
                             device="cpu")
        jit = build_schedule(dag, 3, ticks=96, backend="jit", device="cpu")
        _assert_same_schedule(bat, jit, f"(jit seed={seed})")

    @staticmethod
    def _grid_edge(space_cls, backend, forward):
        s = space_cls(m=1, d=1, horizon=10)
        s.commit(0, 0, 0, 9, np.array([1.0]))  # cells 0-8 fully busy
        sess = backend.session(s, forward)
        return sess.place(1, np.array([0.5]), 2, 0, (0, 0.0, b"x"))

    def test_grid_edge_growth_rescan(self):
        """Starts whose run straddles the grid edge are cleared in the
        window bitmap; after growth they are rescanned, not skipped."""
        want = self._grid_edge(JSpace, j_get_backend("reference"),
                               J_FORWARD)
        got = {name: self._grid_edge(Space, get_backend(name), FORWARD)
               for name in ("reference", "batched")}
        assert got["batched"] == got["reference"] == want == (0, 9)

    @staticmethod
    def _peer_growth(space_cls, backend, backward, peer_cls):
        s = space_cls(m=1, d=1, horizon=10)
        sess = backend.session(s, backward)
        # placing A announces peer B with an estimated deadline of 10; B's
        # bitmap clears starts 5..6 only because their runs crossed the
        # then-grid end
        peers = [peer_cls(tid=2, anchor=10, demand=np.array([0.5]),
                          dur_ticks=6)]
        a = sess.place(1, np.array([0.5]), 2, 8, (0, 0.0, b"a"),
                       peers_fn=lambda: peers)
        s.commit(1, a[0], a[1], 2, np.array([0.5]))
        # B's real deadline is 12: the grid grows and start 6 now fits
        return sess.place(2, np.array([0.5]), 6, 12, (1, 0.0, b"b"))

    def test_backward_peer_cache_growth_rescan(self):
        """Backward mirror of the grid-edge rule: peer starts scanned when
        the grid was shorter are settled live once the deadline grows."""
        want = self._peer_growth(JSpace, j_get_backend("reference"),
                                 J_BACKWARD, JPeerTask)
        got = {name: self._peer_growth(Space, get_backend(name), BACKWARD,
                                       PeerTask)
               for name in ("reference", "batched")}
        assert got["batched"] == got["reference"] == want
        assert want[1] == 6

    def test_registry(self):
        names = available_backends()
        assert {"reference", "batched", "jit"} <= set(names)
        assert get_backend("batched").name == "batched"
        with pytest.raises(ValueError):
            get_backend("no-such-backend")


def _cluttered(space_cls, seed=3):
    rng = np.random.default_rng(seed)
    s = space_cls(m=3, d=2, horizon=64)
    for t in range(25):  # clutter the grid
        v = rng.uniform(0.1, 0.6, 2)
        m, t0 = s.earliest_fit(v, int(rng.integers(1, 6)),
                               int(rng.integers(0, 40)))
        s.commit(t, m, t0, 3, v)
    return s, rng


class TestScanKernel:
    def test_matches_fit_starts(self):
        """The scan's plain torch route over a window == the Space's
        fit_starts, == the numpy impl, == the reference's scan_starts on
        the reference's grid (cluttered the same way)."""
        assert tk.resolve("scan")[0] == "torch"
        s, rng = _cluttered(Space)
        js, _ = _cluttered(JSpace)
        assert np.array_equal(s.avail, js.avail)
        Vs = rng.uniform(0.2, 0.7, (5, 2))
        ks = rng.integers(1, 9, 5)
        goods = tk.scan(s.avail, Vs, ks, 0, s.T)
        assert np.array_equal(goods, scan_starts(s.avail, Vs, ks, 0, s.T))
        assert np.array_equal(goods, j_scan_starts(js.avail, Vs, ks, 0,
                                                   js.T))
        for g in range(5):
            ms, ts = s._fit_starts(Vs[g], int(ks[g]), -s.off, s.T - s.off)
            expect = np.zeros((s.T, s.m), dtype=bool)
            expect[ts + s.off, ms] = True
            assert np.array_equal(goods[g].reshape(s.T, s.m), expect)

    def test_reverse_layout(self):
        s = Space(m=2, d=1, horizon=16)
        s.commit(0, 0, 0, 16, np.array([1.0]))  # machine 0 fully busy
        good = tk.scan(s.avail, np.array([[0.5]]), np.array([4]), 0, 13,
                       reverse=True)
        grid = good.reshape(13, 2)
        # row j is start t = 12 - j; machine 1 free everywhere, machine 0
        # never
        assert grid[:, 1].all() and not grid[:, 0].any()

    def test_ceil32_equivalence(self):
        rng = np.random.default_rng(0)
        a = rng.uniform(0, 1, 4096).astype(np.float32)
        v = rng.uniform(0, 1, 4096)
        assert np.array_equal(a >= v, a >= ceil32(v))
        assert ceil32(a) is a  # float32 passes through untouched


class TestSpaceEdgeCases:
    @pytest.mark.parametrize("space_cls", [Space, JSpace],
                             ids=["port", "reference"])
    def test_grow_front_offset_bookkeeping(self, space_cls):
        s = space_cls(m=1, d=1, horizon=8)
        s.commit(0, 0, 2, 3, np.array([0.5]))
        before = s.avail[0, :, 0].copy()
        off0 = s.off
        s._grow_front()
        assert s.off == off0 + 8 and s.T == 16
        # logical content preserved: old cells shifted by the growth
        assert np.array_equal(s.avail[0, 8:, 0], before)
        assert (s.avail[0, :8, 0] == 1.0).all()
        # committed region still visible at the same logical coords
        assert not s.check_fit_exact(0, 2, 3, np.array([0.6]))
        assert s.check_fit_exact(0, 2, 3, np.array([0.5]))

    def test_grow_back_keeps_logical_coords(self):
        s = Space(m=1, d=1, horizon=8)
        s.commit(0, 0, 0, 4, np.array([0.9]))
        s._grow_back()
        assert s.T == 16 and s.off == 0
        assert s.check_fit_exact(0, 4, 12, np.array([0.9]))
        assert not s.check_fit_exact(0, 0, 4, np.array([0.2]))

    def test_hint_soundness_earliest(self):
        """A prior identical placement is a sound floor: with or without
        the hint, earliest_fit returns the same slot, and the same slot as
        the reference's Space on the same sequence."""
        rng = np.random.default_rng(1)
        s = Space(m=3, d=2, horizon=64)
        js = JSpace(m=3, d=2, horizon=64)
        v = np.array([0.55, 0.35])
        hint = None
        for t in range(12):
            plain = s.clone().earliest_fit(v, 4, 2)
            hinted = s.earliest_fit(v, 4, 2, hint)
            assert plain == hinted == js.earliest_fit(v, 4, 2, hint)
            s.commit(t, *hinted, 4, v)
            js.commit(t, *hinted, 4, v)
            hint = hinted
            if rng.random() < 0.5:  # unrelated clutter never breaks it
                w = rng.uniform(0.05, 0.3, 2)
                m2, t2 = s.earliest_fit(w, 2, 0)
                s.commit(100 + t, m2, t2, 2, w)
                js.commit(100 + t, m2, t2, 2, w)
        assert np.array_equal(s.avail, js.avail)

    def test_hint_soundness_latest(self):
        s = Space(m=2, d=1, horizon=40)
        js = JSpace(m=2, d=1, horizon=40)
        v = np.array([0.7])
        hint = None
        for t in range(6):
            plain = s.clone().latest_fit(v, 3, 30)
            hinted = s.latest_fit(v, 3, 30, hint)
            assert plain == hinted == js.latest_fit(v, 3, 30, hint)
            s.commit(t, *hinted, 3, v)
            js.commit(t, *hinted, 3, v)
            hint = hinted

    def test_fit_first_matches_full_scan(self):
        rng = np.random.default_rng(5)
        s = Space(m=2, d=2, horizon=48)
        js = JSpace(m=2, d=2, horizon=48)
        for t in range(30):
            v = rng.uniform(0.2, 0.8, 2)
            k = int(rng.integers(1, 5))
            m, t0 = s.earliest_fit(v, k, 0)
            s.commit(t, m, t0, k, v)
            js.commit(t, m, t0, k, v)
        for _ in range(40):
            v = rng.uniform(0.2, 0.9, 2)
            k = int(rng.integers(1, 7))
            lo, hi = 0, s.T - s.off - k
            ms, ts = s._fit_starts(v, k, lo, hi + k)
            first = s.fit_first(v, k, lo, hi)
            latest = s.fit_first(v, k, lo, hi, latest=True)
            assert first == js.fit_first(v, k, lo, hi)
            assert latest == js.fit_first(v, k, lo, hi, latest=True)
            if len(ts) == 0:
                assert first is None and latest is None
            else:
                tmin, tmax = int(ts.min()), int(ts.max())
                assert first == (int(ms[ts == tmin].min()), tmin)
                assert latest == (int(ms[ts == tmax].min()), tmax)

    def test_snapshot_restore_exact(self):
        s = Space(m=2, d=2, horizon=16)
        s.commit(0, 0, 0, 4, np.array([0.3, 0.4]))
        snap = s.snapshot()
        grid0 = s.avail.copy()
        # commits, growth in both directions, nested snapshot/rollback
        s.commit(1, 1, 2, 5, np.array([0.6, 0.1]))
        s.latest_fit(np.array([0.5, 0.5]), 40, 8)     # forces front growth
        inner = s.snapshot()
        s.commit(2, 0, -3, 2, np.array([0.2, 0.2]))
        s.restore(inner)
        s._grow_back()
        s.commit(3, 1, 30, 4, np.array([0.9, 0.9]))   # in back-grown region
        s.restore(snap)
        assert s.T == grid0.shape[1] and len(s.placements) == 1
        assert np.array_equal(s.avail, grid0)
        assert s.makespan_ticks == 4

    def test_restore_keep_extent(self):
        s = Space(m=1, d=1, horizon=8)
        snap = s.snapshot()
        s._grow_back()
        s.commit(0, 0, 10, 2, np.array([0.5]))
        s.restore(snap, keep_extent=True)
        assert s.T == 16 and len(s.placements) == 0
        assert (s.avail == 1.0).all()


class TestPartitionEdgeCases:
    def test_single_task(self):
        d = DAG(duration=np.array([2.0]), demand=np.array([[0.5, 0.5]]),
                stage_of=np.array([0]), parents=[np.array([], int)])
        parts = partition_totally_ordered(d)
        assert len(parts) == 1 and list(parts[0]) == [0]
        sched = build_schedule(d, 2, device="cpu")
        assert sched.makespan == pytest.approx(2.0)

    def test_fully_parallel(self):
        n = 6
        d = DAG(duration=np.full(n, 1.0), demand=np.full((n, 2), 0.4),
                stage_of=np.zeros(n, int),
                parents=[np.array([], int) for _ in range(n)])
        parts = partition_totally_ordered(d)
        assert len(parts) == 1  # no barrier anywhere: nothing is ordered
        sched = build_schedule(d, 3, device="cpu")
        sched.validate()

    def test_empty_dag(self):
        d = DAG(duration=np.empty(0), demand=np.empty((0, 2)),
                stage_of=np.empty(0, int), parents=[])
        sched = build_schedule(d, 2, device="cpu")
        assert sched.makespan == 0.0
