"""The port's device-resident placement backend (``core/engine/jit.py``) and
the explicit-only ops' torch impls, on the CPU, against the reference.

Twins of ``tests/test_placement_kernels.py::TestDeviceResidentSession``:
the resident scan under 60 rounds of commits, restores and growth equals
the reference's numpy scan of the same grid, rows read after later commits
show the grid at launch, a batch of one, and a build forced through the
device path equals the reference's ``batched`` build.  XLA's compile cache
has no CUDA counterpart; its two tests become "a warm rebuild reallocates no
mirror" and "reallocations grow logarithmically in T", and one more holds
that only the dirty ticks go up.  Twins of ``TestHeartbeatSuperset``
(``:213``, ``:227``, ``:247``, ``:261``) hold ``heartbeat_masks``,
``fits_mask`` and ``pack_score``'s torch impls against the numpy oracles
and against the reference's xla impls.  On the CPU the mirror is a CPU
tensor and the scans run the plain version; the card's route is in
``tests/test_torch_gpu.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro.core import Space as JSpace
from repro.core import build_schedule as j_build_schedule
from repro.core.engine import kernels as jk
from repro.sim import make_workload as j_make_workload
from repro.sim import run_workload as j_run_workload
from repro.sim.workload import production_dag as j_production_dag

from repro_torch.core import Space, build_schedule
from repro_torch.core.dag import dag_from_arrays
from repro_torch.core.engine import JitBackend, kernels, packing
from repro_torch.core.engine import jit as J
from repro_torch.core.engine.base import ceil32
from repro_torch.sim import make_workload, run_workload

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with kernels.use_device("cpu"):
        yield


def _drain(goods, g):
    """Materialize a scan_kernel result (ndarray or lazy loaders)."""
    if isinstance(goods, np.ndarray):
        return goods
    return np.stack([goods[i]() for i in range(g)])


def _port(d):
    return dag_from_arrays(d.duration, d.demand, d.stage_of, d.parents,
                           d.name)


class TestResidentSession:
    def test_device_scan_matches_reference_under_mutation(self, monkeypatch):
        """The same commits, growths and restores on a port Space and a
        reference Space: every resident scan equals the reference's numpy
        scan of its grid."""
        monkeypatch.setattr(J, "MIN_DEVICE_G", 1)
        J.reset_profile()
        be = JitBackend()
        rng = np.random.default_rng(9)
        s, js = Space(m=4, d=3, horizon=64), JSpace(m=4, d=3, horizon=64)
        snaps = []
        for round_ in range(60):
            op = rng.random()
            if op < 0.5:
                v = rng.uniform(0.1, 0.5, 3)
                k = int(rng.integers(1, 10))
                mm, t0 = s.earliest_fit(v, k, int(rng.integers(0, 40)))
                s.commit(round_, mm, t0, k, v)
                js.commit(round_, mm, t0, k, v)
            elif op < 0.6:
                front = rng.random() < 0.5
                (s._grow_front if front else s._grow_back)()
                (js._grow_front if front else js._grow_back)()
            elif op < 0.75 or not snaps:
                snaps.append((s.snapshot(), js.snapshot()))
            else:
                a, b = snaps.pop()
                s.restore(a)
                js.restore(b)
            assert np.array_equal(s.avail, js.avail)
            g = int(rng.integers(2, 12))
            Vs = ceil32(rng.uniform(0.2, 0.7, (g, 3)))
            ks = rng.integers(1, 12, g)
            plo = int(rng.integers(0, max(s.T - 10, 1)))
            phi = int(rng.integers(plo + 2, s.T))
            rev = bool(rng.integers(0, 2))
            got = _drain(be.scan_kernel(s, Vs, ks, plo, phi, rev), g)
            want = jk.scan_starts(js.avail, Vs, ks, plo, phi, rev)
            assert np.array_equal(got, want), f"mirror != reference " \
                f"(round {round_})"
        assert J.PROFILE["device_calls"] == 60
        assert J.PROFILE["fallback_calls"] == 0

    def test_async_rows_capture_launch_state(self, monkeypatch):
        """A lazy row materialized AFTER later commits must reflect the
        grid as of the launch, exactly like a synchronous scan would."""
        monkeypatch.setattr(J, "MIN_DEVICE_G", 1)
        be = JitBackend()
        s, js = Space(m=2, d=1, horizon=32), JSpace(m=2, d=1, horizon=32)
        Vs = ceil32(np.full((3, 1), 0.6))
        ks = np.array([2, 2, 2])
        goods = be.scan_kernel(s, Vs, ks, 0, 16, False)
        want = jk.scan_starts(js.avail, Vs, ks, 0, 16, False)
        s.commit(0, 0, 0, 16, np.array([1.0]))   # machine 0 now fully busy
        # a second launch uploads the new state before the first is read
        later = _drain(be.scan_kernel(s, Vs, ks, 0, 16, False), 3)
        assert not np.array_equal(later, want)
        assert np.array_equal(_drain(goods, 3), want), \
            "lazy row leaked post-launch state"

    def test_min_batch_one_single_task_scan(self, monkeypatch):
        """A floor of 1 must not crash g=1 scans: the hybrid split needs a
        peer row, so singletons take the dispatch layer."""
        monkeypatch.setattr(J, "MIN_DEVICE_G", 1)
        J.reset_profile()
        be = JitBackend()
        s = Space(m=2, d=1, horizon=32)
        Vs = ceil32(np.full((1, 1), 0.5))
        got = be.scan_kernel(s, Vs, np.array([3]), 0, 16, False)
        want = jk.scan_starts(JSpace(m=2, d=1, horizon=32).avail, Vs,
                              np.array([3]), 0, 16, False)
        assert np.array_equal(_drain(got, 1), want)
        assert J.PROFILE["fallback_calls"] == 1

    def test_only_dirty_ticks_go_up(self, monkeypatch):
        """After a first scan syncs the window, a commit of k ticks makes
        the next scan upload those k ticks and nothing else."""
        monkeypatch.setattr(J, "MIN_DEVICE_G", 1)
        be = JitBackend()
        s = Space(m=3, d=2, horizon=128)
        Vs = ceil32(np.full((4, 2), 0.3))
        ks = np.array([3, 3, 5, 5])
        _drain(be.scan_kernel(s, Vs, ks, 0, 64, False), 4)
        J.reset_profile()
        _drain(be.scan_kernel(s, Vs, ks, 0, 64, False), 4)
        assert J.PROFILE["sync_cells"] == 0            # nothing changed
        s.commit(0, 1, 20, 7, np.array([0.5, 0.5]))
        _drain(be.scan_kernel(s, Vs, ks, 0, 64, False), 4)
        assert J.PROFILE["sync_cells"] == 3 * 7 * 2    # m * k * d
        assert J.PROFILE["allocs"] == 0

    def test_warm_rebuild_reallocates_no_mirror(self, monkeypatch):
        """Replaces the reference's compile-cache test: a rebuild of a DAG
        allocates one mirror per Space as the first build did, and no
        mirror of either build had to regrow."""
        monkeypatch.setattr(J, "MIN_DEVICE_G", 2)
        dag = _port(j_production_dag(np.random.default_rng(5), scale=0.35,
                                     share=3))
        counts = []
        for _ in range(2):
            J.reset_profile()
            build_schedule(dag, 3, backend="jit", device="cpu")
            counts.append(dict(J.PROFILE))
        assert counts[1]["device_calls"] > 0
        assert counts[1]["reallocs"] == counts[0]["reallocs"] == 0
        assert counts[1]["allocs"] == counts[0]["allocs"]

    def test_reallocations_grow_logarithmically_in_T(self, monkeypatch):
        """Replaces the reference's bounded bucket cache: a grid doubling
        six times, scanned at its far end each time, regrows its mirror
        at most once per doubling past the first buffer."""
        monkeypatch.setattr(J, "MIN_DEVICE_G", 1)
        J.reset_profile()
        be = JitBackend()
        s = Space(m=2, d=2, horizon=64)
        Vs = ceil32(np.full((3, 2), 0.3))
        ks = np.array([2, 4, 8])
        tb0 = None
        for _ in range(7):
            plo = s.T - 40
            got = _drain(be.scan_kernel(s, Vs, ks, plo, plo + 30, False), 3)
            assert np.array_equal(
                got, kernels.scan_starts(s.avail, Vs, ks, plo, plo + 30))
            tb0 = tb0 or s._device_grid.Tb
            s._grow_back()
        grid = s._device_grid
        assert grid.Tb >= s.T // 2
        assert J.PROFILE["reallocs"] <= math.log2(grid.Tb / tb0)
        assert J.PROFILE["allocs"] == J.PROFILE["reallocs"] + 1

    def test_jit_build_parity_device_path_forced(self, monkeypatch):
        monkeypatch.setattr(J, "MIN_DEVICE_G", 2)
        J.reset_profile()
        ref = j_production_dag(np.random.default_rng(3), scale=0.35, share=3)
        want = j_build_schedule(ref, 3, ticks=96, backend="batched")
        got = build_schedule(_port(ref), 3, ticks=96, backend="jit",
                             device="cpu")
        assert got.makespan == want.makespan
        assert np.array_equal(got.start, want.start)
        assert np.array_equal(got.machine, want.machine)
        assert J.PROFILE["device_calls"] > 0, "device path never exercised"

    def test_sim_with_the_jit_backend_matches_reference(self):
        """The simulator's builds through the jit backend (default floor on
        the CPU) make the reference's batched decisions."""
        kw = dict(n_machines=8, interarrival=5.0, seed=4)
        want = j_run_workload(j_make_workload("tpch", 3, seed=4), "dagps",
                              placement_backend="batched", **kw)
        J.reset_profile()
        got = run_workload(make_workload("tpch", 3, seed=4), "dagps",
                           placement_backend="jit", device="cpu", **kw)
        assert [repr(j.jct) for j in got.jobs] == \
            [repr(j.jct) for j in want.jobs]
        assert got.makespan == want.makespan
        assert J.PROFILE["device_calls"] + J.PROFILE["fallback_calls"] > 0


class TestHeartbeatSuperset:
    """The explicit-only ops' torch impls: sound where the contract says
    so, equal to the reference's xla impls (the same directed rounding),
    and never on a path."""

    FD, RD, GD = np.arange(4), np.array([0, 1]), np.array([2, 3])

    @staticmethod
    def _rand_state(rng, n, m, d=4):
        return rng.uniform(-0.05, 1.0, (m, d)), rng.uniform(0.0, 0.9, (n, d))

    def test_heartbeat_masks_union_superset(self):
        rng = np.random.default_rng(6)
        for _ in range(10):
            avail, dem = self._rand_state(rng, 8, 12)
            for slack, ob in ((0.25, True), (0.0, True), (0.25, False)):
                args = (avail, dem, self.FD, self.RD, self.GD, slack, ob)
                fits_e, over_e = packing.heartbeat_masks(*args)
                fits_t, over_t = kernels._heartbeat_masks_on(*args,
                                                             device="cpu")
                # only the union is contract-bearing
                assert ((fits_e | over_e) <= (fits_t | over_t)).all()
                assert (fits_e <= fits_t).all()
                fits_x, over_x = jk._heartbeat_masks_xla(*args)
                assert np.array_equal(fits_t, fits_x)
                assert np.array_equal(over_t, over_x)

    def test_fits_mask_and_pack_score_shapes(self):
        rng = np.random.default_rng(8)
        avail = rng.uniform(0, 1, (5, 4))
        dem = rng.uniform(0, 0.8, (3, 4))
        fm = lambda *a, **k: kernels._fits_mask_on(*a, device="cpu", **k)
        ps = lambda *a, **k: kernels._pack_score_on(*a, device="cpu", **k)
        assert (packing.fits_mask(avail, dem) <= fm(avail, dem)).all()
        assert (packing.fits_mask(avail[0], dem[0])
                <= fm(avail[0], dem[0])).all()
        assert fm(avail, dem, dims=np.empty(0, int)).all()
        got = fm(avail, dem, dims=[0, 2], slack=0.1)
        assert got.shape == (3, 5)
        assert np.array_equal(got, jk._fits_mask_xla(avail, dem, dims=[0, 2],
                                                     slack=0.1))
        assert fm(avail, dem[0]).shape == (5,)
        # float32 products: close to, not identical with, the oracle
        np.testing.assert_allclose(ps(avail, dem),
                                   packing.pack_score(avail, dem), rtol=1e-5)
        np.testing.assert_allclose(ps(avail[0], dem, clip=True),
                                   packing.pack_score(avail[0], dem,
                                                      clip=True), rtol=1e-5)
        np.testing.assert_allclose(ps(avail, dem), jk._pack_score_xla(
            avail, dem), rtol=1e-6)

    def test_empty_candidate_batch_shapes(self):
        avail = np.ones((3, 4))
        dem = np.empty((0, 4))
        fits, over = kernels._heartbeat_masks_on(
            avail, dem, self.FD, self.RD, self.GD, 0.25, True, device="cpu")
        assert fits.shape == over.shape == (0, 3)
        elig, any_m = kernels._machines_with_candidates_on(
            avail, dem, self.FD, self.RD, self.GD, 0.25, True, device="cpu")
        assert elig.shape == (0, 3) and any_m.shape == (3,)

    def test_explicit_only_ops_stay_off_every_path(self, monkeypatch):
        """``all=`` leaves the three ops on numpy; pinned explicitly they
        resolve to torch, and still no path calls them: the simulator's
        decisions equal the reference's run."""
        kw = dict(n_machines=12, interarrival=5.0, seed=5,
                  matcher_mode="routed")
        monkeypatch.delenv(kernels.KERNELS_ENV, raising=False)
        want = j_run_workload(j_make_workload("tpcds", 4, seed=5), "dagps",
                              **kw)
        monkeypatch.setenv(kernels.KERNELS_ENV, "all=torch")
        assert {kernels.resolve(op)[0] for op in kernels.EXPLICIT_ONLY} \
            == {"numpy"}
        monkeypatch.setenv(kernels.KERNELS_ENV,
                           "heartbeat_masks=torch,fits_mask=torch,"
                           "pack_score=torch")
        assert {kernels.resolve(op)[0] for op in kernels.EXPLICIT_ONLY} \
            == {"torch"}
        kernels.reset_profile()
        got = run_workload(make_workload("tpcds", 4, seed=5), "dagps",
                           device="cpu", **kw)
        assert got.makespan == want.makespan
        assert np.array_equal(got.jcts(), want.jcts())
        prof = kernels.profile_snapshot()
        assert prof["machines_with_candidates.torch"][0] > 0
        assert not any(k.startswith(kernels.EXPLICIT_ONLY) for k in prof)
