"""Twins of ``tests/test_shard.py`` on the port's sharded online matcher
(``repro_torch.core.shard``), on the CPU.

Each twin hands the same numpy inputs (made from a seed) to both
packages and asserts the reference test's own properties on the port and
its results equal to the reference's:

  * the machine partition (``ShardPlan``) and the automatic shard count
    (``auto_shards``) field for field;
  * ``route_exposure``'s per-shard rows equal, proportional, in order;
  * the deficit handoff against the single-shard oracle: merged deficits
    equal to the reference's after every step, the composed bound under
    serve-on-trigger, opposite signs netted out;
  * the sharded eligibility (``REPRO_KERNELS=machines_with_candidates=
    numpy``, the exact oracle the reference runs at this size) equal to
    one global launch and to the reference's;
  * simulator decisions invariant across 1, 2 and 4 shards, under churn
    (1 and 3), and under churn with a recoverable shard-launch fault plan
    (the numpy wave pinned, which passes the ``shard_launch`` seam as the
    reference's wave does at this size), each equal to the reference's by
    ``repr``;
  * the routed wave's picks: disjoint rows, each machine in the shard its
    row was routed to, the same picks as the reference's.

The reference's seven xla auto-promotion cases have no twin (the port
has no xla impl); routed mode ignores the recovery policy in both
packages, so no twin expects recovery there.
"""

import numpy as np
import pytest
import torch

from repro.core import FaultPlan as JFaultPlan
from repro.core import RecoveryPolicy as JRecoveryPolicy
from repro.core import online as jonline
from repro.core import shard as jshard
from repro.core.engine import packing as jpacking
from repro.sim.cluster import run_workload as j_run_workload
from repro.sim.workload import online_mix_workload as j_online_mix_workload

from repro_torch.core import FaultPlan, RecoveryPolicy
from repro_torch.core import online, shard
from repro_torch.core.engine import kernels as tk
from repro_torch.core.engine import packing
from repro_torch.sim import online_mix_workload, run_workload

# the tensors here are tiny: one intra-op thread is several times
# faster than a pool, and leaves the other test workers their cores
torch.set_num_threads(1)


def _draw_batch(rng, n_jobs=6, per_job=(1, 9), d=4) -> dict:
    """The arrays of a CandidateBatch with contiguous per-job runs,
    TaskPool-style (``tests/test_shard.py``'s ``_random_batch``)."""
    dem, pri, srpt, grp, job, tid = [], [], [], [], [], []
    for j in range(n_jobs):
        r = int(rng.integers(*per_job))
        dem.append(rng.uniform(0.05, 0.45, size=(r, d)))
        pri.append(rng.uniform(0.1, 1.0, size=r))
        srpt.append(np.full(r, float(rng.uniform(1.0, 50.0))))
        grp.append(np.full(r, int(rng.integers(0, 3)), dtype=np.int64))
        job.append(np.full(r, j, dtype=np.int64))
        tid.append(np.arange(r, dtype=np.int64))
    n = sum(len(p) for p in pri)
    return dict(dem=np.concatenate(dem), pri=np.concatenate(pri),
                srpt=np.concatenate(srpt), grp=np.concatenate(grp),
                loc=np.full(n, -1, dtype=np.int64), job=np.concatenate(job),
                tid=np.concatenate(tid))


def _batches(arrays: dict):
    """(the port's, the reference's) CandidateBatch of the same arrays."""
    return (online.CandidateBatch(**{k: v.copy() for k, v in arrays.items()}),
            jonline.CandidateBatch(**{k: v.copy()
                                      for k, v in arrays.items()}))


def _sharded(pkg_shard, pkg_online, n_machines, n_shards, shares,
             kappa=0.1):
    return pkg_shard.ShardedMatcher(pkg_online.MatcherConfig(kappa=kappa),
                                    n_machines, shares, n_shards=n_shards)


# ----------------------------------------------------------------------
# partition + routing structure
# ----------------------------------------------------------------------

def test_shard_plan_partitions_machines():
    for m, n in [(1, 1), (7, 3), (64, 4), (100, 7), (5, 9)]:
        plan, ref = shard.ShardPlan(m, n), jshard.ShardPlan(m, n)
        assert plan.n_shards == ref.n_shards == min(n, m)
        assert int(plan.sizes.sum()) == m
        assert plan.sizes.max() - plan.sizes.min() <= 1
        np.testing.assert_array_equal(plan.sizes, ref.sizes)
        np.testing.assert_array_equal(plan.offsets, ref.offsets)
        np.testing.assert_array_equal(plan.fracs, ref.fracs)
        assert plan.slices() == ref.slices()
        seen = []
        for s, sl in enumerate(plan.slices()):
            seen.extend(range(sl.start, sl.stop))
            for mm in (sl.start, sl.stop - 1):
                assert plan.shard_of(mm) == ref.shard_of(mm) == s
        assert seen == list(range(m))
        assert np.isclose(plan.fracs.sum(), 1.0)


def test_auto_shards_scales_with_machine_count(monkeypatch):
    assert shard.SHARD_MACHINES_ENV == "REPRO_SHARD_MACHINES"
    monkeypatch.setenv("REPRO_SHARD_MACHINES", "2048")
    for m, want in ((64, 1), (2048, 1), (2049, 2), (10240, 5)):
        assert shard.auto_shards(m) == jshard.auto_shards(m) == want
    monkeypatch.setenv("REPRO_SHARD_MACHINES", "512")
    assert shard.auto_shards(2048) == jshard.auto_shards(2048) == 4
    monkeypatch.delenv("REPRO_SHARD_MACHINES")
    for m in (1, 2048, 2049, 5000):
        assert shard.auto_shards(m) == jshard.auto_shards(m)


def test_route_exposure_partitions_proportionally():
    rng = np.random.default_rng(7)
    for _trial in range(20):
        batch, jbatch = _batches(_draw_batch(rng,
                                             n_jobs=int(rng.integers(1, 8))))
        m, n = int(rng.integers(4, 65)), int(rng.integers(1, 5))
        plan = shard.ShardPlan(m, n)
        routed = shard.route_exposure(batch, plan)
        want = jshard.route_exposure(jbatch, jshard.ShardPlan(m, n))
        assert len(routed) == len(want) == plan.n_shards
        for r, w in zip(routed, want):
            np.testing.assert_array_equal(r, w)
        allr = np.concatenate(routed)
        assert sorted(allr.tolist()) == list(range(len(batch)))
        for r in routed:
            assert (np.diff(r) > 0).all() if len(r) > 1 else True
        for j in np.unique(batch.job):
            r = int((batch.job == j).sum())
            counts = np.array([int((batch.job[ri] == j).sum())
                               for ri in routed])
            assert counts.sum() == r
            exact = plan.fracs * r
            assert (counts >= np.floor(exact).astype(int)).all()
            assert (np.abs(counts - exact) < 1.0 + 1e-9).all()


def test_route_exposure_spanning_job_slices_every_shard():
    batch, jbatch = _batches(_draw_batch(np.random.default_rng(3), n_jobs=1,
                                         per_job=(16, 17)))
    routed = shard.route_exposure(batch, shard.ShardPlan(64, 4))
    want = jshard.route_exposure(jbatch, jshard.ShardPlan(64, 4))
    assert [len(r) for r in routed] == [4, 4, 4, 4]
    for r, w in zip(routed, want):
        np.testing.assert_array_equal(r, w)


# ----------------------------------------------------------------------
# deficit handoff vs the single-shard oracle
# ----------------------------------------------------------------------

def _merged_trace_case(seed, n_shards, n_groups, n_steps, handoff_every):
    """Route one allocation trace to both packages' shards: the port's
    merged deficits track the oracle and equal the reference's."""
    rng = np.random.default_rng(seed)
    shares = {g: float(rng.uniform(0.5, 2.0)) for g in range(n_groups)}
    C = 40.0
    sm = _sharded(shard, online, 40, n_shards, shares)
    jsm = _sharded(jshard, jonline, 40, n_shards, shares)
    oracle = online.DeficitCounters(shares, capacity=C, kappa=sm.cfg.kappa)
    for step in range(n_steps):
        g = int(rng.integers(n_groups))
        w = float(rng.uniform(0.1, 1.5))
        s = int(rng.integers(sm.plan.n_shards))
        for m in (sm, jsm):
            m.shard_matchers[s].deficits.allocated(g, w)
        oracle.allocated(g, w)
        if handoff_every and step % handoff_every == 0:
            before = sm.merged_deficits()
            sm.deficit_handoff()
            jsm.deficit_handoff()
            after = sm.merged_deficits()
            for g2 in shares:
                assert after[g2] == pytest.approx(before[g2], abs=1e-9)
            for sh, frac in zip(sm.shard_matchers, sm.plan.fracs):
                for g2, v in sh.deficits.deficit.items():
                    assert v == pytest.approx(after[g2] * frac, abs=1e-9)
        merged = sm.merged_deficits()
        assert merged == jsm.merged_deficits()
        for g2 in shares:
            assert merged[g2] == pytest.approx(oracle.deficit[g2], abs=1e-8)
    sm.deficit_handoff()
    glob = online.DeficitCounters(shares, capacity=C, kappa=sm.cfg.kappa)
    glob.deficit.update(sm.merged_deficits())
    for sh in sm.shard_matchers:
        assert sh.deficits.must_serve() == glob.must_serve()


def test_merged_deficits_track_single_shard_oracle():
    for seed in range(12):
        rng = np.random.default_rng(100 + seed)
        _merged_trace_case(seed, n_shards=int(rng.integers(1, 5)),
                           n_groups=int(rng.integers(1, 5)),
                           n_steps=60, handoff_every=int(rng.integers(0, 9)))


def _enforced_peak(pkg_shard, pkg_online, seed: int) -> tuple[float, float]:
    """(peak merged deficit under serve-on-trigger, its composed bound)."""
    rng = np.random.default_rng(500 + seed)
    n_shards = int(rng.integers(1, 5))
    n_groups = int(rng.integers(2, 5))
    shares = {g: 1.0 for g in range(n_groups)}
    kappa, C, w_max, per_wave = 0.1, 40.0, 0.8, 2
    sm = _sharded(pkg_shard, pkg_online, 40, n_shards, shares, kappa=kappa)
    peak = 0.0
    for _wave in range(80):
        for sh in sm.shard_matchers:
            for _ in range(per_wave):
                g = sh.deficits.must_serve()
                if g is None:
                    g = int(rng.integers(n_groups))
                sh.deficits.allocated(g, float(rng.uniform(0.1, w_max)))
                peak = max(peak, max(sm.merged_deficits().values()))
        sm.deficit_handoff()
    return peak, kappa * C + (n_shards * per_wave + 1) * w_max


def test_sharded_bound_with_enforcement():
    """Serve-on-trigger keeps merged deficits within the composed bound
    (kappa C plus one wave of allocations on every shard and one
    quantum), at the reference's peak."""
    for seed in range(8):
        peak, bound = _enforced_peak(shard, online, seed)
        assert peak == _enforced_peak(jshard, jonline, seed)[0]
        assert peak <= bound + 1e-9


def test_handoff_nets_out_opposite_sign_deficits():
    shares = {0: 1.0, 1: 1.0}
    sm = _sharded(shard, online, 20, 2, shares, kappa=0.05)
    jsm = _sharded(jshard, jonline, 20, 2, shares, kappa=0.05)
    for m in (sm, jsm):
        a, b = (x.deficits for x in m.shard_matchers)
        for _ in range(40):
            a.allocated(0, 1.0)
            b.allocated(1, 1.0)
        assert a.must_serve() is not None and b.must_serve() is not None
        m.deficit_handoff()
    merged = sm.merged_deficits()
    assert merged == jsm.merged_deficits()
    assert all(abs(v) < 1e-9 for v in merged.values())
    assert all(m.deficits.must_serve() is None for m in sm.shard_matchers)


# ----------------------------------------------------------------------
# eligibility fan-out
# ----------------------------------------------------------------------

def test_sharded_eligibility_equals_global_launch(monkeypatch):
    monkeypatch.setenv(tk.KERNELS_ENV, "machines_with_candidates=numpy")
    rng = np.random.default_rng(11)
    for n_shards in (1, 2, 4):
        batch, _ = _batches(_draw_batch(rng, n_jobs=5))
        avail = rng.uniform(0.0, 1.0, size=(37, 4))
        avail[:10] *= 0.05
        shares = {0: 1.0, 1: 1.0, 2: 1.0}
        sm = _sharded(shard, online, 37, n_shards, shares)
        jsm = _sharded(jshard, jonline, 37, n_shards, shares)
        with tk.use_device("cpu"), sm:
            elig, any_ = sm.eligibility(avail, batch.dem)
        with jsm:
            j_elig, j_any = jsm.eligibility(avail, batch.dem)
        fd, rigid, fung = sm.matcher.fit_dim_split()
        ref_e, ref_a = packing.machines_with_candidates(
            avail, batch.dem, fd, rigid, fung,
            sm.cfg.max_overbook - 1.0, sm.cfg.use_overbooking)
        assert (elig == ref_e).all() and (any_ == ref_a).all()
        assert (elig == j_elig).all() and (any_ == j_any).all()
        j_e, j_a = jpacking.machines_with_candidates(
            avail, batch.dem, fd, rigid, fung,
            sm.cfg.max_overbook - 1.0, sm.cfg.use_overbooking)
        assert (ref_e == j_e).all() and (ref_a == j_a).all()


# ----------------------------------------------------------------------
# end-to-end shard-count invariance
# ----------------------------------------------------------------------

def _decision_key(res):
    return ([(j.job_id, repr(j.jct)) for j in
             sorted(res.jobs, key=lambda j: j.job_id)],
            repr(res.makespan))


def test_sim_decisions_invariant_across_shard_counts():
    kw = dict(n_machines=64, interarrival=1.0, n_groups=3, seed=4,
              build_machines=4)
    keys = {}
    for shards in (1, 2, 4):
        res = run_workload(online_mix_workload(10, seed=4), "dagps",
                           matcher_shards=shards, device="cpu", **kw)
        assert res.shard_stats["n_shards"] == shards
        keys[shards] = _decision_key(res)
    assert keys[1] == keys[2] == keys[4]
    ref = j_run_workload(j_online_mix_workload(10, seed=4), "dagps",
                         matcher_shards=2, **kw)
    assert keys[2] == _decision_key(ref)


_CHURN = dict(n_machines=48, interarrival=2.0, n_groups=2, seed=9,
              build_machines=4, straggle_prob=0.1, failure_rate=0.002,
              repair_time=30.0)


def test_sim_decisions_invariant_under_churn():
    keys = {}
    for shards in (1, 3):
        res = run_workload(online_mix_workload(8, seed=9), "dagps",
                           matcher_shards=shards, device="cpu", **_CHURN)
        keys[shards] = _decision_key(res)
    assert keys[1] == keys[3]
    ref = j_run_workload(j_online_mix_workload(8, seed=9), "dagps",
                         matcher_shards=3, **_CHURN)
    assert keys[3] == _decision_key(ref)


def test_sim_decisions_invariant_under_churn_with_faults(monkeypatch):
    """Churn composed with an exact-recoverable fault plan: retries,
    timeouts and quarantine reproduce the fault-free decisions, and the
    reference's run, injections and shard statistics.  The numpy wave is
    pinned: it passes the ``shard_launch`` seam, as the reference's wave
    does at this size (the device wave never does)."""
    monkeypatch.setenv(tk.KERNELS_ENV, "match_wave=numpy")
    plan = ("seed=13;shard_launch:raise@0.4;"
            "shard_launch:hang@0.1,delay=0.005")
    rec = dict(launch_timeout=5.0, launch_retries=1, backoff=0.001,
               backoff_cap=0.002, quarantine_after=2, probe_every=4)
    kw = dict(_CHURN, matcher_shards=3)
    base = run_workload(online_mix_workload(8, seed=9), "dagps",
                        fault_plan=FaultPlan(), device="cpu", **kw)
    faulty = run_workload(online_mix_workload(8, seed=9), "dagps",
                          fault_plan=FaultPlan.parse(plan),
                          recovery=RecoveryPolicy(**rec), device="cpu", **kw)
    assert _decision_key(base) == _decision_key(faulty)
    assert faulty.fault_stats["injections"]
    sh = faulty.fault_stats["shard"]
    assert sh["launch_retries"] + sh["quarantined_launches"] > 0
    ref = j_run_workload(j_online_mix_workload(8, seed=9), "dagps",
                         fault_plan=JFaultPlan.parse(plan),
                         recovery=JRecoveryPolicy(**rec), **kw)
    assert _decision_key(faulty) == _decision_key(ref)
    assert faulty.fault_stats["injections"] == ref.fault_stats["injections"]
    assert sh == ref.fault_stats["shard"]


# ----------------------------------------------------------------------
# the routed wave
# ----------------------------------------------------------------------

def _routed_picks(pkg_shard, pkg_online, arrays: dict, avail0) -> tuple:
    """(the wave's (row, machine) picks in order, its deficit handoffs)."""
    batch = pkg_online.CandidateBatch(**{k: v.copy()
                                         for k, v in arrays.items()})
    avail = avail0.copy()
    alive = np.ones(len(avail), dtype=bool)
    sm = _sharded(pkg_shard, pkg_online, len(avail), 4,
                  {g: 1.0 for g in range(3)})
    started = []

    def cb(row, machine):
        started.append((row, machine))
        avail[machine] -= batch.dem[row]
        np.clip(avail[machine], 0.0, None, out=avail[machine])

    with sm:
        n = sm.match_wave_routed(avail, alive, batch, cb)
    assert n == len(started)
    return started, sm.handoffs


def test_routed_wave_starts_valid_disjoint_tasks():
    rng = np.random.default_rng(21)
    arrays = _draw_batch(rng, n_jobs=8, per_job=(2, 7))
    avail = rng.uniform(0.3, 1.0, size=(40, 4))
    with tk.use_device("cpu"):
        started, handoffs = _routed_picks(shard, online, arrays, avail)
    assert len(started) > 0 and handoffs == 1
    rows = [r for r, _m in started]
    assert len(rows) == len(set(rows))
    plan = shard.ShardPlan(40, 4)
    routed = shard.route_exposure(_batches(arrays)[0], plan)
    for row, machine in started:
        assert plan.shard_of(machine) == next(
            s for s, r in enumerate(routed) if row in r)
    assert (started, handoffs) == _routed_picks(jshard, jonline, arrays,
                                                avail)
