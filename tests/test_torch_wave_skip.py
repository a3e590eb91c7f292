"""The wave kernel's visit skip, held on the CPU.

The CUDA wave (``kernels/placement_scan/csrc/placement_scan.cu``) passes
over a machine without a pass over the candidates when the componentwise
minimum of the untaken candidates' demands already fails it.  That is only
right if the test is sound: it may skip a machine only where no candidate
can be eligible.  Its numpy twin, ``ref.visit_may_pick`` over
``ref.demand_min``, is held here:

  * against the eligibility rule itself, candidate by candidate, on seeded
    corpora with NaN demands, negative and exact-threshold availability,
    and every mask and overbooking setting;
  * against the numpy waves: every machine on which the port's wave
    (``core/engine/wave.py``) or the reference's (``repro.core``) makes a
    pick passes the test, taken with the minimum over the candidates still
    untaken when the wave reaches that machine, as the kernel keeps it.
"""

import numpy as np
import pytest
import torch

from repro.core import online as jonline
from repro.core.engine import packing as jpacking

from repro_torch.core.engine import kernels as tk
from repro_torch.core.engine import packing
from repro_torch.core.engine import wave as twave
from repro_torch.core.shard import ShardedMatcher
from repro_torch.kernels.placement_scan import ref as tref

from test_online_parity import _wave_oracle
from test_torch_wave import _corpus, port_batch, port_cfg

# tiny arrays: one intra-op thread is faster than a pool and leaves the
# other test workers their cores
torch.set_num_threads(1)


def _consts(eps, slack):
    c = np.zeros(8)
    c[0], c[1] = eps, slack
    return c


def _eligible(dem, row, eps, slack, fd, rd, fg, overbook):
    """Per candidate: fits, or overbooks, on a machine with ``row`` (the
    matcher's float64 comparisons; a NaN demand fails its dim)."""
    thr = row + eps
    thr_g = (row + slack) + eps
    fits = np.all((dem <= thr) | ~fd, axis=1)
    rig = np.all((dem <= thr) | ~rd, axis=1)
    fng = np.all((dem <= thr_g) | ~fg, axis=1)
    return fits | (overbook & ~fits & rig & fng)


@pytest.mark.parametrize("seed", range(8))
def test_skip_is_sound_against_eligibility(seed):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 9))
    eps = float(rng.choice([0.0, 1e-9, 1e-3]))
    for _ in range(40):
        n = int(rng.integers(1, 60))
        dem = rng.uniform(0.0, 1.0, (n, d))
        if rng.random() < 0.5:
            dem = np.round(dem * 4) / 4           # demands on the thresholds
        dem[rng.random((n, d)) < 0.05] = np.nan
        taken = rng.random(n) < 0.3
        fd, rd, fg = (rng.random((3, d)) < 0.6)
        slack = float(rng.choice([0.0, 0.25, 0.5]))
        overbook = bool(rng.random() < 0.6)
        dmin = tref.demand_min(dem, taken)
        live = dem[~taken]
        for _ in range(25):
            row = rng.uniform(-0.2, 1.0, d)
            if rng.random() < 0.3 and len(live):  # a row at a demand - eps
                row = live[rng.integers(len(live))] - eps
            row[rng.random(d) < 0.05] = np.nan
            elig = _eligible(live, row, eps, slack, fd, rd, fg, overbook)
            if not tref.visit_may_pick(row, dmin, _consts(eps, slack), fd,
                                       rd, fg, overbook):
                assert not elig.any(), (seed, row, dmin)


def test_demand_min_ignores_nan_and_taken():
    dem = np.array([[0.5, np.nan, 0.2], [0.3, np.nan, 0.9],
                    [0.1, 0.05, 0.0]])
    got = tref.demand_min(dem, np.array([False, False, True]))
    assert got.tolist() == [0.3, np.inf, 0.2]
    assert tref.demand_min(dem, np.ones(3, bool)).tolist() == [np.inf] * 3


def _check_picks(picks, dem, avail0, consts, fd, rd, fg, overbook):
    """Every machine a wave picks on passes the skip test with the minimum
    over the candidates untaken when the wave reaches it (a machine is
    visited once, so its row then is its row before the wave)."""
    taken = np.zeros(len(dem), bool)
    seen = []
    for gi, m in picks:
        if not seen or seen[-1] != m:
            assert m not in seen
            seen.append(m)
            assert tref.visit_may_pick(avail0[m], tref.demand_min(dem, taken),
                                       consts, fd, rd, fg, overbook), m
        taken[gi] = True
    return len(seen)


def _masks(fit_dims, d):
    out = []
    for dims in fit_dims:
        mk = np.zeros(d, bool)
        mk[np.asarray(dims, dtype=np.int64)] = True
        out.append(mk)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_skip_passes_every_machine_the_port_wave_picks_on(seed, monkeypatch):
    batch, cfg, shares, M, avail0, alive, _ = _corpus(seed)
    pcfg, pbatch = port_cfg(cfg), port_batch(batch)
    monkeypatch.setenv(tk.KERNELS_ENV, "match_wave=numpy")
    with tk.use_device("cpu"), ShardedMatcher(pcfg, M, shares, n_shards=1,
                                              capacity=float(M)) as sm:
        avail = avail0.copy()
        picks = []

        def cb(gi, m):
            picks.append((gi, m))
            avail[m] -= pbatch.dem[gi]

        sm.match_wave(avail, alive, pbatch, cb)
        fd, rd, fg = _masks(sm.matcher.fit_dim_split(), avail0.shape[1])
        consts = twave.wave_consts(sm.matcher)
    assert picks, "the corpus wave should pick something"
    _check_picks(picks, pbatch.dem, avail0, consts, fd, rd, fg,
                 pcfg.use_overbooking)


@pytest.mark.parametrize("seed", range(6))
def test_skip_passes_every_machine_the_reference_wave_picks_on(seed):
    batch, cfg, shares, M, avail0, alive, oracle = _corpus(seed)
    avail = avail0.copy()
    picks = _wave_oracle(oracle, avail, alive, batch)
    assert picks, "the corpus wave should pick something"
    fd, rd, fg = _masks(oracle.fit_dim_split(), avail0.shape[1])
    consts = _consts(jpacking.EPS, cfg.max_overbook - 1.0)
    _check_picks(picks, batch.dem, avail0, consts, fd, rd, fg,
                 cfg.use_overbooking)


def test_skip_on_a_busy_cluster_passes_the_picks_and_skips_most():
    """A wave of 32 candidates on 256 mostly full machines: the numpy wave's
    picking machines all pass, and most of the machines the walk reaches
    are skipped once the minimum grows with the picks (the case the
    kernel's chunked visit test is for)."""
    rng = np.random.default_rng(17)
    m, n, d = 256, 32, 4
    batch = jonline.CandidateBatch(
        dem=rng.uniform(0.05, 0.3, (n, d)), pri=rng.uniform(0.5, 2.0, n),
        srpt=rng.uniform(1.0, 300.0, n), grp=rng.integers(0, 2, n),
        loc=np.full(n, -1), job=np.arange(n), tid=np.arange(n))
    avail0 = rng.uniform(0.0, 0.3, (m, d))
    cfg = jonline.MatcherConfig()
    oracle = jonline.Matcher(cfg, capacity=float(m), shares={0: 1.0, 1: 1.0})
    picks = _wave_oracle(oracle, avail0.copy(), np.ones(m, bool), batch)
    fd, rd, fg = _masks(oracle.fit_dim_split(), d)
    consts = _consts(packing.EPS, cfg.max_overbook - 1.0)
    used = _check_picks(picks, batch.dem, avail0, consts, fd, rd, fg,
                        cfg.use_overbooking)
    assert used > 0
    # the kernel's walk: machines in the wave's order until nothing is left
    by_machine = {}
    for gi, mm in picks:
        by_machine.setdefault(mm, []).append(gi)
    taken = np.zeros(n, bool)
    reached = skipped = 0
    for mm in np.argsort(-avail0.sum(axis=1)).tolist():
        if taken.all():
            break
        reached += 1
        if not tref.visit_may_pick(avail0[mm], tref.demand_min(batch.dem,
                                                               taken),
                                   consts, fd, rd, fg, cfg.use_overbooking):
            skipped += 1
            assert mm not in by_machine
        taken[by_machine.get(mm, [])] = True
    assert skipped > reached // 2, (skipped, reached)


def test_wave_column_cache_never_trusts_a_reused_id():
    """The device wave re-uploads a candidate column when its array is a
    new object, judged by ``id``.  CPython hands a freed object's id to the
    next object it allocates, so the state must hold the arrays it judged:
    a batch made after the previous one was dropped, with other demands,
    must reach the mirrors (it did not when only the ids were kept, and
    the wave then ran on stale demands)."""
    from repro_torch.core.online import CandidateBatch, MatcherConfig

    m, n, d = 16, 8, 4
    rng = np.random.default_rng(5)
    avail = rng.uniform(0.2, 1.0, (m, d))
    alive = np.ones(m, bool)
    sm = ShardedMatcher(MatcherConfig(), m, {0: 1.0, 1: 1.0}, n_shards=1,
                        capacity=float(m))
    st = twave.DeviceWaveState("cpu")

    def batch(seed):
        r = np.random.default_rng(seed)
        return CandidateBatch(
            dem=r.uniform(0.05, 0.3, (n, d)), pri=r.uniform(0.5, 2.0, n),
            srpt=r.uniform(1.0, 300.0, n), grp=r.integers(0, 2, n),
            loc=np.full(n, -1), job=np.arange(n), tid=np.arange(n))

    reused = 0
    for seed in range(40):
        b = batch(seed)
        ids = (id(b.dem), id(b.pri), id(b.srpt))
        args, _kw, _ = twave.wave_launch_args(st, sm, b, avail, alive,
                                              "torch")
        assert np.array_equal(args[2][:n].numpy(), b.dem)
        assert np.array_equal(args[4][:n].numpy(), b.srpt)
        del b, args
        b2 = batch(1000 + seed)
        reused += (id(b2.dem), id(b2.pri), id(b2.srpt)) == ids
        del b2
    # the check above is only as strong as CPython's reuse of ids: with the
    # arrays held by the state, a fresh batch never takes their ids
    assert reused == 0
