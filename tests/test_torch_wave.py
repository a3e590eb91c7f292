"""The port's heartbeat wave against the reference package.

Two contracts, on the CPU:

  * the plain PyTorch wave (``ref.match_wave_walk``) equals the JAX
    package's Pallas wave in interpret mode (under ``enable_x64``) bit for
    bit on all eight outputs, fed identical operands;
  * the port's ``ShardedMatcher.match_wave`` at 1/2/4 shards reproduces the
    reference's legacy inline wave (``_wave_oracle``) over carried-over
    waves: same picks in the same order, avail equal by ``tobytes``, EMA
    pair and deficit ledgers equal by ``==``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import online as jonline
from repro.core.engine import wave as jwave
from repro.kernels.placement_scan import ops as jops

from repro_torch.core import online as tonline
from repro_torch.core.engine import kernels as tk
from repro_torch.core.engine import wave as twave
from repro_torch.core.shard import ShardedMatcher
from repro_torch.kernels.placement_scan import ref as tref

from test_online_parity import _batch_from, _random_heartbeat, _wave_oracle


# the tensors here are tiny: one intra-op thread is several times
# faster than a pool, and leaves the other test workers their cores
torch.set_num_threads(1)


def enable_x64():
    """float64 in JAX for the block (the context manager moved in jax 0.9)."""
    try:
        from jax.experimental import enable_x64 as ctx
        return ctx()
    except ImportError:
        return jax.enable_x64(True)


@pytest.fixture
def pallas_wave(monkeypatch):
    """The reference's Pallas wave, runnable under this jax.

    The reference's ``engine/wave.py`` imports ``enable_x64`` from
    ``jax.experimental`` together with jax itself, and leaves its jax
    globals at None where that name is gone (jax 0.9); ``wave_core`` then
    cannot trace.  Binding the globals for the test's duration runs the
    reference kernel unchanged.
    """
    monkeypatch.setattr(jwave, "jax", jax)
    monkeypatch.setattr(jwave, "jnp", jax.numpy)
    monkeypatch.setattr(jwave, "lax", jax.lax)
    return jops.match_wave_walk


_FAIRNESS = {"drf_fairness": tonline.drf_fairness,
             "slot_fairness": tonline.slot_fairness}


def port_cfg(cfg: jonline.MatcherConfig) -> tonline.MatcherConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(jonline.MatcherConfig)}
    fields["fairness"] = _FAIRNESS[cfg.fairness.__name__]
    return tonline.MatcherConfig(**fields)


def port_batch(b: jonline.CandidateBatch) -> tonline.CandidateBatch:
    return tonline.CandidateBatch(*(np.array(getattr(b, f.name), copy=True)
                                    for f in dataclasses.fields(b)))


def _corpus(seed):
    """Reference heartbeat corpus plus a preloaded deficit/EMA state."""
    rng = np.random.default_rng(31337 + seed)
    tasks, jobs, cfg, shares, _ = _random_heartbeat(rng)
    batch = _batch_from(tasks, jobs)
    M = int(rng.integers(5, 40))
    avail0 = rng.uniform(0.0, 1.2, (M, 4))
    alive = rng.random(M) < 0.9
    oracle = jonline.Matcher(cfg, capacity=float(M), shares=shares)
    for _ in range(int(rng.integers(0, 6))):
        oracle.deficits.allocated(int(rng.choice(list(shares))),
                                  float(rng.uniform(0.5, 2.0)))
    oracle._observe(float(rng.uniform(0.1, 2.0)), float(rng.uniform(1, 50)))
    return batch, cfg, shares, M, avail0, alive, oracle


def _load_state(dst, src):
    twave.load_matcher_state(dst, src._ema_score, src._ema_srpt,
                             src.deficits.deficit, src.deficits.share)


def _walk_operands(seed):
    """One wave's kernel operands, prepared by the port's own mirror sync."""
    batch, cfg, shares, M, avail0, alive, oracle = _corpus(seed)
    sm = ShardedMatcher(port_cfg(cfg), M, shares, n_shards=1,
                        capacity=float(M))
    _load_state(sm.matcher, oracle)
    st = twave.DeviceWaveState("cpu")
    args, kw, _ = twave.wave_launch_args(st, sm, port_batch(batch), avail0,
                                         alive, "test")
    return args, kw


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_wave_matches_pallas_interpret(seed, pallas_wave):
    args, kw = _walk_operands(seed)
    got = tref.match_wave_walk(*args, **kw)
    np_args = [a.numpy().copy() for a in args]
    with enable_x64():
        want = pallas_wave(*np_args, **kw)
        want = [np.asarray(w) for w in want]
    assert int(got[7]) > 0, "the corpus wave should pick something"
    for name, g, w in zip(("avail", "ema", "deficit", "rows", "mach", "over",
                           "obs", "count"), got, want):
        g = g.numpy()
        assert g.dtype == w.dtype, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("impl", ["torch", "numpy"])
def test_sharded_wave_matches_reference_oracle(impl, monkeypatch):
    """1/2/4 shards, three carried-over waves, seeds 0..3."""
    monkeypatch.setenv(tk.KERNELS_ENV, f"match_wave={impl}")
    tk.reset_profile()
    for seed in range(4):
        batch, cfg, shares, M, avail0, alive, oracle = _corpus(seed)
        state0 = (oracle._ema_score, oracle._ema_srpt,
                  dict(oracle.deficits.deficit), dict(oracle.deficits.share))
        o_avail = avail0.copy()
        want = [_wave_oracle(oracle, o_avail, alive, batch)
                for _ in range(3)]
        pbatch = port_batch(batch)
        for n_shards in (1, 2, 4):
            sm = ShardedMatcher(port_cfg(cfg), M, shares, n_shards=n_shards,
                                capacity=float(M))
            twave.load_matcher_state(sm.matcher, *state0)
            s_avail = avail0.copy()
            with tk.use_device("cpu"), sm:
                for wave in range(3):
                    got = []

                    def cb(gi, m):
                        got.append((gi, m))
                        s_avail[m] -= pbatch.dem[gi]

                    sm.match_wave(s_avail, alive, pbatch, cb)
                    assert got == want[wave], (seed, n_shards, wave)
            assert s_avail.tobytes() == o_avail.tobytes()
            assert sm.matcher._ema_score == oracle._ema_score
            assert sm.matcher._ema_srpt == oracle._ema_srpt
            assert sm.matcher.deficits.deficit == oracle.deficits.deficit
    prof = tk.profile_snapshot()
    assert prof.get(f"match_wave.{impl}", (0, 0))[0] > 0
    assert not any(k.endswith(".demoted") for k in prof)


def test_custom_fairness_counts_host_fallback(monkeypatch):
    """A fairness function with no device form never reaches the host loop
    behind the caller's back: the device wave raises (nothing is counted
    as a fallback), and pinning match_wave=numpy runs it in the host loop."""
    batch, cfg, shares, M, avail0, alive, oracle = _corpus(5)
    pcfg = dataclasses.replace(port_cfg(cfg),
                               fairness=lambda dem: 0.5 * float(np.max(dem)))
    for pin in ("", "match_wave=numpy"):
        monkeypatch.setenv(tk.KERNELS_ENV, pin)
        tk.reset_profile()
        with tk.use_device("cpu"), ShardedMatcher(pcfg, M, shares,
                                                  n_shards=1) as sm:
            wave = lambda: sm.match_wave(avail0.copy(), alive,  # noqa: E731
                                         port_batch(batch), lambda gi, m: None)
            if pin:
                wave()
            else:
                with pytest.raises(NotImplementedError, match="fairness"):
                    wave()
        prof = tk.profile_snapshot()
        assert not any(k.endswith("host_fallback") for k in prof)
        assert ("match_wave.numpy" in prof) == bool(pin)
        assert "match_wave.torch.waves" not in prof


def _unknown_group_corpus(seed):
    """A wave whose batch holds a group the deficit ledger does not."""
    batch, cfg, shares, M, avail0, alive, oracle = _corpus(seed)
    pbatch = port_batch(batch)
    stranger = max(shares) + 7
    pbatch.grp[::3] = stranger
    return pbatch, port_cfg(cfg), shares, M, avail0, alive, oracle


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_unknown_group_wave_matches_numpy(seed, monkeypatch):
    """Groups outside the ledger run on the device path, never the host
    loop: unpicked, they change nothing; picked, both impls raise the
    ledger's KeyError."""
    pbatch, pcfg, shares, M, avail0, alive, oracle = \
        _unknown_group_corpus(seed)
    state0 = (oracle._ema_score, oracle._ema_srpt,
              dict(oracle.deficits.deficit), dict(oracle.deficits.share))
    for dem_scale in (50.0, 1.0):       # strangers ineligible, then eligible
        b = port_batch(pbatch)
        b.dem[b.grp > max(shares)] *= dem_scale
        runs = {}
        for impl in ("numpy", "torch"):
            monkeypatch.setenv(tk.KERNELS_ENV, f"match_wave={impl}")
            tk.reset_profile()
            sm = ShardedMatcher(pcfg, M, shares, n_shards=1,
                                capacity=float(M))
            twave.load_matcher_state(sm.matcher, *state0)
            av = avail0.copy()
            picks = []

            def cb(gi, m, av=av, picks=picks, b=b):
                picks.append((gi, m))
                av[m] -= b.dem[gi]

            with tk.use_device("cpu"), sm:
                try:
                    for _ in range(2):
                        sm.match_wave(av, alive, b, cb)
                    runs[impl] = (picks, av.tobytes(), sm.matcher._ema_score,
                                  dict(sm.matcher.deficits.deficit))
                except KeyError as exc:
                    runs[impl] = ("KeyError", exc.args)
            prof = tk.profile_snapshot()
            assert not any(k.endswith("host_fallback") for k in prof)
            assert prof.get(f"match_wave.{impl}", (0, 0))[0] > 0
        assert runs["torch"] == runs["numpy"], (seed, dem_scale)
        if dem_scale > 1.0:             # no stranger can be picked
            assert runs["torch"][0] != "KeyError"
