"""The port's placement-scan ops against the reference package.

``repro_torch.kernels.placement_scan`` has a CUDA kernel and a plain
PyTorch version per op.  Here, on the CPU, the plain versions (and the
dispatch adapters around them) are held bit for bit against the JAX
package's Pallas kernels in interpret mode and against the numpy oracles
(``tests/test_torch_gpu.py`` holds the kernels against the plain versions
on a card).  Inputs come from numpy seeds and reach both packages as numpy
arrays.
"""

import numpy as np
import pytest
import torch

from repro.core.engine import kernels as jk
from repro.core.engine import packing as jpacking
from repro.kernels.placement_scan import ops as jops

from repro_torch.core.engine import kernels as tk
from repro_torch.core.engine import packing as tpacking
from repro_torch.core.engine.base import ceil32
from repro_torch.kernels.placement_scan import kernel as tkernel
from repro_torch.kernels.placement_scan import ops as tops
from repro_torch.kernels.placement_scan import ref as tref
from repro_torch.sim import run_workload
from repro_torch.sim.workload import online_mix_workload

# the tensors here are tiny: one intra-op thread is several times
# faster than a pool, and leaves the other test workers their cores
torch.set_num_threads(1)

FD, RD, GD = np.arange(4), np.array([0, 1]), np.array([2, 3])


def _grid(seed, m=3, T=64, d=4):
    """A float32 grid with cells planted exactly at ceil32 demands."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0.0, 1.0, (m, T, d)).astype(np.float32)
    g = int(rng.integers(2, 10))
    Vs = ceil32(rng.uniform(0.05, 0.7, (g, d)))
    for _ in range(3 * T):
        avail[rng.integers(m), rng.integers(T)] = Vs[rng.integers(g)]
    ks = rng.integers(1, 12, g)
    return avail, Vs, ks, rng


def _padded(seed):
    avail, Vs, ks, rng = _grid(seed)
    m, T, d = avail.shape
    W, L = 48, 96
    win = np.full((m, L, d), -1.0, dtype=np.float32)
    win[:, :T] = avail
    return (win, Vs.astype(np.float32), ks.astype(np.int32),
            int(rng.integers(T // 2, T + 1)), W)


@pytest.mark.parametrize("seed", range(3))
def test_scan_ref_matches_pallas_interpret(seed):
    win, Vs, ks, t_live, W = _padded(seed)
    want = np.asarray(jops.scan_bitmaps(win, Vs, ks, np.int32(t_live), W=W))
    got = tref.scan_bitmaps(torch.from_numpy(win), torch.from_numpy(Vs),
                            torch.from_numpy(ks), t_live, W).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert got.tobytes() == want.astype(np.int8).tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_scan_dispatch_matches_numpy_and_pallas(seed):
    """The torch impl (padding, ceil32, reverse flip) ≡ scan_starts ≡ the
    reference's pallas adapter, on grids with cells exactly at ceil32."""
    avail, Vs, ks, rng = _grid(seed)
    T = avail.shape[1]
    plo = int(rng.integers(0, 8))
    phi = int(rng.integers(plo + 4, T))
    for rev in (False, True):
        want = jk.scan_starts(avail, Vs, ks, plo, phi, rev)
        assert np.array_equal(tk.scan_starts(avail, Vs, ks, plo, phi, rev),
                              want)
        got = tk._scan_on(avail, Vs, ks, plo, phi, rev, device="cpu")
        assert got.tobytes() == want.tobytes()
        pal = jk._scan_pallas(avail, Vs, ks, plo, phi, rev)
        assert got.tobytes() == pal.tobytes()


#: word-and-run cases (m, W, L, g, t_live, kmax): the padded launch of
#: `_padded`'s kind, then unpadded shapes (W off the 32-tick word, g off 8),
#: t_live < L, k = 1 throughout, and k = LONG_K = 128
WORD_CASES = [(3, 48, 96, 5, 70, 11), (4, 45, 77, 3, 77, 33),
              (2, 33, 64, 9, 50, 1), (3, 70, 197, 7, 197, tk.LONG_K),
              (1, 1, 1, 1, 1, 1), (4, 31, 160, 13, 150, tk.LONG_K)]


def _word_case(seed, m, W, L, g, t_live, kmax, d=4):
    rng = np.random.default_rng(seed)
    win = rng.uniform(0.3, 1.0, (m, L, d)).astype(np.float32)
    dips = rng.random((m, L, d)) < 0.002
    win[dips] = rng.uniform(0.0, 0.3, int(dips.sum()))
    Vs = ceil32(rng.uniform(0.01, 0.3, (g, d))).astype(np.float32)
    for _ in range(L // 4):                # cells exactly at a demand
        win[rng.integers(m), rng.integers(L)] = Vs[rng.integers(g)]
    ks = rng.integers(1, kmax + 1, g).astype(np.int32)
    ks[0] = kmax
    return win, Vs, ks


@pytest.mark.parametrize("case", WORD_CASES)
def test_scan_words_matches_plain_and_pallas(case):
    """The scan kernel's word-and-run test (numpy twin) against the plain
    version and the reference's Pallas kernel in interpret mode, bitwise."""
    m, W, L, g, t_live, kmax = case
    win, Vs, ks = _word_case(sum(case), m, W, L, g, t_live, kmax)
    words = tref.tick_words(win, Vs, t_live)
    assert words.dtype == np.uint32 and words.shape == (g, m, (L + 31) // 32)
    got = tref.scan_words(win, Vs, ks, t_live, W)
    plain = tref.scan_bitmaps(torch.from_numpy(win), torch.from_numpy(Vs),
                              torch.from_numpy(ks), t_live, W).numpy()
    pal = np.asarray(jops.scan_bitmaps(win, Vs, ks, np.int32(t_live), W=W))
    assert got.dtype == np.int8 and got.shape == (g, W, m)
    assert got.tobytes() == plain.tobytes() == pal.astype(np.int8).tobytes()
    assert got.any() and (got.size == 1 or not got.all())
    rev = tref.scan_words(win, Vs, ks, t_live, W, reverse=True)
    assert rev.tobytes() == got[:, ::-1].tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_scan_words_on_live_windows_match_numpy(seed):
    """The twin on the card route's input, the live ticks only (L may be
    shorter than W + max(ks) where the grid ends), against scan_starts."""
    avail, Vs, ks, rng = _grid(seed, T=96)
    avail = np.maximum(avail, np.float32(0.7))   # room for long runs
    T = avail.shape[1]
    for plo, phi in ((int(rng.integers(0, 8)), int(rng.integers(40, 60))),
                     (T - 40, T)):
        kmax = int(ks.max())
        hi = min(T, phi + kmax - 1)
        for rev in (False, True):
            want = tk.scan_starts(avail, Vs, ks, plo, phi, rev)
            got = tref.scan_words(avail[:, plo:hi], Vs, ks, hi - plo,
                                  phi - plo, rev)
            assert (got != 0).reshape(len(ks), -1).tobytes() \
                == want.tobytes()
            assert want.any()


def _elig_state(seed, n=12, m=20, d=4):
    rng = np.random.default_rng(seed)
    avail = rng.uniform(-0.05, 1.0, (m, d))
    dem = rng.uniform(0.0, 0.9, (n, d))
    avail[0, 0] = dem[0, 0]              # an exact boundary pair
    return avail, dem, float(rng.uniform(0.0, 0.5)), bool(rng.integers(0, 2))


@pytest.mark.parametrize("seed", range(3))
def test_heartbeat_eligible_ref_matches_pallas_interpret(seed):
    avail, dem, slack, ob = _elig_state(seed)
    args, _ = tk._eligibility_launch_args(avail, dem, FD, RD, GD, slack, ob)
    want = np.asarray(jops.heartbeat_eligible(*args[:3], *args[3]))
    got = tref.heartbeat_eligible(*[torch.from_numpy(a) for a in
                                    (*args[:3], *args[3])]).numpy()
    assert got.tobytes() == want.astype(np.int8).tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_superset_of_exact_eligibility(seed):
    avail, dem, slack, ob = _elig_state(100 + seed)
    exact, any_exact = tpacking.machines_with_candidates(
        avail, dem, FD, RD, GD, slack, ob)
    ref_exact, _ = jpacking.machines_with_candidates(avail, dem, FD, RD, GD,
                                                     slack, ob)
    assert np.array_equal(exact, ref_exact)
    sup, any_sup = tk._machines_with_candidates_on(
        avail, dem, FD, RD, GD, slack, ob, device="cpu")
    assert (exact <= sup).all(), "dropped an exactly eligible pair"
    assert (any_exact <= any_sup).all()
    pal, _ = jk._machines_with_candidates_pallas(avail, dem, FD, RD, GD,
                                                 slack, ob)
    assert np.array_equal(sup, pal)


def _host_rounded(avail, dem, slack, ob):
    """The CPU route's answer: host rounding + the plain comparison."""
    args, empty = tk._eligibility_launch_args(avail, dem, FD, RD, GD, slack,
                                              ob)
    if empty is not None:
        return empty[0].astype(np.int8), empty[1]
    out = tref.heartbeat_eligible(*[torch.from_numpy(a) for a in
                                    (*args[:3], *args[3])]).numpy()
    return out, out.any(axis=0)


def _call_plain(avail, dem, slack, ob):
    """The staged call's contract, as `_machines_with_candidates_on` hands
    it to the card, through its plain version: float64 in, dims and slack
    mapped, rounding with ``torch.nextafter``."""
    fd, rd, gd, sl = tk._eligibility_dims(FD, RD, GD, slack, ob)
    masks = [torch.from_numpy(mk) for mk in tk._dim_masks(4, fd, rd, gd)]
    got, any_ = tref.heartbeat_eligible64(
        torch.from_numpy(avail), torch.from_numpy(dem), max(sl, 0.0),
        tpacking.EPS, *masks)
    return got.numpy(), any_.numpy() != 0


@pytest.mark.parametrize("seed", range(4))
def test_staged_call_contract_matches_host_rounding_and_pallas(seed):
    avail, dem, slack, ob = _elig_state(200 + seed, n=40, m=64)
    got, got_any = _call_plain(avail, dem, slack, ob)
    want, want_any = _host_rounded(avail, dem, slack, ob)
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(got_any, want_any)
    args, _ = tk._eligibility_launch_args(avail, dem, FD, RD, GD, slack, ob)
    pal = np.asarray(jops.heartbeat_eligible(*args[:3], *args[3]))
    assert got.tobytes() == pal.astype(np.int8).tobytes()
    exact, any_exact = tpacking.machines_with_candidates(avail, dem, FD, RD,
                                                         GD, slack, ob)
    assert (exact <= (got != 0)).all() and (any_exact <= got_any).all()


@pytest.mark.parametrize("seed", range(3))
def test_directed_rounding_on_edge_values(seed):
    """torch's rounding (the plain version of the card's
    ``__double2float_rd``/``_ru``) equals the host's bit for bit on the
    edge corpus, and the call's contract equals the host route there."""
    avail, dem = tref.eligibility_edge_corpus(seed, tpacking.EPS)
    for x in (avail, dem, avail + tpacking.EPS):
        xt = torch.from_numpy(x)
        with np.errstate(over="ignore"):
            down, up = tk._round_down32(x), tk._round_up32(x)
        assert tref.round_down32(xt).numpy().tobytes() == down.tobytes()
        assert tref.round_up32(xt).numpy().tobytes() == up.tobytes()
    lo = tref.round_down32(torch.from_numpy(dem)).double().numpy()
    hi = tref.round_up32(torch.from_numpy(avail)).double().numpy()
    with np.errstate(invalid="ignore"):
        assert not (lo > dem).any() and not (hi < avail).any()
    for slack, ob in ((0.0, True), (0.25, True), (0.25, False),
                      (-0.5, True)):
        with np.errstate(invalid="ignore", over="ignore"):
            got, got_any = _call_plain(avail, dem, slack, ob)
            want, want_any = _host_rounded(avail, dem, slack, ob)
            exact, _ = tpacking.machines_with_candidates(avail, dem, FD, RD,
                                                         GD, slack, ob)
        assert got.tobytes() == want.tobytes(), (slack, ob)
        assert np.array_equal(got_any, want_any)
        assert (exact <= (got != 0)).all()


def _as_staged_call(avail, demands, fit_dims, rigid_dims, fungible_dims,
                    overbook_slack=0.0, use_overbooking=True):
    """The cuda impl's route with the plain version in the kernel's place:
    the machine-major result packed into a buffer laid out as the staged
    call's output, unpacked by the code the card's route uses."""
    avail = np.atleast_2d(np.asarray(avail, dtype=np.float64))
    demands = np.atleast_2d(np.asarray(demands, dtype=np.float64))
    n, m = demands.shape[0], avail.shape[0]
    if n == 0:
        return np.zeros((n, m), dtype=bool), np.zeros(m, dtype=bool)
    fd, rd, gd, sl = tk._eligibility_dims(fit_dims, rigid_dims,
                                          fungible_dims, overbook_slack,
                                          use_overbooking)
    masks = [torch.from_numpy(mk) for mk in
             tk._dim_masks(avail.shape[1], fd, rd, gd)]
    elig, any_ = tref.heartbeat_eligible64(
        torch.from_numpy(avail), torch.from_numpy(demands), max(sl, 0.0),
        tpacking.EPS, *masks)
    off_any = tkernel._align16(m * n)
    buf = np.ones(off_any + m + 64, dtype=bool)       # stale bytes around
    buf[:m * n] = elig.numpy().T.reshape(-1) != 0
    buf[off_any:off_any + m] = any_.numpy() != 0
    out = tkernel.unpack_eligible(buf, m, n, off_any)
    buf[:] = False                     # the next call overwrites the stage
    return out


def test_unpacked_layout_against_every_consumer(monkeypatch):
    """The staged call's transposed (n, m) view through the consumers that
    read it (the numpy wave's shard fan-out and concatenation, the routed
    wave's per-shard loop), against the host route's C-ordered arrays:
    the same decisions and the same eligibility, 3 shards."""
    avail, dem, slack, ob = _elig_state(7, n=9, m=30)
    got = _as_staged_call(avail, dem, FD, RD, GD, slack, ob)
    want = tk._machines_with_candidates_on(avail, dem, FD, RD, GD, slack, ob,
                                           device="cpu")
    assert got[0].shape == want[0].shape and got[0].flags.f_contiguous
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for mm in range(avail.shape[0]):
        assert np.array_equal(got[0][:, mm], want[0][:, mm])
    dags = online_mix_workload(4, seed=3)
    kw = dict(n_machines=12, interarrival=2.0, seed=3, n_groups=2,
              matcher_shards=3, record_placements=True, device="cpu")
    monkeypatch.setenv(tk.KERNELS_ENV, "match_wave=numpy")
    for mode in ("exact", "routed"):
        base = run_workload(dags, "dagps", matcher_mode=mode, **kw)
        with monkeypatch.context() as mp:
            mp.setitem(tk._REGISTRY, ("machines_with_candidates", "torch"),
                       (_as_staged_call, lambda: True))
            tk.reset_profile()
            staged = run_workload(dags, "dagps", matcher_mode=mode, **kw)
            assert tk.profile_snapshot()[
                "machines_with_candidates.torch"][0] > 0
        assert staged.placements == base.placements, mode
        assert repr(staged.makespan) == repr(base.makespan), mode


def test_ops_reject_other_devices():
    t = torch.zeros((1, 4, 1), device="meta")
    with pytest.raises(ValueError):
        tops.scan_bitmaps(t, t, t, 1, W=1)


def test_dispatch_device_rule_and_pins(monkeypatch):
    """cpu -> torch impls; a pin wins; numpy-only ops stay numpy."""
    monkeypatch.delenv(tk.KERNELS_ENV, raising=False)
    with tk.use_device("cpu"):
        act = tk.active()
        assert act["scan"] == act["machines_with_candidates"] \
            == act["match_wave"] == "torch"
        for op in tk.EXPLICIT_ONLY:
            assert act[op] == "numpy"
        monkeypatch.setenv(tk.KERNELS_ENV, "all=numpy")
        assert set(tk.active().values()) == {"numpy"}
        monkeypatch.setenv(tk.KERNELS_ENV, "scan=xla")
        with pytest.raises(ValueError):
            tk.resolve("scan")
