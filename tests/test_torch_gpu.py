"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every case is marked ``gpu`` and skips without a CUDA device: the kernels
have no CPU mode.  This file imports only the port (no JAX, no reference
package), so it also runs on a machine that has PyTorch and the CUDA
toolkit alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Inputs are made from numpy seeds.  The scheduler's kernels and the rg_lru
scan are compared bitwise (the scan also as the builder's whole staged
call, at the main path's launch shapes and at edge shapes; the eligibility
call, staged with its rounding on the card, against the host-rounded plain
version, on an edge corpus and from four threads at once; the scan call
from four threads; the jit backend's resident scan under mutation, read
after later commits; the build service's workers on the card; the
explicit-only ops' cuda impls; the scheduler service against the
simulator and from its serving thread); the flash kernel's two wgmma layouts alone
against torch in float32 (``wgmma_probe``); flash attention within 2e-5 (f32) and 2e-2
(bf16), the tolerances of ``tests/test_kernels.py`` (it sums in another
order, and its bf16 variant rounds the softmax weights to bf16 for the
tensor cores); wkv6 within the same limits for y and 1e-3 for the final
state (it sums over i in another order), and in float32 at the model's
scale within twice the first-order rounding bound ``ref.f32_error_bound``
of the plain version and of its order twin ``ref.wkv6_tiled``.  Flash
also runs at the other families' head shapes (GQA with KV > 1 and MHA at
hd 128 and 64, gemma2's global layer at hd 256 with cap 50); the MoE's
expert choices and dropped tokens on the card equal the CPU's; and each
family's ``smoke()`` prefill on the card in float32 matches the CPU's
within 1e-4.  The backward kernels: flash's dq, dk, dv within 2e-2 (bf16)
/ 2e-5 (f32) of the plain version's max magnitude and its forward's
log-sum-exp against the plain one's, two calls bitwise equal (no
atomics), a bf16 hd-40 call raising as the forward does, its autograd
Function against the same Function pinned to the plain versions, the
RG-LRU backward bitwise; the WKV6 backward's six gradients within twice
``ref.f32_bwd_error_bound`` of ``ref.wkv6_bwd`` (every head size, S=1,
S off the 16-step chunk, with and without dsT) and of its order twin
``ref.wkv6_bwd_tiled``, two calls bitwise equal, and ``ops.wkv6`` under
autograd launching it; and five smoke models'
train step (rwkv6 among them) on the card against the CPU's.  The sharding and launch layer: an NCCL process
group of world size 1 (a FileStore, no network) under the (1, 1) debug
mesh, ``distribute_tree`` on it, ``compressed_psum_tree`` bitwise
``dequantize(quantize_int8(g))``, ``logical`` leaving a replicated DTensor
as it is, five smoke families (the MoE's two among them, their dispatch
and combine in their regions) bitwise on it against plain tensors, the
MoE's combine bitwise on repeat and against the CPU, meta tensors through the three LM ops (shapes only, nothing
launched) while a CUDA tensor still launches, and the dry run's
``HBM_PER_DEVICE`` against the card's own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.engine import kernels as tk
from repro_torch.core.engine import packing
from repro_torch.core.engine import wave as twave
from repro_torch.core.engine.base import ceil32
from repro_torch.core.online import (CandidateBatch, MatcherConfig,
                                     drf_fairness, slot_fairness)
from repro_torch.core.shard import ShardedMatcher
from repro_torch.kernels.placement_scan import ref as tref

pytestmark = pytest.mark.gpu


@pytest.fixture
def kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.placement_scan import kernel as k
    return k


def _grid(seed, m=4, T=160, d=4):
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0.0, 1.0, (m, T, d)).astype(np.float32)
    g = int(rng.integers(2, 33))
    Vs = ceil32(rng.uniform(0.05, 0.7, (g, d)))
    for _ in range(3 * T):                 # cells exactly at a demand
        avail[rng.integers(m), rng.integers(T)] = Vs[rng.integers(g)]
    ks = rng.integers(1, 129, g)
    return avail, Vs, ks, rng


@pytest.mark.parametrize("seed", range(4))
def test_scan_kernel_matches_plain_and_numpy(kernel, seed):
    avail, Vs, ks, rng = _grid(seed)
    T = avail.shape[1]
    plo = int(rng.integers(0, 16))
    phi = int(rng.integers(plo + 8, T))
    for rev in (False, True):
        want = tk.scan_starts(avail, Vs, ks, plo, phi, rev)
        for dev in ("cuda", "cpu"):
            got = tk._scan_on(avail, Vs, ks, plo, phi, rev, device=dev)
            assert got.tobytes() == want.tobytes(), (dev, rev)
    # the kernel alone on an unpadded window: L = 160 >= W + max(ks)
    win = torch.from_numpy(avail).cuda()
    Vs_t = torch.from_numpy(Vs.astype(np.float32)).cuda()
    ks_t = torch.from_numpy(np.minimum(ks, 32).astype(np.int32)).cuda()
    assert torch.equal(kernel.scan_bitmaps(win, Vs_t, ks_t, 150, 128),
                       tref.scan_bitmaps(win, Vs_t, ks_t, 150, 128))


#: the scan's launch shapes (m, W, L, g) with more than 100 launches on
#: the smoke's main paths (48 jobs on 2048 machines, exact and routed),
#: as padded by the route before the staged call; each becomes one call
#: of W starts over an L-tick window for g tasks
SCAN_PATH_SHAPES = [
    (4, 192, 256, 8), (4, 64, 96, 8), (4, 128, 192, 8), (4, 192, 384, 8),
    (4, 96, 128, 8), (4, 64, 128, 8), (4, 96, 192, 8), (4, 192, 256, 16),
    (4, 64, 192, 8), (4, 128, 256, 8), (4, 256, 384, 8), (4, 192, 256, 24),
    (4, 96, 256, 8), (4, 192, 256, 32)]
#: edge shapes (m, W, L, g, d, kmax): one start, k = 1 everywhere, k =
#: LONG_K, W and L off the 32-tick word, g off 8, one machine, d off 4
#: (scalar cells), a window longer than 32 words
SCAN_EDGE_SHAPES = [
    (4, 1, 1, 1, 4, 1), (3, 31, 31, 5, 4, 1), (4, 33, 160, 9, 4, 128),
    (1, 45, 77, 3, 4, 33), (5, 100, 227, 13, 3, 128), (2, 7, 40, 1, 1, 34),
    (4, 1500, 1627, 2, 4, 128)]


def _scan_window(seed, m, W, L, g, d=4, kmax=None):
    """A grid whose window [plo, plo + W) reads exactly L ticks (kmax =
    L - W + 1 unless given; runs of longer tasks reach the grid's end)."""
    rng = np.random.default_rng(seed)
    kmax = kmax or min(128, L - W + 1)
    plo = int(rng.integers(0, 5))
    T = plo + L
    avail = rng.uniform(0.3, 1.0, (m, T, d)).astype(np.float32)
    dips = rng.random((m, T, d)) < 0.01
    avail[dips] = rng.uniform(0.0, 0.3, int(dips.sum()))
    Vs = ceil32(rng.uniform(0.01, 0.3, (g, d)))
    for _ in range(T // 4):                # cells exactly at a demand
        avail[rng.integers(m), rng.integers(T)] = Vs[rng.integers(g)]
    ks = rng.integers(1, kmax + 1, g)
    ks[0] = kmax
    return avail, Vs, ks, plo, plo + W


def _check_scan_call(kernel, avail, Vs, ks, plo, phi):
    before = kernel.LAUNCHES["scan_bitmaps"]
    for rev in (False, True):
        want = tk.scan_starts(avail, Vs, ks, plo, phi, rev)
        got = tk._scan_on(avail, Vs, ks, plo, phi, rev, device="cuda")
        assert got.dtype == bool and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), rev
    assert kernel.LAUNCHES["scan_bitmaps"] == before + 2


@pytest.mark.parametrize("shape", SCAN_PATH_SHAPES)
def test_scan_call_bitwise_at_path_shapes(kernel, shape):
    """The staged call (one pinned upload, launch, pinned readback) equals
    the numpy scan and the plain version; the kernel alone on the card
    equals the plain version on the same tensors."""
    m, W, L, g = shape
    avail, Vs, ks, plo, phi = _scan_window(sum(shape), m, W, L, g)
    _check_scan_call(kernel, avail, Vs, ks, plo, phi)
    plain = tk._scan_on(avail, Vs, ks, plo, phi, False, device="cpu")
    assert plain.tobytes() == tk.scan_starts(avail, Vs, ks, plo, phi,
                                             False).tobytes()
    win = torch.from_numpy(np.ascontiguousarray(avail[:, plo:])).cuda()
    Vs_t = torch.from_numpy(Vs.astype(np.float32)).cuda()
    ks_t = torch.from_numpy(ks.astype(np.int32)).cuda()
    for t_live in (L, L - 37):
        assert torch.equal(kernel.scan_bitmaps(win, Vs_t, ks_t, t_live, W),
                           tref.scan_bitmaps(win, Vs_t, ks_t, t_live, W))


@pytest.mark.parametrize("shape", SCAN_EDGE_SHAPES)
def test_scan_call_bitwise_at_edge_shapes(kernel, shape):
    m, W, L, g, d, kmax = shape
    avail, Vs, ks, plo, phi = _scan_window(7 * sum(shape), m, W, L, g, d,
                                           kmax)
    _check_scan_call(kernel, avail, Vs, ks, plo, phi)
    # a run past the grid's end (the window reads fewer than W + k - 1
    # ticks) is never good; in a longer grid the same starts may be
    if (ks > 1).any():
        T = avail.shape[1]
        _check_scan_call(kernel, avail, Vs, ks, T - W, T)


@pytest.mark.parametrize("seed", range(3))
def test_heartbeat_kernel_matches_plain_and_is_superset(kernel, seed):
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(1, 600)), int(rng.integers(1, 3000))
    avail = rng.uniform(-0.05, 1.0, (m, 4))
    dem = rng.uniform(0.0, 0.9, (n, 4))
    avail[0] = dem[0]
    fd, rd, gd = np.arange(4), np.array([0, 1]), np.array([2, 3])
    slack, ob = float(rng.uniform(0.0, 0.5)), bool(seed % 2)
    args, _ = tk._eligibility_launch_args(avail, dem, fd, rd, gd, slack, ob)
    ts = [torch.from_numpy(a).cuda() for a in (*args[:3], *args[3])]
    got = kernel.heartbeat_eligible(*ts)
    assert torch.equal(got, tref.heartbeat_eligible(*ts))
    exact, _ = packing.machines_with_candidates(avail, dem, fd, rd, gd, slack,
                                                ob)
    assert (exact <= (got.cpu().numpy() != 0)).all()


def _host_rounded_eligible(avail, dem, slack, ob, fd, rd, gd):
    """The CPU route's answer on the card: host rounding + the plain
    comparison (`ref.heartbeat_eligible`) on CUDA tensors."""
    args, empty = tk._eligibility_launch_args(avail, dem, fd, rd, gd, slack,
                                              ob)
    if empty is not None:
        return empty
    ts = [torch.from_numpy(a).cuda() for a in (*args[:3], *args[3])]
    out = tref.heartbeat_eligible(*ts).cpu().numpy() != 0
    return out, out.any(axis=0)


def _elig_case(seed, n, m):
    rng = np.random.default_rng(seed)
    avail = rng.uniform(-0.05, 1.0, (m, 4))
    dem = rng.uniform(0.0, 0.9, (n, 4))
    if n and m:
        avail[0] = dem[0]
        avail[-1] = dem[-1] - packing.EPS
    return (avail, dem, float(rng.uniform(0.0, 0.5)), bool(seed % 2),
            np.arange(4), np.array([0, 1]), np.array([2, 3]))


@pytest.mark.parametrize("n", [0, 1, 32, 512])
@pytest.mark.parametrize("m", [24, 512, 2048])
def test_staged_eligible_call_bitwise(kernel, n, m):
    """The staged call (rounding on the card, one pinned upload, results
    written into pinned host memory) equals the host-rounded plain
    version bitwise and is a superset of the exact eligibility; the
    kernel alone equals `ref.heartbeat_eligible64` on the same tensors."""
    for seed in (n + m, n + m + 1):
        avail, dem, slack, ob, fd, rd, gd = _elig_case(seed, n, m)
        before = kernel.LAUNCHES["heartbeat_eligible"]
        got, got_any = tk._machines_with_candidates_on(
            avail, dem, fd, rd, gd, slack, ob, device="cuda")
        assert kernel.LAUNCHES["heartbeat_eligible"] == before + (n > 0)
        want, want_any = _host_rounded_eligible(avail, dem, slack, ob, fd,
                                                rd, gd)
        assert got.shape == (n, m) and got.dtype == bool
        assert got.tobytes() == want.tobytes()
        assert got_any.tobytes() == want_any.tobytes()
        exact, _ = packing.machines_with_candidates(avail, dem, fd, rd, gd,
                                                    slack, ob)
        assert (exact <= got).all()
        fd2, rd2, gd2, sl = tk._eligibility_dims(fd, rd, gd, slack, ob)
        masks = [torch.from_numpy(mk).cuda()
                 for mk in tk._dim_masks(4, fd2, rd2, gd2)]
        bits = tk._dim_bits(4, fd2, rd2, gd2)
        a_t = torch.from_numpy(avail).cuda()
        d_t = torch.from_numpy(dem).cuda()
        k_el, k_any = kernel.eligible_launch(a_t, d_t, max(sl, 0.0),
                                             packing.EPS, *bits)
        p_el, p_any = tref.heartbeat_eligible64(a_t, d_t, max(sl, 0.0),
                                                packing.EPS, *masks)
        torch.cuda.synchronize()
        assert torch.equal(k_el.t(), p_el) and torch.equal(k_any, p_any)


@pytest.mark.parametrize("seed", range(3))
def test_staged_eligible_call_on_edge_values(kernel, seed):
    """Subnormals, one float32 ulp either side, beyond FLT_MAX, +-inf and
    NaN: the card's __double2float_rd/_ru equal the host's rounding."""
    avail, dem = tref.eligibility_edge_corpus(seed, packing.EPS)
    fd, rd, gd = np.arange(4), np.array([0, 1]), np.array([2, 3])
    for slack, ob in ((0.0, True), (0.25, True), (0.25, False)):
        with np.errstate(invalid="ignore", over="ignore"):
            got, got_any = tk._machines_with_candidates_on(
                avail, dem, fd, rd, gd, slack, ob, device="cuda")
            want, want_any = _host_rounded_eligible(avail, dem, slack, ob,
                                                    fd, rd, gd)
            exact, _ = packing.machines_with_candidates(avail, dem, fd, rd,
                                                        gd, slack, ob)
        assert got.tobytes() == want.tobytes(), (slack, ob)
        assert got_any.tobytes() == want_any.tobytes()
        assert (exact <= got).all()


def test_staged_eligible_call_from_four_threads(kernel):
    """Four shard threads call at once, each on its own stage and stream:
    every result equals its plain version, and the launch count is
    exact."""
    from concurrent.futures import ThreadPoolExecutor

    fd, rd, gd = np.arange(4), np.array([0, 1]), np.array([2, 3])
    cases = [_elig_case(700 + i, int(n), 512)
             for i, n in enumerate([1, 7, 32, 64, 65, 200, 3, 32] * 4)]
    want = [_host_rounded_eligible(c[0], c[1], c[2], c[3], fd, rd, gd)
            for c in cases]

    def shard(s):
        outs = []
        for i in range(s, len(cases), 4):
            avail, dem, slack, ob = cases[i][:4]
            for _ in range(5):
                got = tk._machines_with_candidates_on(
                    avail, dem, fd, rd, gd, slack, ob, device="cuda")
            outs.append((i, got))
        return outs

    before = kernel.LAUNCHES["heartbeat_eligible"]
    with ThreadPoolExecutor(4) as pool:
        results = [r for part in pool.map(shard, range(4)) for r in part]
    assert kernel.LAUNCHES["heartbeat_eligible"] == before + 5 * len(cases)
    assert len(results) == len(cases)
    for i, (el, any_) in results:
        assert el.tobytes() == want[i][0].tobytes(), i
        assert any_.tobytes() == want[i][1].tobytes(), i


def _corpus(seed, m=None):
    """A random wave: candidates, config, machine state, carried ledgers."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    m = m or int(rng.integers(5, 400))
    n_groups = int(rng.integers(1, 4))
    quant = rng.random() < 0.5            # coarse values force score ties
    dem = rng.uniform(0.02, 0.6, (n, 4))
    pri = rng.uniform(0.0, 2.0, n)
    if quant:
        dem = np.round(dem * 5) / 5 + 0.01
        pri = np.round(pri, 1)
    batch = CandidateBatch(
        dem=dem, pri=pri, srpt=rng.uniform(0.5, 300.0, n),
        grp=rng.integers(0, n_groups, n),
        loc=np.where(rng.random(n) < 0.3, rng.integers(0, m, n), -1),
        job=np.arange(n), tid=np.arange(n))
    cfg = MatcherConfig(
        eta_m=float(rng.choice([0.05, 0.2, 0.5])),
        remote_penalty=float(rng.choice([0.5, 0.8, 1.0])),
        kappa=float(rng.choice([0.02, 0.1, 10.0])),
        max_overbook=float(rng.choice([1.0, 1.25, 1.5])),
        fairness=drf_fairness if rng.random() < 0.5 else slot_fairness,
        use_priority=bool(rng.random() < 0.8),
        use_packing=bool(rng.random() < 0.8),
        use_srpt=bool(rng.random() < 0.8),
        use_overbooking=bool(rng.random() < 0.7),
        bundle_limit=int(rng.choice([2, 8, 64])),
        fit_dims=tuple(rng.choice(4, size=int(rng.integers(1, 5)),
                                  replace=False).tolist()))
    shares = {g: 1.0 for g in range(n_groups)}
    avail0 = rng.uniform(0.0, 1.2, (m, 4))
    alive = rng.random(m) < 0.9
    ledger = [(int(rng.integers(n_groups)), float(rng.uniform(0.5, 2.0)))
              for _ in range(int(rng.integers(0, 6)))]
    return batch, cfg, shares, avail0, alive, ledger


def _matcher(cfg, shares, m, ledger, n_shards=1):
    sm = ShardedMatcher(cfg, m, shares, n_shards=n_shards, capacity=float(m))
    for g, w in ledger:
        sm.matcher.deficits.allocated(g, w)
    return sm


@pytest.mark.parametrize("seed", range(12))
def test_wave_kernel_matches_plain(kernel, seed):
    batch, cfg, shares, avail0, alive, ledger = _corpus(seed)
    m = avail0.shape[0]
    sm = _matcher(cfg, shares, m, ledger)
    st = twave.DeviceWaveState("cuda")
    args, kw, _ = twave.wave_launch_args(st, sm, batch, avail0, alive, "test")
    got = kernel.match_wave_walk(*args, **kw)
    want = tref.match_wave_walk(*args, **kw)
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes(), seed


#: (n, m, seed): one candidate, a ragged warp, the s13 width, past what
#: registers hold, and past what shared memory holds (read from global)
WAVE_SIZES = [(1, 40, 0), (1, 300, 1), (1, 7, 2), (33, 64, 3), (33, 500, 4),
              (33, 2048, 5), (512, 2048, 6), (512, 300, 7), (512, 900, 8),
              (1500, 600, 9), (1500, 2048, 10), (1500, 150, 11),
              (4500, 1200, 12)]


def _sized_corpus(n, m, seed):
    """A wave of n candidates on m machines: more groups than two, the DRF
    and slot ledgers and the SRPT term in turn, bundle limits above one, and
    (for n > 1) a NaN demand on a fit dim and one on a dim that is outside
    the fit dims in some corpora."""
    batch, cfg, shares, avail0, alive, ledger = _corpus(seed, m=m)
    rng = np.random.default_rng(1000 + seed)
    n_groups = 3 + seed % 3
    dem = rng.uniform(0.02, 0.6, (n, 4))
    if seed % 2:
        dem = np.round(dem * 5) / 5 + 0.01      # score ties
    if n > 1:                                   # a lone candidate stays pickable
        dem[rng.integers(n), 0] = np.nan
        dem[rng.integers(n), 3] = np.nan
    batch = CandidateBatch(
        dem=dem, pri=np.round(rng.uniform(0.0, 2.0, n), 1 + seed % 2),
        srpt=rng.uniform(0.5, 300.0, n), grp=rng.integers(0, n_groups, n),
        loc=np.where(rng.random(n) < 0.3, rng.integers(0, m, n), -1),
        job=np.arange(n), tid=np.arange(n))
    cfg = dataclasses.replace(
        cfg, fairness=drf_fairness if seed % 2 == 0 else slot_fairness,
        use_srpt=seed % 3 != 2, bundle_limit=(2, 8, 64)[seed % 3],
        fit_dims=(0, 1, 2) if seed % 4 == 1 else (0, 1, 2, 3))
    shares = {g: 1.0 + g for g in range(n_groups)}
    ledger = [(int(rng.integers(n_groups)), float(rng.uniform(0.5, 2.0)))
              for _ in range(4)]
    return batch, cfg, shares, avail0, alive, ledger


@pytest.mark.parametrize("n,m,seed", WAVE_SIZES)
def test_wave_kernel_matches_plain_at_sizes(kernel, n, m, seed):
    batch, cfg, shares, avail0, alive, ledger = _sized_corpus(n, m, seed)
    sm = _matcher(cfg, shares, m, ledger)
    st = twave.DeviceWaveState("cuda")
    args, kw, _ = twave.wave_launch_args(st, sm, batch, avail0, alive, "test")
    assert args[9].shape[0] > 2                  # G: the dense ledger
    got = kernel.match_wave_walk(*args, **kw)
    want = tref.match_wave_walk(*args, **kw)
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes(), (n, m)
    assert int(want[7]) > 0


@pytest.mark.parametrize("n_shards", [1, 2])
def test_cuda_wave_matches_numpy_wave_over_carried_waves(kernel, n_shards,
                                                         monkeypatch):
    for seed in range(6):
        batch, cfg, shares, avail0, alive, ledger = _corpus(100 + seed)
        m = avail0.shape[0]
        runs = {}
        for impl in ("numpy", "cuda"):
            monkeypatch.setenv(tk.KERNELS_ENV, f"match_wave={impl}")
            sm = _matcher(cfg, shares, m, ledger, n_shards)
            avail = avail0.copy()
            picks = []

            def cb(gi, mm, avail=avail, picks=picks):
                picks.append((gi, mm))
                avail[mm] -= batch.dem[gi]

            with tk.use_device("cuda"), sm:
                for _ in range(3):
                    sm.match_wave(avail, alive, batch, cb)
            runs[impl] = (picks, avail.tobytes(), sm.matcher._ema_score,
                          sm.matcher._ema_srpt, sm.matcher.deficits.deficit)
        assert runs["cuda"] == runs["numpy"], (seed, n_shards)


@pytest.mark.parametrize("seed", range(3))
def test_cuda_wave_unknown_group_and_custom_fairness(kernel, seed,
                                                     monkeypatch):
    """A group outside the ledger stays on the kernel (unpicked it changes
    nothing, picked it raises the ledger's KeyError like the numpy wave);
    a fairness function with no device form raises."""
    batch, cfg, shares, avail0, alive, ledger = _corpus(200 + seed)
    m = avail0.shape[0]
    batch.grp[::3] = max(shares) + 5
    for scale in (50.0, 1.0):
        b = CandidateBatch(*(np.array(getattr(batch, f.name), copy=True)
                             for f in dataclasses.fields(batch)))
        b.dem[b.grp > max(shares)] *= scale
        runs = {}
        for impl in ("numpy", "cuda"):
            monkeypatch.setenv(tk.KERNELS_ENV, f"match_wave={impl}")
            sm = _matcher(cfg, shares, m, ledger)
            avail = avail0.copy()
            picks = []

            def cb(gi, mm, avail=avail, picks=picks, b=b):
                picks.append((gi, mm))
                avail[mm] -= b.dem[gi]

            with tk.use_device("cuda"), sm:
                try:
                    for _ in range(2):
                        sm.match_wave(avail, alive, b, cb)
                    runs[impl] = (picks, avail.tobytes(),
                                  sm.matcher._ema_score,
                                  sm.matcher.deficits.deficit)
                except KeyError as exc:
                    runs[impl] = ("KeyError", exc.args)
        assert runs["cuda"] == runs["numpy"], (seed, scale)
    monkeypatch.delenv(tk.KERNELS_ENV)
    odd = dataclasses.replace(cfg, fairness=lambda dem: float(dem.sum()))
    with tk.use_device("cuda"), _matcher(odd, shares, m, ledger) as sm:
        with pytest.raises(NotImplementedError, match="fairness"):
            sm.match_wave(avail0.copy(), alive, batch, lambda gi, mm: None)


def _sim_against_numpy(mode, pin_kernels, monkeypatch, n_shards=2):
    """The simulator on the card (``pin_kernels``: a ``REPRO_KERNELS`` pin
    of some ops to numpy, or none) against its all-numpy twin."""
    from repro_torch.sim import make_workload, run_workload

    dags = make_workload("tpch", 4, seed=5)
    out = {}
    for pin in (pin_kernels, "all=numpy"):
        monkeypatch.setenv(tk.KERNELS_ENV, pin)
        tk.reset_profile()
        res = run_workload(dags, "dagps", n_machines=64, interarrival=2.0,
                           seed=5, n_groups=2, matcher_shards=n_shards,
                           matcher_mode=mode, schedule_cache=False,
                           device="cuda")
        out[pin] = ({j.job_id: repr(j.jct) for j in res.jobs},
                    repr(res.makespan))
        prof = tk.profile_snapshot()
        if pin != "all=numpy":
            assert not any(k.endswith(".demoted") for k in prof)
            assert prof["scan.cuda"][0] > 0
            key = "match_wave.cuda" if mode == "exact" and not pin \
                else "machines_with_candidates.cuda"
            assert prof[key][0] > 0
    assert out[pin_kernels] == out["all=numpy"]


@pytest.mark.parametrize("mode", ["exact", "routed"])
def test_sim_on_cuda_matches_numpy_pinned(kernel, mode, monkeypatch):
    _sim_against_numpy(mode, "", monkeypatch)


def test_sim_numpy_wave_fans_eligibility_out_on_the_card(kernel,
                                                          monkeypatch):
    """The numpy wave asks the card for each shard's eligibility from the
    shard threads at once (4 shards, a stage per thread)."""
    _sim_against_numpy("exact", "match_wave=numpy", monkeypatch, n_shards=4)


def test_scan_call_from_four_threads(kernel):
    """The build service's worker threads scan at once, each on its own
    stage (buffers and stream): every call's bitmaps equal ``scan_starts``
    bit for bit, and the launch count is exact."""
    from concurrent.futures import ThreadPoolExecutor

    cases = [_grid(900 + i) for i in range(16)]

    def work(t):
        outs = []
        for i in range(t, len(cases), 4):
            avail, Vs, ks, rng = cases[i]
            T = avail.shape[1]
            for j in range(6):
                plo = 2 * j
                phi = T - 3 * j - 1
                rev = bool(j % 2)
                got = tk._scan_on(avail, Vs, ks, plo, phi, rev, device="cuda")
                outs.append((i, plo, phi, rev, got))
        return outs

    before = kernel.LAUNCHES["scan_bitmaps"]
    with ThreadPoolExecutor(4) as pool:
        results = [r for part in pool.map(work, range(4)) for r in part]
    assert kernel.LAUNCHES["scan_bitmaps"] == before + len(results) == \
        before + 6 * len(cases)
    for i, plo, phi, rev, got in results:
        avail, Vs, ks, _ = cases[i]
        want = tk.scan_starts(avail, Vs, ks, plo, phi, rev)
        assert got.tobytes() == want.tobytes(), (i, plo, phi, rev)


@pytest.mark.parametrize("d", [4, 3])
def test_resident_scan_reads_its_window_in_place(kernel, d):
    """``scan_resident`` on windows at every first tick of a resident
    (m, Tb, d) mirror (float4 loads at d = 4, scalar at d = 3) equals the
    plain version on the same window copied out, bit for bit."""
    rng = np.random.default_rng(40 + d)
    m, Tb = 4, 512
    mirror = torch.from_numpy(rng.uniform(0.0, 1.0, (m, Tb, d))
                              .astype(np.float32)).cuda()
    stage = kernel.resident_stage("cuda")
    for first in (0, 1, 3, 17, 100):
        g, W = int(rng.integers(1, 33)), int(rng.integers(1, 200))
        Vs = ceil32(rng.uniform(0.05, 0.7, (g, d))).astype(np.float32)
        ks = rng.integers(1, 129, g).astype(np.int32)
        L = min(W + int(ks.max()) - 1, Tb - first)
        for rev in (False, True):
            slot = stage.acquire(256 + g * d * 4 + g * 4, g * W * m)
            kernel.scan_resident(mirror, first, L, Vs, ks, W, rev, 0, slot,
                                 stage)
            slot.wait()
            got = slot.h_out_np[:g * W * m].reshape(g, W, m).copy()
            stage.release(slot)
            win = torch.zeros((m, W + int(ks.max()), d), device="cuda")
            win[:, :L] = mirror[:, first:first + L]
            want = tref.scan_bitmaps(win, torch.from_numpy(Vs).cuda(),
                                     torch.from_numpy(ks).cuda(), L, W)
            want = want.cpu().numpy() != 0
            if rev:
                want = want[:, ::-1, :]
            assert got.tobytes() == np.ascontiguousarray(want).tobytes(), \
                (first, rev)


def test_resident_scan_bitwise_under_mutation(kernel, monkeypatch):
    """The jit backend on the card: 60 rounds of commits, growth and
    restores, each launch's rows read only after the next round's
    mutation, equal ``scan_starts`` on the grid at launch."""
    from repro_torch.core import Space
    from repro_torch.core.engine import JitBackend
    from repro_torch.core.engine import jit as J

    monkeypatch.setattr(J, "MIN_DEVICE_G", 1)
    J.reset_profile()
    be = JitBackend()
    rng = np.random.default_rng(9)
    s = Space(m=4, d=4, horizon=64)
    snaps, pending = [], None
    with tk.use_device("cuda"):
        for round_ in range(60):
            op = rng.random()
            if op < 0.5:
                v = rng.uniform(0.1, 0.5, 4)
                k = int(rng.integers(1, 10))
                mm, t0 = s.earliest_fit(v, k, int(rng.integers(0, 40)))
                s.commit(round_, mm, t0, k, v)
            elif op < 0.6:
                (s._grow_front if rng.random() < 0.5 else s._grow_back)()
            elif op < 0.75 or not snaps:
                snaps.append(s.snapshot())
            else:
                s.restore(snaps.pop())
            if pending is not None:          # read after this mutation
                goods, g, want = pending
                got = np.stack([goods[i]() for i in range(g)])
                assert np.array_equal(got, want), round_
            g = int(rng.integers(2, 12))
            Vs = ceil32(rng.uniform(0.2, 0.7, (g, 4)))
            ks = rng.integers(1, 12, g)
            plo = int(rng.integers(0, max(s.T - 10, 1)))
            phi = int(rng.integers(plo + 2, s.T))
            rev = bool(rng.integers(0, 2))
            pending = (be.scan_kernel(s, Vs, ks, plo, phi, rev), g,
                       tk.scan_starts(s.avail, Vs, ks, plo, phi, rev))
    assert J.PROFILE["device_calls"] == 60


def test_jit_build_on_the_card_equals_batched(kernel):
    from repro_torch.core import build_schedule
    from repro_torch.core.engine import jit as J
    from repro_torch.sim.workload import production_dag

    J.reset_profile()
    for seed in range(3):
        dag = production_dag(np.random.default_rng(seed), scale=0.35,
                             share=3)
        bat = build_schedule(dag, 3, ticks=96, backend="batched",
                             device="cuda")
        jit = build_schedule(dag, 3, ticks=96, backend="jit", device="cuda")
        assert bat.makespan == jit.makespan
        assert np.array_equal(bat.start, jit.start)
        assert np.array_equal(bat.machine, jit.machine)
    assert J.PROFILE["device_calls"] > 0


@pytest.mark.parametrize("mode", ["process", "thread"])
def test_build_service_on_the_card_equals_serial(kernel, mode):
    """Build workers on the card (process mode: a CUDA context per worker)
    give the serial builds' schedules; no retry, crash or fallback."""
    from repro_torch.core import build_schedule
    from repro_torch.core.buildsvc import BuildService
    from repro_torch.sim.workload import production_dag

    dags = [production_dag(np.random.default_rng(s), scale=0.35, share=3)
            for s in range(4)]
    want = [build_schedule(d, 3, ticks=96, device="cuda") for d in dags]
    with BuildService(workers=2, mode=mode, device="cuda") as svc:
        got = [h.result(120) for h in
               [svc.submit(d, 3, ticks=96) for d in dags]]
    for w, g in zip(want, got):
        assert g.makespan == w.makespan
        assert np.array_equal(g.start, w.start)
        assert np.array_equal(g.machine, w.machine)
    assert svc.stats["retries"] == svc.stats["worker_crashes"] == 0
    assert svc.stats["inline_fallbacks"] == 0
    if mode == "process":
        assert svc.start_method in ("forkserver", "spawn")


def test_build_worker_without_the_card_fails_its_build(kernel, monkeypatch):
    """A worker that cannot reach the card fails the build with that error:
    no retry, and no inline build that would hide it."""
    from repro_torch.core.buildsvc import MP_ENV, BuildService
    from repro_torch.sim.workload import production_dag

    monkeypatch.setenv(MP_ENV, "spawn")          # the worker's env is ours
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    dag = production_dag(np.random.default_rng(0), scale=0.35, share=3)
    with BuildService(workers=1, mode="process", device="cuda") as svc:
        with pytest.raises(RuntimeError, match="cuda"):
            svc.submit(dag, 3, ticks=96).result(120)
    assert svc.stats["retries"] == svc.stats["inline_fallbacks"] == 0


def _parity_arrivals():
    """tests/test_service.py's parity workload: 6 production jobs, seed 3,
    interarrival 25, groups i % 2."""
    from repro_torch.sim import make_workload

    rng = np.random.default_rng(0)
    arrivals, t = [], 0.0
    for i, dag in enumerate(make_workload("production", 6, seed=3)):
        arrivals.append((t, dag, i % 2))
        t += float(rng.exponential(25.0))
    return arrivals


def test_service_on_cuda_matches_simulator(kernel):
    """The scheduler service on the card equals ``ClusterSim(speculate=
    False)`` on the card grant for grant, and the committed golden by
    ``repr``; its builds and waves launched the scan and wave kernels."""
    import json
    import os

    from repro_torch.core import FaultPlan
    from repro_torch.sim.cluster import ClusterSim, SimConfig, scheme
    from repro_torch.svc import ServiceConfig, run_service_workload

    arrivals = _parity_arrivals()
    kernel.reset_launches()
    svc = run_service_workload(arrivals, ServiceConfig(n_machines=12, seed=0),
                               scheme("dagps"), fault_plan=FaultPlan())
    launches = kernel.launch_counts()
    assert launches["scan_bitmaps"] > 0 and launches["match_wave_walk"] > 0
    sim = ClusterSim(SimConfig(n_machines=12, seed=0, speculate=False,
                               record_placements=True, fault_plan=FaultPlan(),
                               device="cuda"),
                     scheme("dagps")).run(arrivals)
    assert svc.placements == sim.placements
    assert sorted((j.job_id, repr(j.jct)) for j in svc.jobs) == \
        sorted((j.job_id, repr(j.jct)) for j in sim.jobs)
    assert repr(svc.makespan) == repr(sim.makespan)
    assert all(v == 1 for v in svc.effective.values())
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "golden_service.json")) as f:
        golden = json.load(f)
    assert repr(svc.makespan) == golden["makespan"]
    assert [[repr(t), j, tk_, m] for t, j, tk_, m in svc.placements] == \
        golden["placements"]


def test_tcp_service_launches_from_its_serving_thread(kernel, monkeypatch):
    """The wall-clock service over tcp (4 agent threads, a client): every
    scan and wave launch of the run comes from the serving thread, whose
    pumps reach the card through the core's own device."""
    import threading
    import time

    from repro_torch.core import FaultPlan, faults
    from repro_torch.sim import make_workload
    from repro_torch.sim.cluster import scheme
    from repro_torch.svc import Client, ServiceConfig, connect
    from repro_torch.svc.agent import Agent
    from repro_torch.svc.scheduler import SchedulerCore, SchedulerService

    by_thread: dict = {}
    count = kernel._count

    def counted(name):
        key = (threading.current_thread().name, name)
        by_thread[key] = by_thread.get(key, 0) + 1
        count(name)

    monkeypatch.setattr(kernel, "_count", counted)
    with faults.scope(FaultPlan()):
        core = SchedulerCore(ServiceConfig(n_machines=4, seed=0,
                                           heartbeat_period=0.2),
                             scheme("dagps"))
        svc = SchedulerService(core, "tcp://127.0.0.1:0")
        agents, client = [], None
        try:
            svc.serve_in_thread(poll_interval=0.005)
            for m in range(4):
                agents.append(Agent(svc.addr, m, period=0.2,
                                    time_scale=0.0005))
                agents[-1].start()
            client = Client(connect(svc.addr))
            dags = make_workload("production", 2, seed=21)
            for dag in dags:
                client.submit(dag, t=0.0)
            deadline = time.monotonic() + 120.0
            while client.pending and time.monotonic() < deadline:
                client.poll()
                time.sleep(0.01)
            assert client.pending == 0, "jobs did not complete over tcp"
            fs = client.stats(timeout=10.0)["fault_stats"]
            assert fs["service"]["completions"] == sum(d.n for d in dags)
        finally:
            for ag in agents:
                ag.stop()
            if client is not None:
                client.ch.close()
            svc.close()
    assert by_thread.get(("repro-sched", "scan_bitmaps"), 0) > 0
    assert by_thread.get(("repro-sched", "match_wave_walk"), 0) > 0
    assert {t for t, _ in by_thread} == {"repro-sched"}


def test_explicit_only_ops_on_the_card(kernel):
    """heartbeat_masks, fits_mask and pack_score's cuda impls: the same
    bits as their torch impls on the CPU (the same rounding), pack_score
    within float32 of it; heartbeat_masks launches the eligibility
    kernel."""
    fd, rd, gd = np.arange(4), np.array([0, 1]), np.array([2, 3])
    rng = np.random.default_rng(11)
    for n, m in ((1, 24), (32, 2048), (512, 2048)):
        avail = rng.uniform(-0.05, 1.0, (m, 4))
        dem = rng.uniform(0.0, 0.9, (n, 4))
        for slack, ob in ((0.25, True), (0.0, False)):
            args = (avail, dem, fd, rd, gd, slack, ob)
            before = kernel.LAUNCHES["heartbeat_eligible"]
            got = tk._heartbeat_masks_on(*args, device="cuda")
            assert kernel.LAUNCHES["heartbeat_eligible"] == before + 1
            want = tk._heartbeat_masks_on(*args, device="cpu")
            assert got[0].tobytes() == want[0].tobytes()
            assert got[1].tobytes() == want[1].tobytes()
            fe, oe = packing.heartbeat_masks(*args)
            assert ((fe | oe) <= (got[0] | got[1])).all()
        for dims in (None, [0, 2], []):
            a = tk._fits_mask_on(avail, dem, dims, 0.1, device="cuda")
            b = tk._fits_mask_on(avail, dem, dims, 0.1, device="cpu")
            assert a.tobytes() == b.tobytes()
        np.testing.assert_allclose(
            tk._pack_score_on(avail, dem, True, device="cuda"),
            packing.pack_score(avail, dem, clip=True), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# LM kernels: flash attention, the RG-LRU scan and WKV6
# ----------------------------------------------------------------------

@pytest.fixture
def lm_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rg_lru import kernel as rk
    from repro_torch.kernels.rwkv6 import kernel as wk
    torch.backends.cuda.matmul.allow_tf32 = False
    return fk, rk, wk


FLASH_CARD_CASES = [
    # (B, Sq, Sk, H, KV, hd), dtype, opts
    ((2, 512, 512, 10, 1, 256), "bfloat16", dict(causal=True, window=200)),
    ((2, 1000, 1000, 4, 2, 64), "bfloat16", dict(causal=True, window=300)),
    ((2, 333, 517, 4, 2, 64), "float32", dict(causal=False, cap=30.0)),
    ((1, 130, 130, 4, 1, 256), "float32", dict(causal=True, window=50)),
    ((2, 100, 200, 6, 3, 48), "bfloat16", dict(causal=False, cap=5.0)),
    ((3, 1, 77, 2, 1, 32), "float32", dict(causal=False)),
    # the Hopper kernel's padded widths (hd 32 and 48 -> 64, 128, 256),
    # Sq and Sk off the 128/64 tile grid, window edges inside a tile,
    # Sq != Sk both ways, a bf16 soft-cap and H/KV = 10
    ((2, 150, 150, 4, 2, 32), "bfloat16", dict(causal=True)),
    ((2, 300, 300, 4, 2, 48), "bfloat16", dict(causal=True, window=100)),
    ((1, 200, 333, 10, 1, 64), "bfloat16", dict(causal=False, cap=20.0)),
    ((2, 777, 777, 10, 1, 128), "bfloat16", dict(causal=True, window=333)),
    ((1, 130, 517, 10, 1, 128), "bfloat16", dict(causal=False, window=70)),
    ((1, 1000, 1000, 10, 1, 256), "bfloat16", dict(causal=True, window=500)),
    ((2, 260, 130, 4, 1, 256), "bfloat16", dict(causal=True)),
    ((1, 64, 1000, 2, 1, 256), "bfloat16", dict(causal=False, cap=30.0)),
    # the other families' head shapes: GQA with KV > 1 and MHA at hd 128
    # and 64, global causal layers, gemma2's global layer (hd 256, 8/4,
    # cap 50), and phi4-mini's smoke width hd 12 (float32 only)
    ((1, 1000, 1000, 32, 8, 128), "bfloat16", dict(causal=True, window=333)),
    ((2, 700, 700, 24, 8, 128), "bfloat16", dict(causal=True)),
    ((1, 1024, 1024, 16, 16, 128), "bfloat16", dict(causal=True)),
    ((1, 600, 600, 28, 4, 128), "bfloat16", dict(causal=True)),
    ((1, 1000, 1000, 32, 32, 64), "bfloat16", dict(causal=True)),
    ((1, 1024, 1024, 8, 4, 256), "bfloat16", dict(causal=True, cap=50.0)),
    ((2, 333, 333, 4, 2, 12), "float32", dict(causal=True)),
]


@pytest.mark.parametrize("shape,dtype,opts", FLASH_CARD_CASES)
def test_flash_kernel_matches_plain(lm_kernels, shape, dtype, opts):
    from repro_torch.kernels.flash_attention import ref as fref
    fk = lm_kernels[0]
    B, Sq, Sk, H, KV, hd = shape
    rng = np.random.default_rng(sum(shape))
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        "cuda", dt) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                              (B, Sk, KV, hd)))
    before = fk.LAUNCHES["flash_attention"]
    got = fk.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention"] == before + 1
    want = fref.attention(q, k, v, **opts)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert got.dtype == dt and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("seed", range(3))
def test_wgmma_probe_matches_torch(lm_kernels, seed):
    """One wgmma product per layout the flash kernel uses, against torch in
    float32: s = a b^T with both operands K-major (m64n64k16, four k-steps
    inside a 128-byte swizzle row) and o = a v with a in registers and v
    MN-major across four 64-column boxes (m64n256k16)."""
    fk = lm_kernels[0]
    rng = np.random.default_rng(seed)
    a, b, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        "cuda", torch.bfloat16) for s in ((64, 64), (64, 64), (64, 256)))
    s, o = fk.wgmma_probe(a, b, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(o, a.float() @ v.float(), rtol=1e-5,
                               atol=1e-4)


def test_flash_kernel_refuses_what_it_does_not_take(lm_kernels):
    fk = lm_kernels[0]
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    k = torch.zeros(1, 8, 1, 64, device="cuda")
    with pytest.raises(TypeError):
        fk.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        fk.flash_attention(q.transpose(1, 2), k, k)
    big = torch.zeros(1, 8, 1, 272, device="cuda")
    with pytest.raises(ValueError):
        fk.flash_attention(big, big, big)
    odd = torch.zeros(1, 8, 1, 40, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fk.flash_attention(odd, odd, odd)


@pytest.mark.parametrize("shape", [(2, 1000, 300), (8, 1, 2560),
                                   (1, 4099, 64), (3, 1, 301), (2, 7, 333),
                                   (2, 4096, 2561), (4, 4096, 2560),
                                   (1, 9, 31)])
def test_rglru_kernel_bitwise_equal_to_plain(lm_kernels, shape):
    from repro_torch.kernels.rg_lru import ref as rref
    rk = lm_kernels[1]
    B, S, D = shape
    rng = np.random.default_rng(S + D)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()
    a = torch.from_numpy(rng.uniform(0.5, 0.999, shape).astype(
        np.float32)).cuda()
    h0 = torch.from_numpy(rng.standard_normal((B, D), np.float32)).cuda()
    y, hT = rk.rglru_scan(x, a, h0)
    y2, hT2 = rref.rglru_scan(x, a, h0)
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    # state chained across two halves == one run, bitwise
    h = S // 2
    ya, hA = rk.rglru_scan(x[:, :h].contiguous(), a[:, :h].contiguous(), h0)
    yb, hB = rk.rglru_scan(x[:, h:].contiguous(), a[:, h:].contiguous(), hA)
    assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(hB, hT)


def _wkv_inputs(B, S, H, N, dtype, seed, model=None):
    """r, k, v in ``dtype``; w, u and s0 float32; all on the card.

    ``model`` (the default for bfloat16): unit-scale r, k, v and the
    model's decays (w = exp(-exp(w0 + d)), w0 ~ U(-6, -5)), so the state
    sums hundreds of steps.  Otherwise the draw of ``tests/test_kernels.py``
    (r, k, v at scale 0.5, w in (0.45, 0.95)), for which its fixed 2e-5
    float32 limit was set: at the model's decays y's terms reach 10 to 100,
    and two float32 summation orders then part by about 1e-4 near y = 0."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(a, d=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            "cuda", d)
    shape = (B, S, H, N)
    if model is None:
        model = dtype == "bfloat16"
    if model:
        r, k, v = (t(rng.standard_normal(shape), dt) for _ in range(3))
        w0 = rng.uniform(-6.0, -5.0, (H, N))
        w = t(np.exp(-np.exp(w0 + rng.uniform(-0.5, 0.5, shape))))
        u = t(rng.uniform(0.0, 0.5, (H, N)))
    else:
        r, k, v = (t(rng.standard_normal(shape) * 0.5) for _ in range(3))
        w = t(0.45 + 0.5 / (1.0 + np.exp(-rng.standard_normal(shape))))
        u = t(rng.standard_normal((H, N)) * 0.3)
    s0 = t(rng.standard_normal((B, H, N, N)) * 0.1)
    return r, k, v, w, u, s0


WKV_CARD_CASES = [
    # (B, S, H, N), dtype: the three head sizes, S=1 (decode), ragged S
    ((2, 64, 4, 16), "float32"),
    ((2, 100, 3, 32), "bfloat16"),
    ((1, 1000, 2, 64), "bfloat16"),
    ((2, 257, 4, 64), "float32"),
    ((4, 1, 8, 64), "float32"),
    ((8, 1, 64, 64), "bfloat16"),
    ((1, 33, 2, 16), "bfloat16"),
    # each head size at S = 1, and S off the 16-step staging chunk
    ((3, 1, 5, 16), "bfloat16"),
    ((2, 1, 3, 32), "float32"),
    ((2, 1, 4, 16), "float32"),
    ((1, 1, 6, 32), "bfloat16"),
    ((2, 17, 3, 32), "float32"),
    ((1, 4097, 2, 64), "bfloat16"),
]


@pytest.mark.parametrize("shape,dtype", WKV_CARD_CASES)
def test_wkv6_kernel_matches_plain(lm_kernels, shape, dtype):
    from repro_torch.kernels.rwkv6 import ref as wref
    wk = lm_kernels[2]
    args = _wkv_inputs(*shape, dtype, sum(shape))
    before = wk.LAUNCHES["wkv6"]
    y, sT = wk.wkv6(*args)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["wkv6"] == before + 1
    y2, sT2 = wref.wkv6(*args)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert y.dtype == args[0].dtype and sT.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    torch.testing.assert_close(y.float(), y2.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(sT, sT2, rtol=1e-3, atol=1e-3)
    # state chained across two halves == one run, bitwise: each step's
    # arithmetic is the same and the state crosses in float32
    S = shape[1]
    if S > 1:
        h = S // 2
        r, k, v, w, u, s0 = args
        ya, sA = wk.wkv6(*[t[:, :h].contiguous() for t in (r, k, v, w)], u,
                         s0)
        yb, sB = wk.wkv6(*[t[:, h:].contiguous() for t in (r, k, v, w)], u,
                         sA)
        assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(sB, sT)


@pytest.mark.parametrize("shape", [(2, 256, 4, 16), (2, 300, 3, 32),
                                   (1, 512, 2, 64)])
def test_wkv6_kernel_f32_at_model_scale_within_error_bound(lm_kernels, shape):
    """float32 at the model's scale: y reaches 100 and more, so the fixed
    2e-5 limit does not apply; kernel and plain version, two float32
    evaluations, lie within twice `ref.f32_error_bound` of each other.
    The bound grows with N (1.5e-3 of max |y| at N=64, S=512); it stays
    under a quarter of bf16's relative limit of 2e-2."""
    from repro_torch.kernels.rwkv6 import ref as wref
    wk = lm_kernels[2]
    args = _wkv_inputs(*shape, "float32", sum(shape) + 1, model=True)
    y, sT = wk.wkv6(*args)
    y2, sT2 = wref.wkv6(*args)
    yb, sb = wref.f32_error_bound(*args)
    assert float(y2.abs().max()) > 50.0
    assert float(yb.max()) < 5e-3 * float(y2.abs().max())
    assert bool(((y.double() - y2.double()).abs() <= 2 * yb).all())
    assert bool(((sT.double() - sT2.double()).abs() <= 2 * sb).all())


def test_wkv6_kernel_takes_views_off_the_16_byte_grain(lm_kernels):
    """r and w starting one element into their storage: the wrapper copies
    them to aligned tensors, and the result is the aligned run's."""
    wk = lm_kernels[2]
    args = _wkv_inputs(2, 40, 3, 64, "bfloat16", 5)
    y, sT = wk.wkv6(*args)
    r, k, v, w, u, s0 = args
    rb = torch.empty(r.numel() + 1, dtype=r.dtype, device="cuda")
    wb = torch.empty(w.numel() + 1, dtype=w.dtype, device="cuda")
    r2 = rb[1:].view(r.shape).copy_(r)
    w2 = wb[1:].view(w.shape).copy_(w)
    assert r2.data_ptr() % 16 and w2.data_ptr() % 16
    y2, sT2 = wk.wkv6(r2, k, v, w2, u, s0)
    assert torch.equal(y, y2) and torch.equal(sT, sT2)


def test_wkv6_kernel_near_its_order_twin(lm_kernels):
    """Kernel and `ref.wkv6_tiled` (the kernel's summation order, without
    FMAs) in float32 at the model's scale: within twice the first-order
    bound, as any two float32 evaluations."""
    from repro_torch.kernels.rwkv6 import ref as wref
    wk = lm_kernels[2]
    for shape in ((2, 64, 3, 16), (2, 48, 2, 32), (1, 80, 2, 64)):
        args = _wkv_inputs(*shape, "float32", sum(shape), model=True)
        y, sT = wk.wkv6(*args)
        y2, sT2 = wref.wkv6_tiled(*args)
        yb, sb = wref.f32_error_bound(*args)
        assert bool(((y.double() - y2.double()).abs() <= 2 * yb).all())
        assert bool(((sT.double() - sT2.double()).abs() <= 2 * sb).all())


def test_wkv6_kernel_refuses_what_it_does_not_take(lm_kernels):
    wk = lm_kernels[2]
    r, k, v, w, u, s0 = _wkv_inputs(1, 8, 2, 64, "bfloat16", 0)
    with pytest.raises(TypeError):            # mixed r/k/v dtypes
        wk.wkv6(r, k.float(), v, w, u, s0)
    with pytest.raises(TypeError):            # fp16
        wk.wkv6(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(TypeError):            # w must be float32
        wk.wkv6(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError):           # a head size it has no form for
        wk.wkv6(*_wkv_inputs(1, 8, 2, 48, "float32", 0))
    with pytest.raises(ValueError):           # not contiguous
        wk.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u,
                s0)
    with pytest.raises(ValueError):           # state of another shape
        wk.wkv6(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError):           # on the CPU
        wk.wkv6(*[t.cpu() for t in (r, k, v, w, u, s0)])


def test_lm_ops_launch_kernels_unless_pinned(lm_kernels, monkeypatch):
    from repro_torch.kernels import pin
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rg_lru import ops as rops
    from repro_torch.kernels.rwkv6 import ops as wops
    fk, rk, wk = lm_kernels
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(1, 16, 128, device="cuda")
    a = torch.rand(1, 16, 128, device="cuda")
    h0 = torch.zeros(1, 128, device="cuda")
    wkv = _wkv_inputs(1, 16, 2, 64, "bfloat16", 3)
    monkeypatch.delenv(pin.PIN_ENV, raising=False)
    f0, r0 = fk.LAUNCHES["flash_attention"], rk.LAUNCHES["rglru_scan"]
    w0 = wk.LAUNCHES["wkv6"]
    fops.flash_attention(q, q, q, window=16)
    rops.rglru_scan(x, a, h0)
    wops.wkv6(*wkv)
    assert fk.LAUNCHES["flash_attention"] == f0 + 1
    assert rk.LAUNCHES["rglru_scan"] == r0 + 1
    assert wk.LAUNCHES["wkv6"] == w0 + 1
    monkeypatch.setenv(pin.PIN_ENV, "plain")
    out = fops.flash_attention(q, q, q, window=16)
    y, _ = rops.rglru_scan(x, a, h0)
    yw, sw = wops.wkv6(*wkv)
    assert out.is_cuda and y.is_cuda and yw.is_cuda and sw.is_cuda
    assert fk.LAUNCHES["flash_attention"] == f0 + 1
    assert rk.LAUNCHES["rglru_scan"] == r0 + 1
    assert wk.LAUNCHES["wkv6"] == w0 + 1


def test_smoke_model_on_card_through_both_kernels(lm_kernels, monkeypatch):
    """recurrentgemma smoke() in f32 on the card: greedy_generate through
    the kernels equals its plain-pinned twin; the Batcher answers every
    request through the rg_lru kernel."""
    from repro_torch import configs
    from repro_torch.kernels import pin
    from repro_torch.models import model as M
    from repro_torch.serve import Batcher, ServeConfig, greedy_generate
    fk, rk, _ = lm_kernels
    cfg = configs.get_smoke("recurrentgemma_2b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40))).cuda()
    out = {}
    for pinned in ("", "plain"):
        monkeypatch.setenv(pin.PIN_ENV, pinned)
        fk.reset_launches()
        rk.reset_launches()
        logits, _ = M.prefill(params, cfg, {"tokens": prompt},
                              last_only=True)
        toks = greedy_generate(params, cfg, prompt, 8)
        out[pinned] = (logits, toks, fk.LAUNCHES["flash_attention"],
                       rk.LAUNCHES["rglru_scan"])
    n_local = sum(m == "local" for m, _ in cfg.layer_plan)
    n_rec = sum(m == "rglru" for m, _ in cfg.layer_plan)
    assert out[""][2:] == (2 * n_local, 2 * n_rec + 8 * n_rec)
    assert out["plain"][2:] == (0, 0)
    torch.testing.assert_close(out[""][0], out["plain"][0], rtol=0,
                               atol=1e-4)
    assert torch.equal(out[""][1], out["plain"][1])
    monkeypatch.delenv(pin.PIN_ENV)
    rk.reset_launches()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 5, 12)]
    res = Batcher(params, cfg, ServeConfig(batch=2, max_seq=16)).serve(
        prompts, 6)
    assert all(r is not None and len(r) == 6 for r in res)
    assert rk.LAUNCHES["rglru_scan"] > 0


def test_moe_on_card_routes_and_drops_as_on_the_cpu(lm_kernels):
    """moe_forward on the card in float32 (default matmul settings: no
    TF32) against the CPU: the same expert choices, the same kept and
    dropped (token, choice) pairs, outputs within 1e-5."""
    from repro_torch.models import layers as L
    assert not torch.backends.cuda.matmul.allow_tf32
    d, T = 64, 96
    for mode, n_shared in (("softmax_topk", 1), ("topk_softmax", 0)):
        cfg = L.MoEConfig(n_experts=8, top_k=2, d_expert=48,
                          n_shared=n_shared, capacity_factor=0.75,
                          router_mode=mode)
        p = L.moe_init(torch.Generator().manual_seed(1), d, cfg,
                       dtype=torch.float32, device="cpu")
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (2, T // 2, d), np.float32))
        pc = {k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict)
                  else v.cuda()) for k, v in p.items()}
        C = L.moe_capacity(T, cfg)
        plans = []
        for xx, pp in ((x, p), (x.cuda(), pc)):
            w, idx = L.moe_route(xx.reshape(1, T, d), pp["router"], cfg)
            plans.append([t.cpu() for t in (idx, *L.moe_plan(idx, w, C, 8))])
        (idx, st, sw, keep, buf), (idx2, st2, sw2, keep2, buf2) = plans
        assert torch.equal(idx, idx2) and torch.equal(keep, keep2)
        assert torch.equal(st, st2) and torch.equal(buf, buf2)
        assert 0 < int(keep.sum()) < keep.numel()
        torch.testing.assert_close(sw2, sw, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(L.moe_forward(pc, x.cuda(), cfg).cpu(),
                                   L.moe_forward(p, x, cfg), rtol=1e-5,
                                   atol=1e-5)


def test_moe_combine_repeats_on_the_card(lm_kernels):
    """``moe_combine`` at deepseek-moe-16b's prefill shape (16,384 tokens
    in one group, top-6 of 64 experts, d 2,048, bf16 slots): two calls on
    the card bitwise equal, and bitwise the CPU's (the same float32 adds
    in the same order)."""
    from repro_torch.models import layers as L
    Tg, K, E, d = 16384, 6, 64, 2048
    C = L.moe_capacity(Tg, L.MoEConfig(n_experts=E, top_k=K, d_expert=1))
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((1, Tg, E), np.float32))
    w, idx = torch.topk(torch.softmax(logits, -1), K, dim=-1)
    st, sw, keep, buf_idx = L.moe_plan(idx, w / w.sum(-1, keepdim=True), C,
                                       E)
    sw = torch.where(keep, sw, torch.zeros(())).bfloat16()
    yb = torch.from_numpy(rng.standard_normal((1, E * C + 1, d),
                                              np.float32)).bfloat16()
    yb[:, -1] = 0
    want = L.moe_combine(yb, st, sw, buf_idx, Tg, K)
    args = [t.cuda() for t in (yb, st, sw, buf_idx)]
    a = L.moe_combine(*args, Tg, K)
    b = L.moe_combine(*args, Tg, K)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


def test_moe_layer_backward_repeats_on_the_card(lm_kernels):
    """One MoE layer at deepseek-moe-16b's width (d 2,048, 64 experts of
    1,408, top-6, 2 shared; bf16 weights) on 2 x 2,048 tokens, forward
    and backward twice on the same inputs: the output and every gradient
    bitwise equal, with pairs dropped.  Beside the combine's fixed order this
    holds the dispatch: the gradient of its gather ``xg[rows, st]`` adds
    each token's K rows through CUDA's ``index_put_`` with accumulate."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    arch = configs.get("deepseek_moe_16b")
    cfg, d = arch.moe, arch.d_model
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = L.moe_init(gen, d, cfg, dtype=torch.bfloat16, device="cuda")
    # an offset shared by every token skews the routing: pairs drop
    x = (torch.randn((2, 2048, d), generator=gen, device="cuda")
         + 0.5 * torch.randn((d,), generator=gen, device="cuda")).bfloat16()
    dy = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()
    w, idx = L.moe_route(x.reshape(1, -1, d), p["router"], cfg)
    keep = L.moe_plan(idx, w, L.moe_capacity(x.shape[0] * x.shape[1], cfg),
                      cfg.n_experts)[2]
    assert 0 < int(keep.sum()) < keep.numel()
    leaves = [p["router"], p["wg"], p["wu"], p["wd"],
              *(p["shared"][k] for k in sorted(p["shared"]))]
    runs = []
    for _ in range(2):
        xx = x.clone().requires_grad_()
        for t in leaves:
            t.requires_grad_()
            t.grad = None
        y = L.moe_forward(p, xx, cfg)
        y.backward(dy)
        runs.append([y.detach(), xx.grad] + [t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


FAMILIES = ["gemma2_2b", "phi4_mini_3_8b", "granite3_8b", "codeqwen15_7b",
            "deepseek_moe_16b", "mixtral_8x7b", "qwen2_vl_7b",
            "musicgen_large"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_smoke_prefill_on_card_matches_cpu(lm_kernels, arch):
    """Each other family's smoke() prefill on the card in float32 (through
    the f32 flash kernel: phi4-mini's head_dim 12 is not a bf16 width)
    against the same weights on the CPU: logits and KV caches within
    1e-4, one flash launch per attention layer."""
    from repro_torch import configs
    from repro_torch.models import model as M
    fk = lm_kernels[0]
    cfg = configs.get_smoke(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    shape = (2, 40, cfg.n_codebooks) if cfg.n_codebooks > 1 else (2, 40)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape))}
    if cfg.vlm_patches:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.vlm_patches, cfg.d_model), np.float32))

    def to_cuda(node):
        if isinstance(node, dict):
            return {k: to_cuda(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cuda(v) for v in node]
        return node.cuda()
    want, wstate = M.prefill(params, cfg, batch)
    fk.reset_launches()
    got, gstate = M.prefill(to_cuda(params), cfg, to_cuda(batch))
    torch.cuda.synchronize()
    n_attn = sum(m in ("attn", "local") for m, _ in cfg.layer_plan)
    assert fk.LAUNCHES["flash_attention"] == n_attn > 0
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    for g, w in zip(gstate["layers"], wstate["layers"]):
        for name in ("k", "v"):
            torch.testing.assert_close(g["kv"][name].cpu(), w["kv"][name],
                                       rtol=0, atol=1e-4)


def test_rwkv_smoke_model_on_card_through_the_kernel(lm_kernels,
                                                     monkeypatch):
    """rwkv6 smoke() in f32 on the card: prefill and greedy_generate
    through the wkv6 kernel equal their plain-pinned twin, with one launch
    per layer per pass; the Batcher answers every request, one launch per
    layer per decode step."""
    from repro_torch import configs
    from repro_torch.kernels import pin
    from repro_torch.models import model as M
    from repro_torch.serve import Batcher, ServeConfig, greedy_generate
    wk = lm_kernels[2]
    cfg = configs.get_smoke("rwkv6_7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40))).cuda()
    out = {}
    for pinned in ("", "plain"):
        monkeypatch.setenv(pin.PIN_ENV, pinned)
        wk.reset_launches()
        logits, _ = M.prefill(params, cfg, {"tokens": prompt},
                              last_only=True)
        toks = greedy_generate(params, cfg, prompt, 8)
        out[pinned] = (logits, toks, wk.LAUNCHES["wkv6"])
    L = cfg.n_layers
    assert out[""][2] == 2 * L + 8 * L
    assert out["plain"][2] == 0
    torch.testing.assert_close(out[""][0], out["plain"][0], rtol=0,
                               atol=1e-4)
    assert torch.equal(out[""][1], out["plain"][1])
    monkeypatch.delenv(pin.PIN_ENV)
    wk.reset_launches()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 5, 12)]
    batcher = Batcher(params, cfg, ServeConfig(batch=2, max_seq=32))
    inner, steps = batcher.step, [0]

    def counted(*args):
        steps[0] += 1
        return inner(*args)
    batcher.step = counted
    res = batcher.serve(prompts, 6)
    assert all(r is not None and len(r) == 6 for r in res)
    assert wk.LAUNCHES["wkv6"] == L * steps[0] > 0


# ----------------------------------------------------------------------
# backward kernels: flash attention and the RG-LRU scan
# ----------------------------------------------------------------------

FLASH_BWD_CARD_CASES = [
    # (B, Sq, Sk, H, KV, hd), dtype, opts: MQA with a window (the
    # training shape's kind), gemma2's GQA 8/4 at hd 256 with cap 50, MHA
    # at hd 128, ragged S with a window edge inside a tile, Sq != Sk, float32
    # at a narrow width, hd 64 non-causal with a cap
    ((1, 300, 300, 10, 1, 256), "bfloat16", dict(causal=True, window=100)),
    ((1, 200, 200, 8, 4, 256), "bfloat16", dict(causal=True, cap=50.0)),
    ((2, 160, 160, 4, 4, 128), "bfloat16", dict(causal=True)),
    ((2, 77, 77, 4, 2, 64), "bfloat16", dict(causal=True, window=19)),
    ((1, 70, 130, 4, 1, 64), "bfloat16", dict(causal=False, cap=20.0)),
    ((2, 65, 65, 4, 2, 16), "float32", dict(causal=True, window=20)),
    ((1, 50, 90, 6, 3, 40), "float32", dict(causal=False, cap=5.0)),
    # the Hopper backward's widths and edges: MQA at hd 256 with S off the
    # 64-row grid and a window edge inside a tile, GQA at hd 128 (two dQ
    # consumers), MHA at hd 64
    ((1, 1000, 1000, 10, 1, 256), "bfloat16", dict(causal=True, window=300)),
    ((2, 333, 333, 8, 2, 128), "bfloat16", dict(causal=True)),
    ((2, 250, 250, 6, 6, 64), "bfloat16", dict(causal=True, window=90)),
]


def _rel_max(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("shape,dtype,opts", FLASH_BWD_CARD_CASES)
def test_flash_backward_kernel_matches_plain(lm_kernels, shape, dtype,
                                             opts):
    """dq, dk, dv of the backward kernel against ``ref.attention_bwd`` on the
    same q, k, v, o, lse and do (the kernel forward's o and lse): max
    |diff| within 2e-2 (bf16) / 2e-5 (f32) of the plain version's max
    magnitude; the forward's lse against the plain one's."""
    from repro_torch.kernels.flash_attention import ref as fref
    fk = lm_kernels[0]
    B, Sq, Sk, H, KV, hd = shape
    rng = np.random.default_rng(sum(shape) + 7)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        "cuda", dt) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                              (B, Sk, KV, hd), (B, Sq, H, hd)))
    o, lse = fk.flash_attention(q, k, v, return_lse=True, **opts)
    _, lse_plain = fref.attention(q, k, v, return_lse=True, **opts)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-4, atol=1e-4)
    before = fk.LAUNCHES["flash_attention_bwd"]
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention_bwd"] == before + 1
    want = fref.attention_bwd(q, k, v, o, lse, do, **opts)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and bool(torch.isfinite(g.float()).all()), name
        assert _rel_max(g, w) <= tol, (name, _rel_max(g, w))


@pytest.mark.parametrize("shape,opts", [
    ((1, 1000, 1000, 10, 1, 256), dict(causal=True, window=300)),
    ((2, 333, 333, 8, 2, 128), dict(causal=True, cap=20.0)),
])
def test_flash_backward_kernel_is_deterministic(lm_kernels, shape, opts):
    """No atomics: two calls of the bf16 backward give the same bits, and
    so do two dK/dV passes (``parts=3``: D, dK/dV and the group sum) under
    GQA/MQA."""
    fk = lm_kernels[0]
    B, Sq, Sk, H, KV, hd = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        "cuda", torch.bfloat16) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                          (B, Sk, KV, hd), (B, Sq, H, hd)))
    o, lse = fk.flash_attention(q, k, v, return_lse=True, **opts)
    first = fk.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    second = fk.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    dkdv = [fk.flash_attention_bwd(q, k, v, o, lse, do, parts=3, **opts)[1:]
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, b in zip(*dkdv):
        assert torch.equal(a, b)
    for a, b in zip(dkdv[0], first[1:]):
        assert torch.equal(a, b)


def test_flash_backward_bf16_hd40_raises_as_the_forward(lm_kernels):
    """bfloat16 takes hd a multiple of 16 (the Hopper kernels' k-step),
    forward and backward alike; float32 takes hd 40."""
    fk = lm_kernels[0]
    q = torch.zeros((1, 64, 2, 40), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 1, 40), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        fk.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="multiple of 16"):
        fk.flash_attention_bwd(q, k, k, q, lse, q)
    f = [t.float() for t in (q, k)]
    o, lse = fk.flash_attention(f[0], f[1], f[1], return_lse=True)
    assert all(bool(torch.isfinite(g).all()) for g in
               fk.flash_attention_bwd(f[0], f[1], f[1], o, lse, f[0]))


def test_flash_autograd_on_the_card_matches_plain(lm_kernels, monkeypatch):
    """``ops.flash_attention`` under autograd: the Function's kernel pair
    against the same Function pinned to the plain versions."""
    from repro_torch.kernels import pin
    from repro_torch.kernels.flash_attention import ops as fops
    fk = lm_kernels[0]
    rng = np.random.default_rng(5)
    shapes = ((1, 130, 10, 256), (1, 130, 1, 256), (1, 130, 1, 256))
    base = [torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        "cuda", torch.bfloat16) for s in shapes]
    do = torch.from_numpy(rng.standard_normal(shapes[0], np.float32)).to(
        "cuda", torch.bfloat16)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setenv(pin.PIN_ENV, "plain")
        leaves = [t.clone().requires_grad_() for t in base]
        before = dict(fk.LAUNCHES)
        out = fops.flash_attention(*leaves, causal=True, window=50)
        out.backward(do)
        launched = {k: fk.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"flash_attention": 0, "flash_attention_bwd": 0}
                            if plain else {"flash_attention": 1,
                                           "flash_attention_bwd": 1})
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert _rel_max(g, w) <= 2e-2


@pytest.mark.parametrize("shape", [(1, 4096, 2560), (4, 1000, 300),
                                   (2, 1, 77), (1, 9, 31), (3, 65, 2561),
                                   (2, 1003, 2557), (1, 7, 5)])
def test_rglru_backward_kernel_bitwise_equal_to_plain(lm_kernels, shape):
    from repro_torch.kernels.rg_lru import ref as rref
    rk = lm_kernels[1]
    B, S, D = shape
    rng = np.random.default_rng(S + D + 1)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()
    a = t(rng.uniform(0.5, 0.999, shape))
    x = t(rng.standard_normal(shape))
    h0 = t(rng.standard_normal((B, D)))
    h, _ = rk.rglru_scan(x, a, h0)
    dh = t(rng.standard_normal(shape))
    for dhT in (t(rng.standard_normal((B, D))), None):
        before = rk.LAUNCHES["rglru_scan_bwd"]
        got = rk.rglru_scan_bwd(a, h, h0, dh, dhT)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["rglru_scan_bwd"] == before + 1
        want = rref.rglru_scan_bwd(a, h, h0, dh, dhT)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


WKV_BWD_CARD_CASES = [
    # (B, S, H, N), dtype, with dsT: each head size (clusters of 4, 2 and 1
    # CTAs), S=1, S off the 16-step chunk and on it, bf16 at the training
    # width, float32 at N=64
    ((2, 40, 3, 64), "bfloat16", True),
    ((1, 1, 2, 64), "bfloat16", False),
    ((2, 37, 2, 16), "float32", True),
    ((1, 100, 2, 32), "bfloat16", True),
    ((3, 9, 4, 32), "float32", False),
    ((2, 8, 5, 16), "bfloat16", True),
    ((1, 1000, 4, 64), "bfloat16", True),
    ((2, 48, 3, 64), "float32", False),
]


@pytest.mark.parametrize("shape,dtype,with_dsT", WKV_BWD_CARD_CASES)
def test_wkv6_bwd_kernel_matches_plain(lm_kernels, shape, dtype, with_dsT):
    """The backward kernel's six gradients against ``ref.wkv6_bwd``: two
    float32 evaluations of the same function (bf16 r, k, v, dy are exact
    in float32), so within twice ``ref.f32_bwd_error_bound``; one launch
    counted; a second call bitwise equal (no atomics)."""
    from repro_torch.kernels.rwkv6 import ref as wref
    wk = lm_kernels[2]
    args = _wkv_inputs(*shape, dtype, sum(shape) + 7)
    rng = np.random.default_rng(sum(shape))
    B, S, H, N = shape
    dy = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", args[0].dtype)
    dsT = (torch.from_numpy(rng.standard_normal((B, H, N, N)).astype(
        np.float32)).cuda() if with_dsT else None)
    before = wk.LAUNCHES["wkv6_bwd"]
    got = wk.wkv6_bwd(*args, dy, dsT)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["wkv6_bwd"] == before + 1
    want = wref.wkv6_bwd(*args, dy, dsT)
    bound = wref.f32_bwd_error_bound(*args, dy, dsT)
    for name, g, w_, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                              want, bound):
        assert g.dtype == torch.float32 and g.shape == w_.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert bool(((g.double() - w_.double()).abs() <= 2 * b).all()), name
    again = wk.wkv6_bwd(*args, dy, dsT)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wkv6_bwd_kernel_near_its_order_twin(lm_kernels):
    """The backward kernel and `ref.wkv6_bwd_tiled` (its summation order:
    column groups of 16 added in rank order, the 16-step chunks; without
    FMAs) in float32 at the model's scale: within twice the first-order
    bound, as any two float32 evaluations, at every head size."""
    from repro_torch.kernels.rwkv6 import ref as wref
    wk = lm_kernels[2]
    for shape in ((2, 64, 3, 16), (2, 45, 2, 32), (1, 80, 2, 64)):
        args = _wkv_inputs(*shape, "float32", sum(shape), model=True)
        B, S, H, N = shape
        rng = np.random.default_rng(sum(shape) + 1)
        dy = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        dsT = torch.from_numpy(rng.standard_normal((B, H, N, N)).astype(
            np.float32)).cuda()
        got = wk.wkv6_bwd(*args, dy, dsT)
        want = wref.wkv6_bwd_tiled(*args, dy, dsT)
        bound = wref.f32_bwd_error_bound(*args, dy, dsT)
        for name, g, w_, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                                  got, want, bound):
            assert bool(((g.double() - w_.double()).abs() <= 2 * b).all()), (
                shape, name)


def test_wkv6_bwd_kernel_refuses_what_it_does_not_take(lm_kernels):
    wk = lm_kernels[2]
    args = _wkv_inputs(1, 8, 2, 64, "bfloat16", 0)
    dy = torch.zeros_like(args[0])
    with pytest.raises(TypeError):            # dy in another dtype than r
        wk.wkv6_bwd(*args, dy.float())
    with pytest.raises(ValueError):           # dsT of another shape
        wk.wkv6_bwd(*args, dy, args[5][:, :1])
    with pytest.raises(ValueError):           # a head size it has no form for
        wk.wkv6_bwd(*_wkv_inputs(1, 8, 2, 48, "float32", 0),
                    torch.zeros(1, 8, 2, 48, device="cuda"))


def test_wkv6_under_autograd_on_the_card_runs_the_backward_kernel(
        lm_kernels, monkeypatch):
    """``ops.wkv6`` under autograd on a CUDA tensor goes through the `WKV6`
    Function: the forward kernel, then the backward kernel, whose
    gradients (in each operand's dtype) agree with the same Function
    pinned to the plain versions within twice ``ref.f32_bwd_error_bound``;
    under no_grad it is the forward alone."""
    from repro_torch.kernels import pin
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.kernels.rwkv6 import ref as wref
    wk = lm_kernels[2]
    base = _wkv_inputs(1, 24, 2, 16, "float32", 3)
    dy = torch.randn(1, 24, 2, 16, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(1))
    out = {}
    for plain in (False, True):
        if plain:
            monkeypatch.setenv(pin.PIN_ENV, "plain")
        else:
            monkeypatch.delenv(pin.PIN_ENV, raising=False)
        leaves = [t.clone().requires_grad_() for t in base]
        before = dict(wk.LAUNCHES)
        y, sT = wops.wkv6(*leaves)
        assert type(y.grad_fn).__name__ == "WKV6Backward"
        ((y * dy).sum() + sT.sum()).backward()
        torch.cuda.synchronize()
        out[plain] = ([t.grad for t in leaves],
                      {k: wk.LAUNCHES[k] - before[k] for k in before})
    monkeypatch.delenv(pin.PIN_ENV, raising=False)
    assert out[False][1] == {"wkv6": 1, "wkv6_bwd": 1}
    assert out[True][1] == {"wkv6": 0, "wkv6_bwd": 0}
    bound = wref.f32_bwd_error_bound(*base, dy, torch.ones_like(base[5]))
    for g, p, b in zip(out[False][0], out[True][0], bound):
        assert g.dtype == p.dtype == torch.float32
        assert bool(((g.double() - p.double()).abs() <= 2 * b).all())
    with torch.no_grad():
        before = dict(wk.LAUNCHES)
        wops.wkv6(*[t.clone().requires_grad_() for t in base])
        assert wk.LAUNCHES == {"wkv6": before["wkv6"] + 1,
                               "wkv6_bwd": before["wkv6_bwd"]}


# ----------------------------------------------------------------------
# training: one train step on the card against the same on the CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "gemma2_2b",
                                  "deepseek_moe_16b", "qwen2_vl_7b",
                                  "rwkv6_7b"])
def test_train_step_on_the_card_matches_cpu(lm_kernels, arch):
    """A smoke model's train step in float32 (two microbatches, then AdamW)
    from the same weights and batch: on the card through the forward and
    backward kernels, on the CPU through their plain versions.  Loss within
    1e-5 and grad_norm within 1e-4 (relative), every gradient leaf within
    1e-4 of its largest element.  The update: the first step's ``m``
    (0.1 g s, s the clip factor) within 2e-4 of each leaf's largest and
    ``v`` (0.05 g^2 s^2) within 4e-4, the margins the gradient limit and
    the grad_norm limit leave (|g1^2 - g2^2| <= |g1 - g2| 2 max|g|); the
    parameters and the float32 master after the step within 1e-3 lr
    wherever |g| is at least 1e-3 of its leaf's largest (there the step
    is lr sign(g) plus the weight decay on both sides), and everywhere
    within 2 lr (near g = 0 float32 sums in another order can flip the
    sign of g, and the step with it)."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import (AdamWConfig, apply_updates, init_state,
                                   tree_leaves, tree_map)
    from repro_torch.train import loss_and_grads
    fk, rk, wk = lm_kernels
    cfg = configs.get_smoke(arch)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    base = M.init_params(cfg, torch.Generator().manual_seed(3),
                         device="cpu", dtype=torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.clone().to(dev), base)
        opt = init_state(ocfg, params)
        batch = make_batch(cfg, DataConfig(seed=4), 0, 4, 40, device=dev)
        before = {**fk.LAUNCHES, **rk.LAUNCHES, **wk.LAUNCHES}
        loss, grads = loss_and_grads(params, cfg, batch, microbatches=2)
        params, opt, m = apply_updates(ocfg, params, grads, opt)
        torch.cuda.synchronize()
        after = {**fk.LAUNCHES, **rk.LAUNCHES, **wk.LAUNCHES}
        out[dev] = (dict(loss=float(loss), lr=float(m["lr"]),
                         grad_norm=float(m["grad_norm"])),
                    [g.cpu() for g in grads],
                    {k: [t.cpu() for t in tree_leaves(tree)]
                     for k, tree in (("params", params), ("m", opt["m"]),
                                     ("v", opt["v"]),
                                     ("master", opt["master"]))},
                    {k: after[k] - before[k] for k in after})
    (mc, gc, sc, _), (mg, gg, sg, launched) = out["cpu"], out["cuda"]
    n_attn = sum(mx in ("attn", "local") for mx, _ in cfg.layer_plan)
    n_rec = sum(mx == "rglru" for mx, _ in cfg.layer_plan)
    n_rwkv = sum(mx == "rwkv" for mx, _ in cfg.layer_plan)
    # remat: each layer's forward twice a microbatch, its backward once
    assert launched == {"flash_attention": 4 * n_attn,
                        "flash_attention_bwd": 2 * n_attn,
                        "rglru_scan": 4 * n_rec, "rglru_scan_bwd": 2 * n_rec,
                        "wkv6": 4 * n_rwkv, "wkv6_bwd": 2 * n_rwkv}
    assert abs(mg["loss"] - mc["loss"]) <= 1e-5 * abs(mc["loss"])
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * mc["grad_norm"]
    assert mg["lr"] == mc["lr"]
    for g, c in zip(gg, gc):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())
    for key, tol in (("m", 2e-4), ("v", 4e-4)):
        for i, (g, c) in enumerate(zip(sg[key], sc[key])):
            assert float((g - c).abs().max()) <= tol * float(c.abs().max()), \
                (key, i)
    for key in ("params", "master"):
        for i, (g, c, gr) in enumerate(zip(sg[key], sc[key], gc)):
            diff = (g - c).abs()
            assert float(diff.max()) <= 2 * ocfg.lr, (key, i)
            clear = gr.abs() >= 1e-3 * float(gr.abs().max())
            assert float(diff[clear].max()) <= 1e-3 * ocfg.lr, (key, i)


def test_remat_off_on_the_card(lm_kernels):
    """``remat=False`` on the card: each layer's forward kernel runs once a
    microbatch (twice under remat), and the loss and gradients equal
    ``remat=True``'s bit for bit (the recomputation repeats the same
    launches on the same inputs)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import tree_map
    from repro_torch.train import loss_and_grads
    fk, rk, _ = lm_kernels
    cfg = configs.get_smoke("recurrentgemma_2b")
    base = M.init_params(cfg, torch.Generator().manual_seed(3),
                         device="cpu", dtype=torch.float32)
    batch = make_batch(cfg, DataConfig(seed=4), 0, 4, 40, device="cuda")
    n_attn = sum(mx in ("attn", "local") for mx, _ in cfg.layer_plan)
    n_rec = sum(mx == "rglru" for mx, _ in cfg.layer_plan)
    out = {}
    for remat in (True, False):
        params = tree_map(lambda t: t.clone().cuda(), base)
        before = {**fk.LAUNCHES, **rk.LAUNCHES}
        out[remat] = loss_and_grads(
            params, dataclasses.replace(cfg, remat=remat), batch,
            microbatches=2)
        torch.cuda.synchronize()
        after = {**fk.LAUNCHES, **rk.LAUNCHES}
        fwd = 2 if remat else 1
        assert {k: after[k] - before[k] for k in after} == {
            "flash_attention": 2 * fwd * n_attn,
            "flash_attention_bwd": 2 * n_attn,
            "rglru_scan": 2 * fwd * n_rec, "rglru_scan_bwd": 2 * n_rec}
    assert torch.equal(out[True][0], out[False][0])
    for on, off in zip(out[True][1], out[False][1]):
        assert torch.equal(on, off)


# ----------------------------------------------------------------------
# sharding and launch: a world-size-1 NCCL mesh on the card, the meta route
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A (1, 1) ("data", "model") DeviceMesh over an NCCL process group of
    world size 1 on a FileStore (no network), destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_nccl_debug_mesh_of_world_size_1(nccl_mesh):
    from repro_torch.launch.mesh import axis_size, data_axes
    assert nccl_mesh.device_type == "cuda"
    assert tuple(nccl_mesh.mesh_dim_names) == ("data", "model")
    assert tuple(nccl_mesh.shape) == (1, 1)
    assert data_axes(nccl_mesh) == ("data",)
    assert axis_size(nccl_mesh, ("data", "model")) == 1


def test_distribute_tree_on_the_card(nccl_mesh):
    """Every leaf of a smoke model's parameters becomes a DTensor on the
    mesh, replicated (each mesh dim has size 1), its local part the leaf."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import configs
    from repro_torch.launch.sharding import distribute_tree, tree_items
    from repro_torch.models import model as M
    cfg = configs.get_smoke("recurrentgemma_2b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    dist_tree = distribute_tree(params, nccl_mesh, cfg)
    flat = dict(tree_items(dist_tree))
    for path, leaf in tree_items(params):
        got = flat[path]
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == (Replicate(), Replicate())
        assert torch.equal(got.to_local(), leaf)


def test_compressed_psum_tree_bitwise_on_nccl(nccl_mesh):
    """At world size 1 the int8 sum is one replica's grid scaled back: each
    leaf equals ``dequantize(quantize_int8(g))`` in g's dtype, bitwise."""
    from repro_torch.optim import (compressed_psum_tree, dequantize,
                                   quantize_int8)
    rng = np.random.default_rng(5)
    grads = {"a": torch.from_numpy(rng.standard_normal((64, 33)).astype(
                 np.float32)).cuda(),
             "b": [torch.from_numpy(rng.standard_normal(1000).astype(
                 np.float32) * 1e-3).cuda().to(torch.bfloat16)]}
    got = compressed_psum_tree(grads, "data", nccl_mesh)
    for g, r in ((grads["a"], got["a"]), (grads["b"][0], got["b"][0])):
        want = dequantize(*quantize_int8(g)).to(g.dtype)
        assert r.dtype == g.dtype and torch.equal(r, want)


def test_logical_leaves_a_dtensor_as_it_is(nccl_mesh):
    """``logical`` under a mesh's rules redistributes a DTensor to its
    spec's placements; on a (1, 1) mesh those are the replicated ones it
    has, so it comes back as it went in."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.sharding import activation_rules
    from repro_torch.models.sharding import activation_sharding, logical
    x = torch.randn(4, 16, 32, device="cuda")
    dt = distribute_tensor(x, nccl_mesh, [Replicate(), Replicate()])
    rules = activation_rules(nccl_mesh, 4, n_kv=1)
    with activation_sharding(nccl_mesh, rules):
        got = logical(dt, "batch", "seq", "embed")
    assert tuple(got.placements) == tuple(dt.placements)
    assert torch.equal(got.to_local(), x)


@pytest.mark.parametrize("arch", ["gemma2_2b", "recurrentgemma_2b",
                                  "rwkv6_7b", "deepseek_moe_16b",
                                  "mixtral_8x7b"])
def test_sharded_smoke_family_on_the_nccl_mesh_is_bitwise(lm_kernels,
                                                          nccl_mesh, arch):
    """On the (1, 1) NCCL mesh every placement is ``Replicate()``: a smoke
    model's gradient pass (two microbatches) and prefill in float32 with
    the parameters and batch distributed on it, inside
    ``activation_sharding``, equal the same calls on plain tensors bit for
    bit, and launch each kernel of the family inside its region as often
    as the plain calls do."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.sharding import (activation_rules,
                                             distribute_batch,
                                             distribute_tree)
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.train import loss_and_grads
    cfg = configs.get_smoke(arch)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                           device="cuda", dtype=torch.float32)
    batch = make_batch(cfg, DataConfig(seed=4), 0, 4, 40, device="cuda")
    rules = activation_rules(nccl_mesh, 4, n_kv=cfg.n_kv_heads)
    out = {}
    for sharded in (True, False):
        p = distribute_tree(params, nccl_mesh, cfg) if sharded else params
        b = distribute_batch(batch, nccl_mesh) if sharded else batch
        for fam in lm_kernels:
            fam.reset_launches()
        with activation_sharding(nccl_mesh, rules):
            loss, grads = loss_and_grads(p, cfg, b, microbatches=2)
            logits, state = M.prefill(p, cfg, {"tokens": b["tokens"]})
        torch.cuda.synchronize()
        launched = {k: v for fam in lm_kernels
                    for k, v in fam.launch_counts().items()}

        def whole(t):
            return t.to_local() if isinstance(t, DTensor) else t
        out[sharded] = (whole(loss), [whole(g) for g in grads],
                        whole(logits), launched)
    (ld, gd, pd, nd), (lp, gp, pp, np_) = out[True], out[False]
    assert nd == np_ and any(nd.values())
    assert torch.equal(ld, lp) and torch.equal(pd, pp)
    for x, y in zip(gd, gp):
        assert torch.equal(x, y)


def test_meta_tensors_take_the_shape_only_route(lm_kernels):
    """A meta tensor through the three LM ops returns outputs of the right
    shapes and dtypes and launches nothing; a CUDA tensor still launches
    the kernel."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rg_lru import ops as rops
    from repro_torch.kernels.rwkv6 import ops as wops
    fk, rk, wk = lm_kernels
    before = {**fk.LAUNCHES, **rk.LAUNCHES, **wk.LAUNCHES}
    meta = dict(device="meta")
    q = torch.empty(2, 64, 4, 64, dtype=torch.bfloat16, **meta)
    kv = torch.empty(2, 64, 2, 64, dtype=torch.bfloat16, **meta)
    o = fops.flash_attention(q, kv, kv, causal=True)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    x = torch.empty(2, 64, 96, **meta)
    h, hT = rops.rglru_scan(x, x, torch.empty(2, 96, **meta))
    assert h.shape == x.shape and hT.shape == (2, 96) and h.is_meta
    r = torch.empty(2, 64, 4, 16, dtype=torch.bfloat16, **meta)
    y, s = wops.wkv6(r, r, r, torch.empty(2, 64, 4, 16, **meta),
                     torch.empty(4, 16, **meta),
                     torch.empty(2, 4, 16, 16, **meta))
    assert y.shape == r.shape and y.dtype == r.dtype
    assert s.shape == (2, 4, 16, 16) and s.dtype == torch.float32
    assert {**fk.LAUNCHES, **rk.LAUNCHES, **wk.LAUNCHES} == before
    xc = torch.randn(2, 64, 96, device="cuda")
    rops.rglru_scan(xc, torch.rand_like(xc), torch.zeros(2, 96,
                                                         device="cuda"))
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rglru_scan"] == before["rglru_scan"] + 1


def test_hbm_per_device_is_the_cards():
    """The dry run's device memory is what this card reports, on the card
    it was read from."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.roofline import HBM_PER_DEVICE
    props = torch.cuda.get_device_properties(0)
    print("total_memory", props.total_memory, props.name)
    if props.name != "NVIDIA H100 80GB HBM3":
        pytest.skip(f"HBM_PER_DEVICE is the H100 80GB HBM3's; this is "
                    f"{props.name}")
    assert props.total_memory == HBM_PER_DEVICE
