"""Plain PyTorch versions of the three placement-scan kernels.

Each function computes exactly what its CUDA kernel computes, with plain
tensor ops on whatever device its inputs lie on.  The wrappers in
``ops.py`` use them for CPU tensors; ``chip_smoke.py`` holds the kernels
against them on the card.

  * ``scan_bitmaps`` — feasible-start bitmaps: bit (g, w, machine) says
    whether task g's demand fits the machine for ks[g] consecutive ticks
    from window offset w, counting only ticks < t_live.
  * ``heartbeat_eligible`` — sound-superset heartbeat eligibility over
    directed-rounded float32 operands; ``heartbeat_eligible64`` is the
    staged call's contract, the rounding from float64 included.
  * ``match_wave_walk`` — one heartbeat wave: machines in host order, a
    bundling loop of picks per machine, all in float64.
  * ``demand_min`` / ``visit_may_pick`` — numpy twins of the wave kernel's
    visit skip: a machine on which no untaken candidate can be eligible is
    passed over without a pass over the candidates.
  * ``tick_words`` / ``scan_words`` — numpy twins of the scan kernel's
    word-and-run test: the feasible ticks of each (task, machine) row
    packed 32 to a word, and each start decided from the words its run
    covers.

The first two are integer/boolean pipelines over float32 comparisons; the
wave repeats the numpy matcher's float64 ops one by one (PyTorch's CPU and
CUDA elementwise kernels round each product before the add that consumes
it), so all three are bit-identical to the reference implementations.
"""

from __future__ import annotations

import numpy as np
import torch


def scan_bitmaps(win: torch.Tensor, Vs: torch.Tensor, ks: torch.Tensor,
                 t_live: int, W: int) -> torch.Tensor:
    """win (m, L, d) f32; Vs (g, d) f32; ks (g,) i32 -> (g, W, m) int8.

    Requires L >= W + max(ks) so every run read stays in bounds; ticks at
    index >= t_live never count toward a run (grid-edge truncation).
    """
    m, L, _d = win.shape
    g = Vs.shape[0]
    dev = win.device
    ok = (win[None, :, :, :] >= Vs[:, None, None, :]).all(dim=3)   # (g, m, L)
    ok = ok & (torch.arange(L, device=dev) < int(t_live))[None, None, :]
    cz = torch.zeros((g, m, L + 1), dtype=torch.int32, device=dev)
    cz[:, :, 1:] = torch.cumsum(ok.to(torch.int32), dim=2, dtype=torch.int32)
    ends = torch.arange(W, device=dev)[None, :] + ks.to(torch.int64)[:, None]
    take = ends[:, None, :].expand(g, m, W)
    run = torch.gather(cz, 2, take) - cz[:, :, :W]
    good = run == ks[:, None, None]                                 # (g, m, W)
    return good.transpose(1, 2).contiguous().to(torch.int8)         # (g, W, m)


def heartbeat_eligible(dem32: torch.Tensor, thr_fit: torch.Tensor,
                       thr_fung: torch.Tensor, fd_mask: torch.Tensor,
                       rd_mask: torch.Tensor,
                       gd_mask: torch.Tensor) -> torch.Tensor:
    """dem32 (n, d); thr_* (m, d); *_mask (d,) f32 {0,1} -> (n, m) int8.

    eligible = fits-on-all-fit-dims OR (rigid dims fit AND fungible dims
    fit within slack); masked-out dims compare against +inf.
    """
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dem32.device)
    tf = torch.where(fd_mask > 0, thr_fit, inf)[None, :, :]
    tr = torch.where(rd_mask > 0, thr_fit, inf)[None, :, :]
    tg = torch.where(gd_mask > 0, thr_fung, inf)[None, :, :]
    dm = dem32[:, None, :]
    fits = (dm <= tf).all(dim=2)
    rigid = (dm <= tr).all(dim=2)
    fung = (dm <= tg).all(dim=2)
    return (fits | (rigid & fung)).to(torch.int8)


def round_down32(x: torch.Tensor) -> torch.Tensor:
    """Largest float32 <= x (float64 in): the nearest float32, stepped
    down when it rounded up (``__double2float_rd`` on the card)."""
    x32 = x.to(torch.float32)
    down = torch.nextafter(x32, torch.full_like(x32, -float("inf")))
    return torch.where(x32.to(torch.float64) > x, down, x32)


def round_up32(x: torch.Tensor) -> torch.Tensor:
    """Smallest float32 >= x (``__double2float_ru`` on the card)."""
    x32 = x.to(torch.float32)
    up = torch.nextafter(x32, torch.full_like(x32, float("inf")))
    return torch.where(x32.to(torch.float64) < x, up, x32)


def heartbeat_eligible64(avail: torch.Tensor, dem: torch.Tensor,
                         slack: float, eps: float, fd_mask: torch.Tensor,
                         rd_mask: torch.Tensor, gd_mask: torch.Tensor):
    """The staged eligibility call's contract (``kernel.eligible_call``):
    avail (m, d) and dem (n, d) float64, ``slack`` already clamped at 0,
    masks (d,) f32 {0,1} -> (eligible (n, m) int8, machine_any (m,) int8).

    The operands are rounded as the host's ``_superset_operands`` rounds
    them (demands down, thresholds ``avail + eps`` and
    ``(avail + slack) + eps`` formed in float64, then up), and compared as
    `heartbeat_eligible` compares them."""
    dem32 = round_down32(dem)
    thr_fit = round_up32(avail + eps)
    thr_fung = round_up32(avail + slack + eps)
    out = heartbeat_eligible(dem32, thr_fit, thr_fung, fd_mask, rd_mask,
                             gd_mask)
    return out, out.any(dim=0).to(torch.int8)


def eligibility_edge_corpus(seed: int, eps: float, m: int = 96, n: int = 40,
                            d: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """float64 avail (m, d) and demands (n, d) at the edges of the
    eligibility call's rounding: float32 values and their neighbours one
    ulp either side, doubles just off the float32 grid, thresholds that
    land on it once ``eps`` is added, float32 subnormals and doubles below
    them, values beyond FLT_MAX, +-inf and NaN.  Every demand also sits
    exactly at some machine's fit threshold, so the compares meet their
    boundaries."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    grid = rng.uniform(0.0, 1.0, 24).astype(f32)
    near = np.concatenate([grid, np.nextafter(grid, f32(np.inf)),
                           np.nextafter(grid, f32(-np.inf))]).astype(
                               np.float64)
    big = float(np.finfo(f32).max)
    special = np.array([0.0, -0.0, 2.0 ** -149, 2.0 ** -150, 3 * 2.0 ** -151,
                        1e-40, -1e-40, 2.0 ** -126, 1e-50, -1e-50, big,
                        big * (1 + 2.0 ** -30), 3.5e38, -3.5e38, 1e300,
                        -1e300, np.inf, -np.inf, np.nan])
    pool = np.concatenate([near, near * (1 + 2.0 ** -40),
                           near * (1 - 2.0 ** -40), near - eps, special])
    avail = rng.choice(pool, (m, d))
    dem = rng.choice(pool, (n, d))
    rows = rng.integers(0, m, n)
    with np.errstate(invalid="ignore", over="ignore"):
        dem[: n // 2] = avail[rows[: n // 2]] + eps
    return avail, dem


#: consts vector layout (core/engine/wave.py _C_*): eps, overbook slack,
#: remote penalty, eta_m, must-serve threshold, EMA step a, 1 - a, srpt floor
_C_EPS, _C_SLACK, _C_RP, _C_ETA_M, _C_THRESH, _C_A, _C_1MA, _C_FLOOR = \
    range(8)


def match_wave_walk(avail, order, dem, pri, srpt, gidx, loc, taken0, ema,
                    deficit, share, fd_mask, rd_mask, fg_mask, consts, *,
                    bundle_limit: int, use_packing: bool, use_srpt: bool,
                    use_overbooking: bool, drf: bool):
    """One fused heartbeat wave, op for op the numpy matcher's wave.

    Shapes: avail (m, d) f64; order (m,) i32 visit order, each machine at
    most once, -1-padded (a visit is decision-free for a machine the host
    would have skipped);
    dem (n, d) f64 with pad rows pre-taken (taken0); pri/srpt (n,) f64;
    gidx/loc (n,) i32; ema (2,) f64; deficit/share (G,) f64, deficit pads
    -inf; masks (d,) bool; consts (8,) f64.

    Returns (avail', ema', deficit', rows, machines, over, obs, count):
    the pick list in pick order, each pick's observed score ``pri*base``
    and the pick count as a 0-d int32 tensor.  Inputs are not modified.
    """
    dev = avail.device
    f64 = torch.float64
    n, d = dem.shape
    avail = avail.clone()
    taken = taken0.clone()
    ema_s, ema_r = ema[0].clone(), ema[1].clone()
    deficit = deficit.clone()
    rows = torch.zeros(n, dtype=torch.int32, device=dev)
    mach = torch.zeros(n, dtype=torch.int32, device=dev)
    overf = torch.zeros(n, dtype=torch.int8, device=dev)
    obs = torch.zeros(n, dtype=f64, device=dev)
    c = consts
    neg_inf = torch.tensor(float("-inf"), dtype=f64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)
    fd, rd, fg = fd_mask[None, :], rd_mask[None, :], fg_mask[None, :]
    cnt = 0
    active = int((~taken).sum())
    for mid in order.tolist():
        if mid < 0 or active == 0:
            break
        row = avail[mid].clone()
        local = row.clone()
        rp = torch.where((loc >= 0) & (loc != mid), c[_C_RP],
                         torch.ones((), dtype=f64, device=dev))
        for _j in range(bundle_limit):
            thr = local + c[_C_EPS]
            fits = torch.where(fd, dem <= thr[None, :], True).all(dim=1)
            if use_overbooking:
                thr_g = (local + c[_C_SLACK]) + c[_C_EPS]
                over = (~fits
                        & torch.where(rd, dem <= thr[None, :], True).all(dim=1)
                        & torch.where(fg, dem <= thr_g[None, :],
                                      True).all(dim=1))
            else:
                over = torch.zeros(n, dtype=torch.bool, device=dev)
            eligible = (fits | over) & ~taken
            gstar = int(torch.argmax(deficit))
            forced = eligible & (gidx == gstar)
            if bool(deficit[gstar] >= c[_C_THRESH]) and bool(forced.any()):
                eligible = forced
            if not bool(eligible.any()):
                break
            if use_packing:
                av = torch.clamp(local, min=0.0)
                acc = dem[:, 0] * av[0]
                for k in range(1, d):
                    acc = acc + dem[:, k] * av[k]
                dot = acc * rp
            else:
                dot = rp.expand(n)
            overshoot = torch.clamp(
                torch.where(fg, dem - local[None, :], neg_inf).amax(dim=1),
                min=0.0)
            base = torch.where(fits, dot,
                               dot * torch.clamp(1.0 - overshoot, min=0.05))
            if use_srpt:
                eta = c[_C_ETA_M] * ema_s / torch.maximum(ema_r, c[_C_FLOOR])
            else:
                eta = zero
            perf = pri * base - eta * srpt
            pool_fit = eligible & fits
            pool = pool_fit if bool(pool_fit.any()) else eligible
            score = torch.where(pool, perf, neg_inf)
            i = int(torch.argmax(score))
            if not bool(torch.isfinite(score[i])):
                break
            obs_i = pri[i] * base[i]
            w = dem[i].max() if drf else torch.ones((), dtype=f64, device=dev)
            taken[i] = True
            ema_s = c[_C_1MA] * ema_s + c[_C_A] * obs_i
            ema_r = c[_C_1MA] * ema_r + c[_C_A] * torch.maximum(srpt[i],
                                                                c[_C_FLOOR])
            deficit = deficit + share * w
            deficit[gidx[i]] += -w
            local = torch.clamp(local - dem[i], min=0.0)
            row = row - dem[i]
            rows[cnt] = i
            mach[cnt] = mid
            overf[cnt] = over[i].to(torch.int8)
            obs[cnt] = obs_i
            cnt += 1
            active -= 1
        avail[mid] = row
    return (avail, torch.stack([ema_s, ema_r]), deficit, rows, mach, overf,
            obs, torch.tensor(cnt, dtype=torch.int32, device=dev))


def demand_min(dem: np.ndarray, taken: np.ndarray) -> np.ndarray:
    """(d,) componentwise minimum of the untaken rows of ``dem``, NaN
    ignored, +inf where nothing is left: the bound the wave kernel keeps to
    skip visits.  A NaN demand fails every comparison it enters, so leaving
    it out of the minimum keeps the skip sound."""
    return np.fmin.reduce(np.asarray(dem, dtype=np.float64)[~np.asarray(
        taken, dtype=bool)], axis=0, initial=np.inf)


def visit_may_pick(row: np.ndarray, dmin: np.ndarray, consts: np.ndarray,
                   fd_mask: np.ndarray, rd_mask: np.ndarray,
                   fg_mask: np.ndarray, use_overbooking: bool) -> bool:
    """The wave kernel's visit test (csrc/placement_scan.cu ``may_pick``).

    False only when no candidate whose demands are all >= ``dmin`` (or
    NaN) can be eligible on a machine with availability ``row``: some fit
    dim has ``dmin > row + eps``, and overbooking is off or also
    impossible (a rigid dim above ``row + eps`` or a fungible dim above
    ``row + slack + eps``).  Sums are rounded as the kernel and the
    matcher round them (float64, left to right).
    """
    row = np.asarray(row, dtype=np.float64)
    thr = row + consts[_C_EPS]
    thr_g = (row + consts[_C_SLACK]) + consts[_C_EPS]
    nofit = bool(np.any(np.asarray(fd_mask, bool) & (dmin > thr)))
    norig = bool(np.any(np.asarray(rd_mask, bool) & (dmin > thr)))
    nofung = bool(np.any(np.asarray(fg_mask, bool) & (dmin > thr_g)))
    return not (nofit and (not use_overbooking or norig or nofung))


def tick_words(win: np.ndarray, Vs: np.ndarray, t_live: int) -> np.ndarray:
    """(g, m, ceil(L / 32)) uint32: bit b of word c is set iff tick
    32 c + b is below ``min(t_live, L)`` and fits demand ``Vs[g]`` on every
    dim, as the scan kernel's ``__ballot_sync`` packs it (lane b, tick
    32 c + b)."""
    win = np.asarray(win, dtype=np.float32)
    Vs = np.asarray(Vs, dtype=np.float32)
    m, L, _d = win.shape
    live = min(int(t_live), L)
    nw = (L + 31) // 32
    ok = np.zeros((len(Vs), m, nw * 32), dtype=bool)
    ok[:, :, :live] = (win[None, :, :live, :]
                       >= Vs[:, None, None, :]).all(axis=3)
    bits = ok.reshape(len(Vs), m, nw, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(
        axis=3).astype(np.uint32)


def scan_words(win: np.ndarray, Vs: np.ndarray, ks: np.ndarray, t_live: int,
               W: int, reverse: bool = False) -> np.ndarray:
    """The scan kernel's run test over `tick_words` -> (g, W, m) int8.

    Start w of task g is good iff its run [w, w + ks[g]) ends at or before
    ``min(t_live, L)`` and every bit of it is set, tested a word at a time
    with the kernel's masks (a word's bits from the run's first tick in it,
    up to 32 or the run's end).  Starts run descending when ``reverse``.
    Unlike `scan_bitmaps`, L may be shorter than W + max(ks): a run past L
    is simply not good.
    """
    words = tick_words(win, Vs, t_live)
    g, m, _nw = words.shape
    live = min(int(t_live), np.asarray(win).shape[1])
    out = np.zeros((g, W, m), dtype=np.int8)
    for gi in range(g):
        k = int(ks[gi])
        for w in range(W):
            end = w + k
            good = np.full(m, end <= live)
            t = w
            while t < end and good.any():
                b = t & 31
                n = min(32 - b, end - t)
                mask = np.uint32(((1 << n) - 1) << b)
                good &= (words[gi, :, t >> 5] & mask) == mask
                t += n
            out[gi, W - 1 - w if reverse else w] = good
    return out
