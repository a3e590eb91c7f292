"""Kernel-dispatch layer: one registry for the engine's array kernels.

Every tensor-shaped inner loop of the scheduler — the windowed feasibility
scan the placement backends run, and the fit/score/heartbeat kernels the
online layers run — is registered here as an *op* with up to three
implementations:

  cuda    — the hand-written kernels of ``kernels/placement_scan`` on the
            card (``scan``, ``machines_with_candidates``, ``match_wave``).
  torch   — the same ops' plain PyTorch versions on CPU tensors.
  numpy   — the reference implementation; always available, always exact.

Device rule.  The entry points (``build_schedule``, ``ClusterSim``,
``run_workload``, ``schedule_cluster``) run under ``use_device(device)``:
on ``"cuda"`` the three kernel ops resolve to ``cuda`` at every machine
count, on ``"cpu"`` to ``torch``.  Asking for cuda without a card raises;
nothing falls back to the CPU quietly.  ``REPRO_KERNELS`` (``"scan=numpy"``
or ``"all=numpy"``) pins an implementation and always wins, which is how
the numpy oracle is run for comparison.

Degraded mode.  Only an injected ``kernel_impl`` fault (`core/faults.py`)
sticky-demotes an implementation down the chain cuda -> torch -> numpy;
any other exception from an implementation propagates.

Exactness contract per op:

  * ``scan`` — all implementations are bit-identical: the grid is float32
    and demands are pre-rounded with ``ceil32``, so feasibility is a pure
    float32 comparison plus integer run-length counting on every path.
  * ``fits_mask`` / ``pack_score`` / ``heartbeat_masks`` — explicit-only:
    numpy (the float64 decision oracles) unless ``REPRO_KERNELS`` names
    another impl for the op (``all=`` skips them).  Their cuda and torch
    impls are approximations safe only for particular consumers:
    ``fits_mask`` is a superset (host-side directed rounding, compared in
    float32 on the device); ``pack_score`` a float32 product, close to but
    not identical with the float64 scores; ``heartbeat_masks`` a superset
    only in the union ``fits | over`` (the cuda impl's union is the
    eligibility kernel's, ``kernel.eligible_launch``; ``over`` is that
    union without ``fits``, so on its own it is neither a sub- nor a
    superset of the exact ``over``).  No path of the repository calls
    them.
  * ``machines_with_candidates`` — decision-exact under every
    implementation: its masks are used exclusively to *skip* machines
    that provably cannot pick a task, so any sound superset of the exact
    eligibility yields bit-identical scheduling decisions.  The cuda and
    torch implementations compute supersets by directed rounding: demands
    rounded *down* to float32, thresholds ``avail + slack + eps`` rounded
    *up*, so no exact-eligible pair is ever dropped (the cuda impl
    rounds on the card, ``__double2float_rd``/``_ru``; the torch impl on
    the host).
  * ``match_wave`` — a whole heartbeat wave as one op over a
    `wave.WaveContext`; bit-identical under every implementation (float64
    with no fused multiply-adds, see ``engine/wave.py``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Callable

import numpy as np

from .. import faults
from ..space import runs_of_k
from . import packing
from .base import ceil32

#: env var: comma-separated op=impl pairs, e.g. "scan=numpy,all=numpy"
KERNELS_ENV = "REPRO_KERNELS"

OPS = ("scan", "fits_mask", "pack_score", "heartbeat_masks",
       "machines_with_candidates", "match_wave")
#: ops whose cuda/torch impls are approximate in ways that are safe only
#: for particular consumers (see the exactness contract above): they
#: resolve to numpy unless REPRO_KERNELS names them (``all=<impl>`` skips
#: them), e.g. ``REPRO_KERNELS=heartbeat_masks=cuda``
EXPLICIT_ONLY = ("fits_mask", "pack_score", "heartbeat_masks")
IMPLS = ("cuda", "torch", "numpy")   # demotion order, strongest first
DEVICES = ("cuda", "cpu")

#: per-(op, impl) dispatch accounting: {"op.impl": [calls, seconds]}
PROFILE: dict[str, list] = {}

#: one lock for every shared accounting structure in this module
_STATS_LOCK = threading.Lock()


def reset_profile() -> None:
    with _STATS_LOCK:
        PROFILE.clear()


def profile_snapshot() -> dict[str, tuple[int, float]]:
    with _STATS_LOCK:
        return {k: (int(v[0]), float(v[1])) for k, v in PROFILE.items()}


def transfer_add(key: str, n: int) -> None:
    """Accumulate a host<->device transfer/launch counter in PROFILE.

    Keys follow ``"{op}.{impl}.{launches|bytes_h2d|bytes_d2h|waves}"``,
    plus ``"scan.{impl}.shape.m{m}.W{W}.L{L}.g{g}"`` tallying the shapes
    the scan launches at (unpadded on the card, on the bucket ladder on the
    CPU); the count lands in the calls slot of the usual PROFILE pair
    (seconds stays 0.0), so ``profile_snapshot`` deltas work unchanged.
    """
    with _STATS_LOCK:
        slot = PROFILE.get(key)
        if slot is None:
            slot = PROFILE[key] = [0, 0.0]
        slot[0] += n


# ----------------------------------------------------------------------
# device selection
# ----------------------------------------------------------------------

#: the device the kernel ops run on where no `use_device` block is open
_DEVICE = "cuda"
#: the device of the innermost `use_device` block open on this thread.
#: Thread-local, so that build-service worker threads running builds for
#: different devices, or finishing after their caller left its block, never
#: see each other's choice; a thread that works for a caller (the shard
#: executor's) enters the caller's `current_device()` itself.
_LOCAL = threading.local()


def check_device(device) -> str:
    """Normalize ``device`` to "cuda" or "cpu"; raise for cuda without a card."""
    import torch

    kind = torch.device(device).type
    if kind not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    return kind


def current_device() -> str:
    """The device the kernel ops run on for this thread right now."""
    return getattr(_LOCAL, "device", None) or _DEVICE


@contextlib.contextmanager
def use_device(device):
    """Run the kernel ops on ``device`` on this thread for the duration of
    the block."""
    kind = check_device(device)
    prev = getattr(_LOCAL, "device", None)
    _LOCAL.device = kind
    try:
        yield kind
    finally:
        _LOCAL.device = prev


#: sticky runtime demotions: op -> impls excluded from resolution until
#: `reset_demotions` (an injected ``kernel_impl`` fault put them there)
_DEMOTED: dict[str, set] = {}


def demote(op: str, impl: str) -> None:
    """Sticky-demote one (op, impl), counted in PROFILE under
    ``"{op}.{impl}.demoted"``."""
    if impl == "numpy":
        raise ValueError("the numpy oracle cannot be demoted")
    with _STATS_LOCK:
        _DEMOTED.setdefault(op, set()).add(impl)
        key = f"{op}.{impl}.demoted"
        slot = PROFILE.get(key)
        if slot is None:
            slot = PROFILE[key] = [0, 0.0]
        slot[0] += 1


def demotions_snapshot() -> dict[str, int]:
    """{"op.impl": demotion events} — the delta-able fault_stats view."""
    with _STATS_LOCK:
        return {k: int(v[0]) for k, v in PROFILE.items()
                if k.endswith(".demoted")}


def reset_demotions() -> None:
    """Re-admit every demoted impl (tests / operator re-enable)."""
    with _STATS_LOCK:
        _DEMOTED.clear()


# ----------------------------------------------------------------------
# numpy implementations (the reference semantics)
# ----------------------------------------------------------------------

def scan_starts(
    avail: np.ndarray,
    Vs: np.ndarray,
    ks: np.ndarray,
    plo: int,
    phi: int,
    reverse: bool = False,
) -> np.ndarray:
    """Feasible-start bitmaps for a batch of tasks over one window.

    For each task g (demand ``Vs[g]``, duration ``ks[g]`` ticks) and each
    physical start t in [plo, phi), bit (g, t, machine) says whether the
    whole run [t, t + ks[g]) fits on that machine inside the grid.

    Returns bool (g, (phi - plo) * m): rows are flattened over
    (start, machine) with starts ascending, or descending when
    ``reverse`` (the backward-pass walk order).
    """
    m, T, _d = avail.shape
    g = len(ks)
    W = phi - plo
    kmax = int(ks.max())
    hi_read = min(T, phi + kmax - 1)
    win = avail[:, plo:hi_read, :]                              # (m, L, d)
    L = hi_read - plo
    if g == 1:  # window extensions: skip the batched gather machinery
        k = int(ks[0])
        ok = (win >= Vs[0]).all(axis=2)                         # (m, L)
        good = runs_of_k(ok, k)
        full = np.zeros((W, m), dtype=bool)
        n = min(W, good.shape[1])
        full[:n] = good[:, :n].T
        if reverse:
            full = full[::-1]
        return np.ascontiguousarray(full).reshape(1, W * m)
    ok = (win[None, :, :, :] >= Vs[:, None, None, :]).all(axis=3)  # (g, m, L)
    if (ks == ks[0]).all():
        # stage peers usually share one duration: the per-task gather
        # degenerates to a single slice subtraction over the cumsums
        k0 = int(ks[0])
        good = np.zeros((g, m, W), dtype=bool)
        runs = runs_of_k(ok.reshape(g * m, L), k0).reshape(g, m, -1)
        n = min(W, runs.shape[2])
        good[:, :, :n] = runs[:, :, :n]
    else:
        cz = np.zeros((g, m, L + 1), dtype=np.int32)
        np.cumsum(ok, axis=2, out=cz[:, :, 1:])
        ends = np.minimum(np.arange(W, dtype=np.int64)[None, :] + ks[:, None], L)
        idx = np.broadcast_to(ends[:, None, :], (g, m, W))
        run = np.take_along_axis(cz, idx, axis=2) - cz[:, :, :W]
        # a run truncated by the grid edge counts < k and is correctly excluded
        good = run == ks[:, None, None]                         # (g, m, W)
    good = np.ascontiguousarray(np.swapaxes(good, 1, 2))        # (g, W, m)
    if reverse:
        good = good[:, ::-1, :]
    return good.reshape(g, W * m)


def bucket(n: int, floor: int = 64) -> int:
    """Smallest size >= n on the {64, 96, 128, 192, 256, ...} ladder.

    A 1.5x-stepped power-of-two ladder: padded shapes take a handful of
    distinct values per process and padded work stays within ~50% of the
    true shape.
    """
    if n <= floor:
        return floor
    p = floor
    while True:
        if n <= p:
            return p
        if n <= p + p // 2:
            return p + p // 2
        p *= 2


def pad8(n: int) -> int:
    return ((n + 7) // 8) * 8


#: durations above this never reach the bitmap scans (the sessions answer
#: them with chunked live probes — see core/engine/batched.py)
LONG_K = 128


# ----------------------------------------------------------------------
# cuda / torch implementations (adapters over kernels/placement_scan)
# ----------------------------------------------------------------------

def _up(a: np.ndarray, device: str):
    """Host array -> tensor on ``device`` (always a copy: the host array
    may be mutated later, and a CPU tensor from_numpy would alias it)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _scan_on(avail, Vs, ks, plo, phi, reverse=False, *, device: str):
    """One windowed scan launch.

    On the card, `kernel.scan_call`: the live window ``avail[:, plo:hi]``
    (no padding), the ``ceil32`` demands and the durations go up in one
    pinned copy, and the bitmaps come back already in walk order.  On the
    CPU, the plain version over the reference's padded launch (window -1.0,
    demand 2.0, k = 1, shapes on the bucket ladder): ticks beyond
    ``t_live`` are masked infeasible, so the padding never flips a bit.
    ``PROFILE`` tallies each launch's shape (``scan.<impl>.shape.*``).
    """
    m, T, d = avail.shape
    g = len(ks)
    W = phi - plo
    kmax = int(ks.max())
    hi_read = min(T, phi + kmax - 1)
    L = hi_read - plo
    if device == "cuda":
        from ...kernels.placement_scan import kernel as ps_kernel

        transfer_add(f"scan.cuda.shape.m{m}.W{W}.L{L}.g{g}", 1)
        return ps_kernel.scan_call(avail, plo, L, ceil32(Vs), ks, W, reverse)
    from ...kernels.placement_scan import ops as ps_ops

    Wb = bucket(W)
    Lp = bucket(max(Wb + kmax, L))
    gb = pad8(g)
    win_p = np.full((m, Lp, d), -1.0, dtype=np.float32)
    win_p[:, :L, :] = avail[:, plo:hi_read, :]
    Vs_p = np.full((gb, d), 2.0, dtype=np.float32)
    Vs_p[:g] = ceil32(np.asarray(Vs))
    ks_p = np.ones(gb, dtype=np.int32)
    ks_p[:g] = ks
    transfer_add(f"scan.torch.shape.m{m}.W{Wb}.L{Lp}.g{gb}", 1)
    out = ps_ops.scan_bitmaps(_up(win_p, device), _up(Vs_p, device),
                              _up(ks_p, device), L, W=Wb)
    good = out[:g, :W, :].cpu().numpy() != 0
    if reverse:
        good = good[:, ::-1, :]
    return np.ascontiguousarray(good).reshape(g, W * m)


# -- heartbeat eligibility: sound-superset float32 formulation -------------

def _round_down32(x: np.ndarray) -> np.ndarray:
    """Largest float32 <= x (directed rounding for sound supersets)."""
    x32 = x.astype(np.float32)
    high = x32.astype(np.float64) > x
    if high.any():
        x32[high] = np.nextafter(x32[high], np.float32(-np.inf))
    return x32


def _round_up32(x: np.ndarray) -> np.ndarray:
    """Smallest float32 >= x."""
    x32 = x.astype(np.float32)
    low = x32.astype(np.float64) < x
    if low.any():
        x32[low] = np.nextafter(x32[low], np.float32(np.inf))
    return x32


def _superset_operands(avail, demands, fit_dims, rigid_dims, fungible_dims,
                       overbook_slack, eps=packing.EPS):
    """Host-side exact prep for the eligibility kernel.

    The exact test per (candidate, machine, dim) is
    ``demand <= avail + slack + eps`` in float64.  Rounding the demand
    *down* and the float64 threshold *up* to float32 can only turn False
    into True — a sound superset, which is all the skip-only consumers
    need.  The (m, d)/(n, d) rounding runs on the host (cheap); only the
    (n, m) outer comparison runs on the device.
    """
    avail = np.atleast_2d(np.asarray(avail, dtype=np.float64))
    demands = np.atleast_2d(np.asarray(demands, dtype=np.float64))
    dem32 = _round_down32(demands)
    thr_fit = _round_up32(avail + eps)
    thr_fung = _round_up32(avail + max(overbook_slack, 0.0) + eps)

    def sel(dims):
        dims = np.asarray(dims, dtype=np.int64)
        return dims if len(dims) else np.empty(0, np.int64)

    return dem32, thr_fit, thr_fung, sel(fit_dims), sel(rigid_dims), \
        sel(fungible_dims)


def _eligibility_dims(fit_dims, rigid_dims, fungible_dims, overbook_slack,
                      use_overbooking):
    """The (fit, rigid, fungible, slack) the device ops test.  Without
    overbooking, eligibility is the plain fit mask: the rigid half reuses
    the fit dims and the fungible half is empty, so the kernel stays one
    shape."""
    if not use_overbooking:
        return fit_dims, fit_dims, np.empty(0, np.int64), 0.0
    return fit_dims, rigid_dims, fungible_dims, overbook_slack


def _dim_masks(d: int, *dim_sets) -> list[np.ndarray]:
    """Each dim set as a (d,) float32 {0, 1} mask."""
    masks = []
    for dims in dim_sets:
        mk = np.zeros(d, dtype=np.float32)
        mk[np.asarray(dims, dtype=np.int64)] = 1.0
        masks.append(mk)
    return masks


def _dim_bits(d: int, *dim_sets) -> list[int]:
    """Each dim set as a bitmask over d dims (the staged call's form)."""
    return [sum(1 << int(j) for j in np.flatnonzero(mk))
            for mk in _dim_masks(d, *dim_sets)]


def _eligibility_launch_args(avail, demands, fit_dims, rigid_dims,
                             fungible_dims, overbook_slack, use_overbooking):
    """Shared preamble of the eligibility op's plain (CPU) route.

    Returns ``(dem32, thr_fit, thr_fung, masks)`` ready for the launch, or
    the ``(eligible, machine_any)`` empty-result shortcut when there are no
    candidates.
    """
    dem32, thr_fit, thr_fung, fd, rd, gd = _superset_operands(
        avail, demands, *_eligibility_dims(fit_dims, rigid_dims,
                                           fungible_dims, overbook_slack,
                                           use_overbooking))
    n, d = dem32.shape
    if n == 0:
        m = thr_fit.shape[0]
        return None, (np.zeros((n, m), dtype=bool), np.zeros(m, dtype=bool))
    return (dem32, thr_fit, thr_fung, _dim_masks(d, fd, rd, gd)), None


def _machines_with_candidates_on(avail, demands, fit_dims, rigid_dims,
                                 fungible_dims, overbook_slack=0.0,
                                 use_overbooking=True, *, device: str):
    """Sound-superset eligibility in one launch (see module doc).

    On the card, `kernel.eligible_call`: the float64 rows go up in one
    pinned copy, the kernel rounds them itself (as `_superset_operands`
    does on the host) and writes ``eligible`` and ``machine_any`` into
    pinned host memory.  On the CPU, the host rounding and the plain
    version of the comparison.
    """
    if device == "cuda":
        from ...kernels.placement_scan import kernel as ps_kernel

        avail = np.atleast_2d(np.asarray(avail, dtype=np.float64))
        demands = np.atleast_2d(np.asarray(demands, dtype=np.float64))
        n, m = demands.shape[0], avail.shape[0]
        if n == 0:
            return np.zeros((n, m), dtype=bool), np.zeros(m, dtype=bool)
        fd, rd, gd, slack = _eligibility_dims(
            fit_dims, rigid_dims, fungible_dims, overbook_slack,
            use_overbooking)
        return ps_kernel.eligible_call(avail, demands, max(slack, 0.0),
                                       packing.EPS,
                                       *_dim_bits(avail.shape[1], fd, rd, gd))
    from ...kernels.placement_scan import ops as ps_ops

    args, empty = _eligibility_launch_args(avail, demands, fit_dims,
                                           rigid_dims, fungible_dims,
                                           overbook_slack, use_overbooking)
    if empty is not None:
        return empty
    dem32, thr_fit, thr_fung, masks = args
    out = ps_ops.heartbeat_eligible(_up(dem32, device), _up(thr_fit, device),
                                    _up(thr_fung, device),
                                    *[_up(mk, device) for mk in masks])
    eligible = out.cpu().numpy() != 0
    return eligible, eligible.any(axis=0)


def _fits_mask_on(avail, demand, dims=None, slack=0.0, eps=packing.EPS, *,
                  device: str):
    """float32 fit mask, a superset of `packing.fits_mask` (not bit-exact):
    the host rounds the thresholds ``avail + slack + eps`` up and the
    demands down to float32, the device compares.  Same shapes as the
    numpy op: (), (m,), (n,) or (n, m)."""
    avail = np.asarray(avail, dtype=np.float64)
    demand = np.asarray(demand, dtype=np.float64)
    if dims is not None:
        dims = np.asarray(dims, dtype=np.int64)
        if len(dims) == 0:
            if avail.ndim == 2 and demand.ndim == 2:
                return np.ones((demand.shape[0], avail.shape[0]), dtype=bool)
            shape = np.broadcast_shapes(avail.shape[:-1], demand.shape[:-1])
            return np.ones(shape, dtype=bool)
        avail = avail[..., dims]
        demand = demand[..., dims]
    thr = _up(_round_up32(avail + slack + eps), device)
    dem = _up(_round_down32(demand), device)
    if avail.ndim == 2 and demand.ndim == 2:
        out = (dem[:, None, :] <= thr[None, :, :]).all(dim=2)
    else:
        out = (dem <= thr).all(dim=-1)
    return out.cpu().numpy()


def _pack_score_on(avail, demand, clip=False, *, device: str):
    """Tetris scores as one float32 product on the device (close to, not
    identical with, `packing.pack_score`'s float64)."""
    import torch

    a = _up(np.asarray(avail, dtype=np.float32), device)
    if clip:
        a = a.clamp_min(0.0)
    dm = _up(np.asarray(demand, dtype=np.float32), device)
    if a.ndim == 2 and dm.ndim == 2:
        out = dm @ a.T
    else:
        out = (dm @ torch.atleast_2d(a).transpose(-1, -2)).squeeze()
    return out.cpu().numpy().astype(np.float64)


def _heartbeat_masks_on(avail, demands, fit_dims, rigid_dims, fungible_dims,
                        overbook_slack=0.0, use_overbooking=True, *,
                        device: str):
    """Superset ``(fits, over)`` masks (n, m); see the exactness contract:
    only ``fits | over`` is a superset of the exact union.  The union is
    the eligibility kernel's (`kernel.eligible_launch` on the card, its
    plain version ``ref.heartbeat_eligible64`` on the CPU: float64 rows in,
    rounded on the device); ``fits`` is the fit dims' test rounded the same
    way (demands down, ``avail + eps`` up), and ``over`` the union without
    it."""
    import torch

    from ...kernels.placement_scan import ref as ps_ref

    avail = np.atleast_2d(np.asarray(avail, dtype=np.float64))
    demands = np.atleast_2d(np.asarray(demands, dtype=np.float64))
    n, (m, d) = demands.shape[0], avail.shape
    if n == 0:
        empty = np.zeros((0, m), dtype=bool)
        return empty, empty.copy()
    fd, rd, gd, slack = _eligibility_dims(fit_dims, rigid_dims,
                                          fungible_dims, overbook_slack,
                                          use_overbooking)
    slack = max(slack, 0.0)
    a_t, d_t = _up(avail, device), _up(demands, device)
    if device == "cuda":
        from ...kernels.placement_scan import kernel as ps_kernel

        el, _any = ps_kernel.eligible_launch(a_t, d_t, slack, packing.EPS,
                                             *_dim_bits(d, fd, rd, gd))
        union = el.t() != 0
    else:
        masks = [torch.from_numpy(mk) for mk in _dim_masks(d, fd, rd, gd)]
        el, _any = ps_ref.heartbeat_eligible64(a_t, d_t, slack, packing.EPS,
                                               *masks)
        union = el != 0
    fit = torch.from_numpy(np.asarray(fit_dims, dtype=np.int64)).to(device)
    if len(fit):
        thr = ps_ref.round_up32(a_t[:, fit] + packing.EPS)
        dem = ps_ref.round_down32(d_t[:, fit])
        fits = (dem[:, None, :] <= thr[None, :, :]).all(dim=2)
    else:
        fits = torch.ones((n, m), dtype=torch.bool, device=device)
    return fits.cpu().numpy(), (union & ~fits).cpu().numpy()


# ----------------------------------------------------------------------
# registry + dispatch
# ----------------------------------------------------------------------

_REGISTRY: dict[tuple[str, str], tuple[Callable, Callable[[], bool]]] = {}


def register(op: str, impl: str, fn: Callable,
             available: Callable[[], bool] = lambda: True) -> None:
    _REGISTRY[(op, impl)] = (fn, available)


def have_cuda() -> bool:
    import torch

    return bool(torch.cuda.is_available())


register("scan", "numpy", scan_starts)
register("fits_mask", "numpy", packing.fits_mask)
register("pack_score", "numpy", packing.pack_score)
register("heartbeat_masks", "numpy", packing.heartbeat_masks)
register("machines_with_candidates", "numpy", packing.machines_with_candidates)

# imported at the bottom on purpose: wave.py references this module's
# registry helpers lazily (inside functions), so by the time either side
# runs, both modules are fully initialized — no import cycle
from . import wave as _wave  # noqa: E402

register("match_wave", "numpy", _wave.match_wave_numpy)
for _impl, _dev, _avail in (("cuda", "cuda", have_cuda),
                            ("torch", "cpu", lambda: True)):
    register("scan", _impl, functools.partial(_scan_on, device=_dev), _avail)
    register("machines_with_candidates", _impl,
             functools.partial(_machines_with_candidates_on, device=_dev),
             _avail)
    register("match_wave", _impl,
             functools.partial(_wave.device_wave, impl=_impl, device=_dev),
             _avail)
    for _op, _fn in (("fits_mask", _fits_mask_on),
                     ("pack_score", _pack_score_on),
                     ("heartbeat_masks", _heartbeat_masks_on)):
        register(_op, _impl, functools.partial(_fn, device=_dev), _avail)


_REQ_CACHE: tuple[str, dict] | None = None


def _requested() -> dict[str, str]:
    """Parsed REPRO_KERNELS, cached per raw env value (dispatch-hot)."""
    global _REQ_CACHE
    raw = os.environ.get(KERNELS_ENV, "")
    if _REQ_CACHE is not None and _REQ_CACHE[0] == raw:
        return _REQ_CACHE[1]
    out: dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        op, impl = part.split("=", 1)
        op, impl = op.strip(), impl.strip()
        if impl not in IMPLS:
            raise ValueError(f"unknown kernel impl {impl!r}; have {IMPLS}")
        if op == "all":
            for o in OPS:
                if o not in EXPLICIT_ONLY:
                    out.setdefault(o, impl)
        elif op in OPS:
            out[op] = impl
        else:
            raise ValueError(f"unknown kernel op {op!r}; have {OPS}")
    _REQ_CACHE = (raw, out)
    return out


def resolve(op: str) -> tuple[str, Callable]:
    """(impl name, callable) for one op, honoring pin, device and demotion.

    The wanted impl is the REPRO_KERNELS pin, else ``numpy`` for the
    explicit-only ops and, for the others, ``cuda`` on the cuda device and
    ``torch`` on the cpu device.  An impl that was sticky-demoted resolves
    down the chain; a wanted cuda impl with no card raises instead.
    """
    want = _requested().get(op)
    if want is None:
        want = ("numpy" if op in EXPLICIT_ONLY
                else "cuda" if current_device() == "cuda" else "torch")
    demoted = _DEMOTED.get(op, ())
    for impl in IMPLS[IMPLS.index(want):]:
        if impl in demoted:
            continue
        ent = _REGISTRY.get((op, impl))
        if ent is None:
            continue
        if not ent[1]():
            raise RuntimeError(f"kernel op {op!r} wants impl {impl!r}, which "
                               "is unavailable (no CUDA device)")
        return impl, ent[0]
    raise RuntimeError(f"no implementation available for kernel op {op!r}")


def active() -> dict[str, str]:
    """op -> impl selected right now (pin + device + demotions)."""
    return {op: resolve(op)[0] for op in OPS}


def _call_profiled(op: str, impl: str, fn: Callable, *args, **kwargs):
    key = f"{op}.{impl}"
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        dt = time.perf_counter() - t0
        with _STATS_LOCK:
            slot = PROFILE.get(key)
            if slot is None:
                slot = PROFILE[key] = [0, 0.0]
            slot[0] += 1
            slot[1] += dt


def _profile_calls(key: str) -> int:
    with _STATS_LOCK:
        slot = PROFILE.get(key)
        return int(slot[0]) if slot else 0


def _run_op(op: str, args, kwargs):
    """Dispatch with sticky demotion on injected faults only: an injected
    ``kernel_impl`` fault demotes the impl and the op re-resolves down the
    chain (the numpy oracle terminates it, so the answer stays exact); any
    other exception propagates.  The seam is keyed by the impl's running
    call count so probabilistic plans fire per call, not per op."""
    while True:
        impl, fn = resolve(op)
        try:
            if impl != "numpy":
                faults.maybe_fail("kernel_impl", op=op, impl=impl,
                                  call=_profile_calls(f"{op}.{impl}"))
            return _call_profiled(op, impl, fn, *args, **kwargs)
        except faults.InjectedFault as exc:
            if impl == "numpy" or exc.seam != "kernel_impl":
                raise
            demote(op, impl)


# -- public dispatching entry points -----------------------------------

def scan(avail, Vs, ks, plo, phi, reverse=False):
    """Windowed feasibility scan through the dispatch table."""
    return _run_op("scan", (avail, Vs, ks, plo, phi, reverse), {})


def fits_mask(avail, demand, dims=None, slack=0.0, eps=packing.EPS):
    return _run_op("fits_mask", (avail, demand, dims, slack, eps), {})


def pack_score(avail, demand, clip=False):
    return _run_op("pack_score", (avail, demand, clip), {})


def heartbeat_masks(avail, demands, fit_dims, rigid_dims, fungible_dims,
                    overbook_slack=0.0, use_overbooking=True):
    return _run_op("heartbeat_masks",
                   (np.asarray(avail), demands, fit_dims, rigid_dims,
                    fungible_dims, overbook_slack, use_overbooking), {})


def machines_with_candidates(avail, demands, fit_dims, rigid_dims,
                             fungible_dims, overbook_slack=0.0,
                             use_overbooking=True):
    return _run_op("machines_with_candidates",
                   (np.asarray(avail), demands, fit_dims, rigid_dims,
                    fungible_dims, overbook_slack, use_overbooking), {})


def match_wave(ctx) -> int:
    """One fused heartbeat wave over a ``wave.WaveContext``.

    Bit-exact under every implementation; an injected ``kernel_impl``
    fault sticky-demotes back down the chain with identical decisions —
    the device impls mutate no matcher state before their launch returns.
    """
    return _run_op("match_wave", (ctx,), {})
