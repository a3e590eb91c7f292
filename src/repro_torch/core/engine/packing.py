"""Shared multi-resource fit/score kernels (the online placement core).

The offline builder places tasks into the virtual resource-time space; the
work-conserving executor (`core.baselines.simulate_execution`), the online
matcher (`core.online.Matcher`) and the cluster simulator
(`sim.cluster.ClusterSim`) all answer the same two questions about *now*:

  * which candidate tasks fit into a machine's remaining capacity, and
  * how well does a task pack there (Tetris dot-product score §5).

These kernels are that shared core, so every layer uses identical epsilon
and dimension-subset semantics.

They are also the ``numpy`` implementations — the exact float64 oracles —
of the corresponding ops in the kernel-dispatch layer
(``core/engine/kernels.py``), which layers cuda/torch variants on top.
Decision-bearing callers (the matcher's bundling loop, speculative-copy
placement) import this module directly on purpose: those must never be
rerouted to an approximate implementation.  Skip-only callers go through
the dispatch wrappers instead.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

EPS = 1e-9


def fits_mask(
    avail: np.ndarray,
    demand: np.ndarray,
    dims: Sequence[int] | np.ndarray | None = None,
    slack: float = 0.0,
    eps: float = EPS,
) -> np.ndarray:
    """Boolean fit test, broadcasting over machines and/or candidates.

    avail  — (d,) one machine, or (m, d) many machines
    demand — (d,) one task, or (n, d) many tasks
    dims   — resource dims the scheduler checks (None = all)
    slack  — extra headroom per checked dim (overbooking allowance)

    Returns the broadcast ``.all``-over-dims result: (), (m,), (n,), or
    (n, m) depending on the inputs.
    """
    avail = np.asarray(avail)
    demand = np.asarray(demand)
    if dims is not None:
        dims = np.asarray(dims, dtype=np.int64)
        if len(dims) == 0:
            if avail.ndim == 2 and demand.ndim == 2:  # (n, m) orientation
                return np.ones((demand.shape[0], avail.shape[0]), dtype=bool)
            shape = np.broadcast_shapes(avail.shape[:-1], demand.shape[:-1])
            return np.ones(shape, dtype=bool)
        avail = avail[..., dims]
        demand = demand[..., dims]
    if avail.ndim == 2 and demand.ndim == 2:
        return (demand[:, None, :] <= avail[None, :, :] + slack + eps).all(axis=2)
    return (demand <= avail + slack + eps).all(axis=-1)


def pack_score(
    avail: np.ndarray,
    demand: np.ndarray,
    clip: bool = False,
) -> np.ndarray:
    """Tetris packing score: dot(demand, available) (§5 pScore).

    avail (d,) or (m, d); demand (d,) or (n, d).  Returns (), (m,), (n,)
    or (n, m).  ``clip`` floors availability at 0 first (overbooked
    machines report negative headroom).
    """
    avail = np.asarray(avail, dtype=np.float64)
    if clip:
        avail = np.clip(avail, 0.0, None)
    demand = np.asarray(demand)
    if avail.ndim == 2 and demand.ndim == 2:
        return demand @ avail.T
    return demand @ np.swapaxes(np.atleast_2d(avail), -1, -2).squeeze()


def heartbeat_masks(
    avail: np.ndarray,
    demands: np.ndarray,
    fit_dims: Sequence[int] | np.ndarray,
    rigid_dims: Sequence[int] | np.ndarray,
    fungible_dims: Sequence[int] | np.ndarray,
    overbook_slack: float = 0.0,
    use_overbooking: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Fit/overbook masks for every (candidate, machine) pair of a heartbeat.

    avail (m, d), demands (n, d).  Returns ``(fits, over)`` as (n, m) bool
    arrays with exactly the matcher's per-machine semantics: ``fits`` is a
    fit on all checked dims; ``over`` marks candidates that do not fit but
    whose rigid dims fit outright and whose fungible dims fit within the
    bounded overbooking allowance.  Pure comparisons — no float arithmetic
    beyond the same ``avail + slack + eps`` adds the scalar path performs —
    so a row of this matrix equals the per-machine masks bit-for-bit.
    """
    fits = fits_mask(np.atleast_2d(avail), np.atleast_2d(demands),
                     dims=np.asarray(fit_dims))
    if not use_overbooking:
        return fits, np.zeros_like(fits)
    over = (~fits
            & fits_mask(np.atleast_2d(avail), np.atleast_2d(demands),
                        dims=np.asarray(rigid_dims))
            & fits_mask(np.atleast_2d(avail), np.atleast_2d(demands),
                        dims=np.asarray(fungible_dims), slack=overbook_slack))
    return fits, over


def machines_with_candidates(
    avail: np.ndarray,
    demands: np.ndarray,
    fit_dims: Sequence[int] | np.ndarray,
    rigid_dims: Sequence[int] | np.ndarray,
    fungible_dims: Sequence[int] | np.ndarray,
    overbook_slack: float = 0.0,
    use_overbooking: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Which machines could start *some* candidate this heartbeat.

    Returns ``(eligible (n, m) bool, machine_any (m,) bool)`` where
    ``eligible = fits | over`` from :func:`heartbeat_masks`.  A machine
    whose column has no True bit cannot pick anything, so a matcher call
    for it is a guaranteed no-op (no picks, no deficit/EMA mutation) and
    may be skipped without changing any scheduling decision.

    A cheap exact pre-filter runs first: the per-dim minimum demand over
    candidates is a lower bound on every candidate, so a machine that
    cannot fit even that minimum on some rigid dim (or some fungible dim
    within slack) hosts nothing; full (n, m) masks are only computed for
    the machines that survive.
    """
    avail = np.atleast_2d(avail)
    demands = np.atleast_2d(demands)
    m = avail.shape[0]
    n = demands.shape[0]
    eligible = np.zeros((n, m), dtype=bool)
    if n == 0:
        return eligible, np.zeros(m, dtype=bool)
    min_dem = demands.min(axis=0)
    rigid = np.asarray(rigid_dims, dtype=np.int64)
    fung = np.asarray(fungible_dims, dtype=np.int64)
    survive = fits_mask(avail, min_dem, dims=rigid)
    if use_overbooking:
        # clamp the prefilter slack at 0 so fitting candidates survive even
        # under a sub-1.0 overbooking cap (fits ⊆ rigid-fit ∧ fung-fit)
        survive &= fits_mask(avail, min_dem, dims=fung,
                             slack=max(overbook_slack, 0.0))
    else:
        survive &= fits_mask(avail, min_dem, dims=np.asarray(fit_dims))
    idx = np.flatnonzero(survive)
    if len(idx):
        fits, over = heartbeat_masks(avail[idx], demands, fit_dims, rigid,
                                     fung, overbook_slack, use_overbooking)
        eligible[:, idx] = fits | over
    return eligible, eligible.any(axis=0)


def best_fit_machines(
    avail: np.ndarray,
    demands: np.ndarray,
    dims: Sequence[int] | np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-candidate best machine by packing score among fitting machines.

    avail (m, d), demands (n, d).  Returns (ok (n, m), best_m (n,),
    best_score (n,)); best entries are -inf where nothing fits.
    """
    dsel = demands if dims is None else demands[:, np.asarray(dims)]
    asel = avail if dims is None else avail[:, np.asarray(dims)]
    ok = (asel[None, :, :] >= dsel[:, None, :] - EPS).all(axis=2)   # (n, m)
    scores = np.where(ok, dsel @ asel.T, -np.inf)
    best_m = np.argmax(scores, axis=1)
    best_s = scores[np.arange(len(demands)), best_m]
    return ok, best_m, best_s
