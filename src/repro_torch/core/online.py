"""Online multi-DAG scheduler (paper §5, Fig. 8).

Reconciles discordant objectives when many jobs share the cluster:
  * each job's *preferred schedule* (priScore from the offline builder §4),
  * multi-resource packing (pScore = dot(demand, available), with a remote
    penalty for locality-sensitive tasks),
  * judicious overbooking of fungible resources (oScore),
  * SRPT to lower average JCT (eta * srpt_j),
  * bounded unfairness via deficit counters (kappa * C), pluggable fairness
    f() — slot fairness or DRF.

`Matcher.match_batch` is FindAppropriateTasksForMachine with bundling: it
returns a *set* of tasks to start on the machine in one heartbeat (§7.2),
scored over the structure-of-arrays `CandidateBatch` columns that the
persistent `TaskPool` maintains incrementally (no per-heartbeat object
rebuilds; see "online data path" in docs/architecture.md).
`Matcher.find_tasks_for_machine` is the object-list compatibility wrapper
over the same core.

The bundling loop's own float ops stay numpy float64 on purpose: picks,
overbook flags and EMA observations are *decisions* and must be
bit-identical to the historical matcher.  The skip-only front half of a
heartbeat — which machines could start anything at all — goes through the
kernel-dispatch layer instead (`core/engine/kernels.
machines_with_candidates`, called by `sim/cluster.py`), where any sound
superset implementation is decision-exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .engine import packing

# resource dims (cores, memory, network, disk); network+disk are fungible —
# they can be overbooked at the price of slowdown, cores/memory cannot.
FUNGIBLE = (2, 3)
RIGID = (0, 1)


@dataclasses.dataclass
class PendingTask:
    job_id: int
    task_id: int
    demand: np.ndarray
    duration: float
    pri_score: float = 1.0
    locality: int = -1          # preferred machine id, -1 = none


@dataclasses.dataclass
class JobView:
    """What the matcher needs to know about a job (AM -> RM interface §7)."""
    job_id: int
    group: int                 # jobgroup / queue for fairness
    srpt: float                # remaining work: sum duration * |demands|


@dataclasses.dataclass
class CandidateBatch:
    """Structure-of-arrays view of one heartbeat's candidate tasks.

    One row per candidate; the matcher scores whole columns at once instead
    of walking lists of `PendingTask` objects.  `job`/`tid` map rows back to
    (job_id, task_id) for whoever starts the picked tasks.
    """

    dem: np.ndarray    # (n, d) float64 demand
    pri: np.ndarray    # (n,) preferred-schedule priScore
    srpt: np.ndarray   # (n,) owning job's remaining work
    grp: np.ndarray    # (n,) int fairness group of the owning job
    loc: np.ndarray    # (n,) int preferred machine, -1 = none
    job: np.ndarray    # (n,) int owning job id
    tid: np.ndarray    # (n,) int task id within the job

    def __len__(self) -> int:
        return len(self.dem)

    def take(self, idx: np.ndarray) -> "CandidateBatch":
        """Compress to the given rows (contiguous copies, order preserved)."""
        return CandidateBatch(self.dem[idx], self.pri[idx], self.srpt[idx],
                              self.grp[idx], self.loc[idx], self.job[idx],
                              self.tid[idx])


class _PoolJob:
    """Per-job slot of the task pool: cached exposure + demand/pri rows."""

    __slots__ = ("job_id", "group", "demand", "pri", "runnable", "srpt",
                 "dirty", "tids", "dem_rows", "pri_rows")

    def __init__(self, job_id: int, group: int, demand: np.ndarray,
                 pri: np.ndarray, runnable: set[int], srpt: float):
        self.job_id = job_id
        self.group = group
        self.demand = np.asarray(demand)
        self.pri = np.asarray(pri)
        self.runnable = runnable      # live reference, mutated by the owner
        self.srpt = srpt
        self.dirty = True
        self.tids = np.empty(0, dtype=np.int64)
        self.dem_rows = np.empty((0, demand.shape[1]))
        self.pri_rows = np.empty(0)


class TaskPool:
    """Persistent SoA pending-task pool shared by simulator and matcher.

    Jobs register once (in arrival order — candidate ordering follows job
    registration order, matching the former per-heartbeat rebuild of the
    candidate list); afterwards the owner marks a job dirty whenever its
    runnable set changes and pushes SRPT updates as tasks finish.  A
    heartbeat then calls `refresh()`, which re-sorts only the dirty jobs'
    exposure (top `expose` runnable tasks by priScore, ties in the runnable
    set's iteration order — identical to sorting the set from scratch) and
    reuses cached per-job demand/priority rows for everyone else.  The flat
    (n, d)/(n,) arrays handed to the matcher are concatenations of those
    cached rows: no `PendingTask` objects, no per-machine `np.stack`.
    """

    def __init__(self, d: int, expose: int = 8):
        self.d = d
        self.expose = expose
        self._jobs: dict[int, _PoolJob] = {}
        self._pool_jobs: list[_PoolJob] = []
        self._any_dirty = True
        self._srpt_dirty = True
        self._batch: CandidateBatch | None = None

    def add_job(self, job_id: int, group: int, demand: np.ndarray,
                pri: np.ndarray, runnable: set[int], srpt: float) -> None:
        self._jobs[job_id] = _PoolJob(job_id, group, demand, pri, runnable,
                                      srpt)
        self._any_dirty = True

    def remove_job(self, job_id: int) -> None:
        if self._jobs.pop(job_id, None) is not None:
            self._any_dirty = True

    def mark_dirty(self, job_id: int) -> None:
        pj = self._jobs.get(job_id)
        if pj is not None:
            pj.dirty = True
            self._any_dirty = True

    def set_srpt(self, job_id: int, srpt: float) -> None:
        pj = self._jobs.get(job_id)
        if pj is not None:
            pj.srpt = srpt
            self._srpt_dirty = True

    def refresh(self) -> CandidateBatch | None:
        """Current candidate batch, rebuilding only what changed."""
        if not self._any_dirty and not self._srpt_dirty:
            return self._batch
        if self._any_dirty:
            per_job: list[_PoolJob] = []
            for pj in self._jobs.values():
                if pj.dirty:
                    # identical to the former per-heartbeat rebuild: a set's
                    # iteration order is stable between mutations, so sorting
                    # only when the set changed yields the same exposure.
                    top = sorted(pj.runnable,
                                 key=lambda t: -pj.pri[t])[: self.expose]
                    pj.tids = np.asarray(top, dtype=np.int64)
                    pj.dem_rows = pj.demand[pj.tids]
                    pj.pri_rows = pj.pri[pj.tids].astype(np.float64)
                    pj.dirty = False
                if len(pj.tids):
                    per_job.append(pj)
            if not per_job:
                self._batch = None
                self._any_dirty = self._srpt_dirty = False
                return None
            counts = [len(pj.tids) for pj in per_job]
            self._batch = CandidateBatch(
                dem=np.concatenate([pj.dem_rows for pj in per_job]),
                pri=np.concatenate([pj.pri_rows for pj in per_job]),
                srpt=np.repeat(np.asarray([pj.srpt for pj in per_job],
                                          dtype=np.float64), counts),
                grp=np.repeat(np.asarray([pj.group for pj in per_job],
                                         dtype=np.int64), counts),
                loc=np.full(sum(counts), -1, dtype=np.int64),
                job=np.repeat(np.asarray([pj.job_id for pj in per_job],
                                         dtype=np.int64), counts),
                tid=np.concatenate([pj.tids for pj in per_job]),
            )
            self._pool_jobs = per_job
        elif self._batch is not None:
            # only SRPT moved: re-gather that one column over cached rows
            counts = [len(pj.tids) for pj in self._pool_jobs]
            self._batch = dataclasses.replace(
                self._batch,
                srpt=np.repeat(np.asarray([pj.srpt for pj in self._pool_jobs],
                                          dtype=np.float64), counts))
        self._any_dirty = self._srpt_dirty = False
        return self._batch


def seq_dot(dem: np.ndarray, avail: np.ndarray) -> np.ndarray:
    """Left-to-right accumulated dot(dem, avail): the packing score.

    Deliberately NOT ``dem @ avail``: BLAS matvecs reorder and fuse the
    per-dim multiply-adds, so their last-ulp rounding differs between
    hosts, libraries and accelerators.  An explicit chain of individually
    rounded multiplies and adds has exactly one float64 result, which the
    CUDA wave kernel and its plain torch version reproduce bit-for-bit
    (no product contracts into a fused multiply-add — see
    engine/wave.py).
    """
    acc = dem[:, 0] * avail[0]
    for k in range(1, dem.shape[1]):
        acc = acc + dem[:, k] * avail[k]
    return acc


def slot_fairness(demand: np.ndarray) -> float:
    """f() = 1: slot fairness."""
    return 1.0


def drf_fairness(demand: np.ndarray) -> float:
    """f() = dominant share of the task's demand: DRF."""
    return float(np.max(demand))


@dataclasses.dataclass
class MatcherConfig:
    eta_m: float = 0.2             # paper §8.5: m in [0.1, 0.3], rec 0.2
    remote_penalty: float = 0.8    # rp (§8.5)
    kappa: float = 0.1             # unfairness bound as a fraction of C
    max_overbook: float = 1.25     # cap on fungible-resource overbooking
    fairness: Callable[[np.ndarray], float] = slot_fairness
    use_priority: bool = True      # use the preferred-schedule priScore
    use_packing: bool = True       # use pScore packing (else FIFO-ish)
    use_srpt: bool = True
    use_overbooking: bool = True
    bundle_limit: int = 64         # max tasks matched per heartbeat
    # dims the scheduler *checks* when fitting.  Tez/CP-style schedulers only
    # know cores+memory (0, 1); ignoring network/disk over-allocates them,
    # which the simulator charges back as a slowdown (Fig. 11 discussion).
    fit_dims: tuple[int, ...] = (0, 1, 2, 3)


class DeficitCounters:
    """Bounded unfairness via deficit counters (§5, [64])."""

    def __init__(self, shares: dict[int, float], capacity: float, kappa: float):
        total = sum(shares.values()) or 1.0
        self.share = {g: s / total for g, s in shares.items()}
        self.deficit = {g: 0.0 for g in shares}
        self.capacity = capacity
        self.kappa = kappa

    def most_deprived(self) -> tuple[int | None, float]:
        if not self.deficit:
            return None, 0.0
        g = max(self.deficit, key=lambda g: self.deficit[g])
        return g, self.deficit[g]

    def must_serve(self) -> int | None:
        g, d = self.most_deprived()
        if g is not None and d >= self.kappa * self.capacity:
            return g
        return None

    def allocated(self, group: int, weight: float) -> None:
        for g in self.deficit:
            self.deficit[g] += self.share[g] * weight
        self.deficit[group] -= weight

    def set_groups(self, shares: dict[int, float]) -> None:
        total = sum(shares.values()) or 1.0
        self.share = {g: s / total for g, s in shares.items()}
        for g in shares:
            self.deficit.setdefault(g, 0.0)
        for g in list(self.deficit):
            if g not in shares:
                del self.deficit[g]

    def jain_index(self, usage: dict[int, float]) -> float:
        """Jain's fairness index over normalized usages (Table 4)."""
        xs = np.array([usage.get(g, 0.0) / max(self.share[g], 1e-12) for g in self.share])
        if xs.sum() <= 0:
            return 1.0
        return float(xs.sum() ** 2 / (len(xs) * (xs ** 2).sum()))


class Matcher:
    """FindAppropriateTasksForMachine (Fig. 8) with bundling."""

    def __init__(self, cfg: MatcherConfig, capacity: float, shares: dict[int, float]):
        self.cfg = cfg
        self.deficits = DeficitCounters(shares, capacity, cfg.kappa)
        self._ema_score = 1.0
        self._ema_srpt = 1.0
        # cfg.fit_dims is fixed for the matcher's lifetime; hoist the dim
        # split out of the per-machine hot path
        self._dim_split = (
            np.asarray(cfg.fit_dims),
            np.asarray([r for r in RIGID if r in cfg.fit_dims], dtype=int),
            np.asarray([f for f in FUNGIBLE if f in cfg.fit_dims], dtype=int),
        )

    @property
    def eta(self) -> float:
        if not self.cfg.use_srpt:
            return 0.0
        return self.cfg.eta_m * self._ema_score / max(self._ema_srpt, 1e-12)

    def _observe(self, score: float, srpt: float) -> None:
        a = 0.05
        self._ema_score = (1 - a) * self._ema_score + a * score
        self._ema_srpt = (1 - a) * self._ema_srpt + a * max(srpt, 1e-12)

    def fit_dim_split(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(fit, rigid, fungible) dim index arrays under this config."""
        return self._dim_split

    def find_tasks_for_machine(
        self,
        machine_id: int,
        avail: np.ndarray,
        tasks: Sequence[PendingTask],
        jobs: dict[int, JobView],
    ) -> list[tuple[PendingTask, bool]]:
        """Returns [(task, overbooked)] to start now on this machine.

        Object-list compatibility wrapper over `match_batch`: builds the
        SoA columns exactly as the matcher always has and maps picked rows
        back to the `PendingTask` objects.
        """
        if not tasks:
            return []
        cand = CandidateBatch(
            dem=np.stack([t.demand for t in tasks]),
            pri=np.array([t.pri_score for t in tasks]),
            srpt=np.array([jobs[t.job_id].srpt for t in tasks]),
            grp=np.array([jobs[t.job_id].group for t in tasks]),
            loc=np.array([t.locality for t in tasks], dtype=np.int64),
            job=np.array([t.job_id for t in tasks], dtype=np.int64),
            tid=np.array([t.task_id for t in tasks], dtype=np.int64),
        )
        return [(tasks[i], over)
                for i, over in self.match_batch(machine_id, avail, cand)]

    def match_batch(
        self,
        machine_id: int,
        avail: np.ndarray,
        cand: CandidateBatch,
        active: np.ndarray | None = None,
    ) -> list[tuple[int, bool]]:
        """Returns [(candidate row, overbooked)] to start on this machine.

        The sequential bundling/deficit loop over precomputed SoA columns:
        each iteration is a handful of numpy ops on (n, d) arrays, and the
        decisions (pick order, overbook flags, EMA observations, deficit
        updates) are bit-identical to the historical object-list matcher.

        ``active`` (bool (n,)), when given, excludes rows as if they were
        already taken — the wave loops pass their live mask directly so a
        per-machine call allocates O(1) instead of compressing the batch
        with ``take`` (returned row indices are global either way: they
        index ``cand``).  Masking is decision-identical to compressing:
        scores are per-row and ``argmax`` tie-breaks on first index, which
        order-preserving compression does not change.
        """
        cfg = self.cfg
        n = len(cand)
        if n == 0:
            return []
        if active is not None and not active.any():
            return []
        avail = avail.astype(np.float64).copy()
        dem = cand.dem                                      # (n, d)
        pri = cand.pri if cfg.use_priority else np.ones(n)
        srpt = cand.srpt
        grp = cand.grp
        rp = np.where((cand.loc >= 0) & (cand.loc != machine_id),
                      cfg.remote_penalty, 1.0)
        fd, rigid, fung = self.fit_dim_split()
        # hoist the per-dim gathers: each bundling iteration then compares
        # against the same `avail + slack + eps` sums the shared fits_mask
        # kernel forms, just without re-slicing the demand matrix
        dem_fd = dem[:, fd]
        dem_rigid = dem[:, rigid]
        dem_fung = dem[:, fung]
        ob_slack = cfg.max_overbook - 1.0
        no_over = np.zeros(n, dtype=bool)
        no_shoot = np.zeros(n)
        taken = ~active if active is not None else np.zeros(n, dtype=bool)
        picked: list[tuple[int, bool]] = []
        while len(picked) < cfg.bundle_limit:
            fits = (dem_fd <= avail[fd] + packing.EPS).all(axis=1)
            if cfg.use_overbooking:
                # rigid dims must really fit; fungible dims may overshoot by
                # the bounded overbooking allowance
                over = (~fits
                        & (dem_rigid <= avail[rigid] + packing.EPS).all(axis=1)
                        & (dem_fung <= avail[fung] + ob_slack + packing.EPS).all(axis=1))
            else:
                over = no_over
            eligible = (fits | over) & ~taken
            must_group = self.deficits.must_serve()
            if must_group is not None and (eligible & (grp == must_group)).any():
                eligible &= grp == must_group
            if not eligible.any():
                break
            if cfg.use_packing:
                dot = seq_dot(dem, np.clip(avail, 0.0, None)) * rp
            else:
                dot = rp.copy()
            if len(fung):
                overshoot = np.clip((dem_fung - avail[fung]).max(axis=1), 0.0, None)
            else:
                overshoot = no_shoot
            base = np.where(fits, dot, dot * np.maximum(1.0 - overshoot, 0.05))
            perf = pri * base - self.eta * srpt
            # lexicographic: any fitting task beats any overbooked one
            pool = eligible & fits if (eligible & fits).any() else eligible
            score = np.where(pool, perf, -np.inf)
            i = int(np.argmax(score))
            if not np.isfinite(score[i]):
                break
            taken[i] = True
            picked.append((i, bool(over[i])))
            self._observe(float(pri[i] * base[i]), float(srpt[i]))
            avail -= dem[i]
            np.clip(avail, 0.0, None, out=avail)
            self.deficits.allocated(int(grp[i]), cfg.fairness(dem[i]))
        return picked


def overload_factor(avail_row: np.ndarray) -> float:
    """Slowdown factor for a task launched on a machine with this
    (post-allocation) availability row: overload on the fungible dims
    (indices >= 2 — network/disk, the Fig. 11 effect) stretches every
    task on the machine.  Shared verbatim by the simulator's
    ``start_task`` and the scheduler service's lease grants so both
    compute bit-identical effective durations.
    """
    load = 1.0 - avail_row
    return float(max(load[2:].max() if avail_row.shape[0] > 2 else 0.0, 1.0))


class JobState:
    """Per-job DAG progress bookkeeping: pending-parent counts, the
    runnable/running/done partition, and the remaining-work (srpt)
    accumulator.

    One implementation shared by `sim.cluster.ClusterSim` and the
    scheduler service core (`svc.scheduler.SchedulerCore`) — decision
    parity between the two starts with them advancing identical job
    state through identical transitions.
    """

    def __init__(self, job_id: int, dag, arrival: float, group: int,
                 pri: np.ndarray):
        self.job_id = job_id
        self.dag = dag
        self.arrival = arrival
        self.group = group
        self.pri = pri
        self.pending_parents = np.array(
            [len(dag.parents[i]) for i in range(dag.n)])
        self.runnable: set[int] = {
            i for i in range(dag.n) if self.pending_parents[i] == 0}
        self.running: set[int] = set()
        self.done: set[int] = set()
        weight = np.abs(dag.demand).sum(axis=1)
        self._work = dag.duration * weight
        self.srpt = float(self._work.sum())
        self.finish: float | None = None

    def task_started(self, t: int) -> None:
        self.runnable.discard(t)
        self.running.add(t)

    def task_requeued(self, t: int) -> None:
        self.running.discard(t)
        self.runnable.add(t)

    def task_done(self, t: int) -> list[int]:
        if t in self.done:
            return []
        self.running.discard(t)
        self.runnable.discard(t)
        self.done.add(t)
        self.srpt -= float(self._work[t])
        newly = []
        for c in self.dag.children[t]:
            self.pending_parents[c] -= 1
            if self.pending_parents[c] == 0 and c not in self.done:
                newly.append(int(c))
                self.runnable.add(int(c))
        return newly

    @property
    def complete(self) -> bool:
        return len(self.done) == self.dag.n
