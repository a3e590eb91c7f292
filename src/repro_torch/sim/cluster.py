"""Discrete-event cluster simulator (paper §8 experimental harness).

Simulates a cluster of machines with d-resource capacity, online job
arrivals, heartbeat-driven matching via `core.online.Matcher`, plus the
runtime artifacts the paper discusses:

  * stragglers (injected duration stretch) + speculative re-execution
    (the mitigation §2.3 corrects for),
  * machine failures with task re-queueing and rejoin (fault tolerance /
    elasticity at the cluster level),
  * implicit over-allocation slowdowns when a scheduler ignores some
    resource dims (Tez/CP only fit cores+memory -> network/disk overload,
    the Fig. 11 effect), and explicit bounded overbooking for DAGPS.

Scheme presets mirror §8.1's compared schemes.

The event loop runs on the vectorized online data path (see
docs/architecture.md): a persistent `TaskPool` replaces per-heartbeat
candidate rebuilds, heartbeat waves route through the sharded matcher
(`core/shard.py` — the exact mode runs each wave as one fused
``match_wave`` kernel launch, the routed mode one batched
`machines_with_candidates` eligibility launch per machine shard;
decisions are pinned to one global `Matcher` so any shard count is
bit-identical), run records
live in a SoA
`_RunTable` indexed by the heap's integer payloads, and offline builds are
memoized by DAG content digest — all bit-identical to the object-list
implementation this replaced.

Device rule: `SimConfig.device` (default "cuda") is where the kernel ops
run for the whole run — the builder's scan, the wave, the eligibility
filter.  Asking for cuda without a card raises; "cpu" runs the kernels'
plain torch versions.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Sequence

import numpy as np

from ..core import faults
from ..core.buildsvc import BuildService
from ..core.builder import build_schedule, rebuild_schedule
from ..core.baselines import bfs_order, cp_order, random_order
from ..core.dag import DAG, dag_digest
from ..core.engine import get_backend, kernels, packing
from ..core.online import (
    JobState,
    Matcher,
    MatcherConfig,
    TaskPool,
    drf_fairness,
    overload_factor,
    slot_fairness,
)
from ..core.shard import ShardedMatcher

# event codes (heap entries are (time, seq, code, int_arg) — payloads live in
# side tables indexed by the int arg, never in per-event tuples/dicts).
# _HB = a machine emits a heartbeat, _HBA = a delayed heartbeat arrives at
# the scheduler, _HBCHK = the scheduler checks a machine's silence deadline,
# _MUT = a scripted dynamic-DAG / machine-speed mutation fires
_ARRIVAL, _FINISH, _SPEC, _FAIL, _JOIN, _HB, _HBA, _HBCHK, _MUT = range(9)


class _RunTable:
    """SoA records of every launched task copy, indexed by run id.

    Replaces the per-run dict objects: `fail` events select a machine's
    live runs with one vectorized mask instead of scanning a dict, and
    `finish`/`spec` events index straight into the arrays.
    """

    def __init__(self, cap: int = 256):
        self.job = np.empty(cap, dtype=np.int64)
        self.task = np.empty(cap, dtype=np.int64)
        self.machine = np.empty(cap, dtype=np.int64)
        self.start = np.empty(cap, dtype=np.float64)
        self.expected = np.empty(cap, dtype=np.float64)
        self.dead = np.zeros(cap, dtype=bool)
        self.n = 0

    def append(self, job: int, task: int, machine: int, start: float,
               expected: float) -> int:
        if self.n == len(self.job):
            for name in ("job", "task", "machine", "start", "expected", "dead"):
                arr = getattr(self, name)
                grown = np.zeros(2 * len(arr), dtype=arr.dtype)
                grown[: len(arr)] = arr
                setattr(self, name, grown)
        rid = self.n
        self.job[rid] = job
        self.task[rid] = task
        self.machine[rid] = machine
        self.start[rid] = start
        self.expected[rid] = expected
        self.dead[rid] = False
        self.n += 1
        return rid

    def live_on(self, machine: int) -> np.ndarray:
        """Run ids alive on a machine, ascending (== launch order)."""
        return np.flatnonzero(~self.dead[: self.n]
                              & (self.machine[: self.n] == machine))


# Exact memo of offline construction: build_schedule is deterministic, so
# identical (DAG content, share, backend) triples yield identical priScore
# vectors (keyed by the canonical core.dag.dag_digest — the same digest
# the build service dedups on).  Benchmarks replay the same DAG
# population through several schemes/configs; caching makes every dagps
# build after the first free while leaving outputs bit-identical.
_PRI_CACHE: dict[tuple, np.ndarray] = {}
_PRI_CACHE_CAP = 1024


def clear_schedule_cache() -> None:
    """Drop the cross-run schedule cache (bench harnesses: makes repeat
    runs of one population pay construction again for honest timing)."""
    _PRI_CACHE.clear()


@dataclasses.dataclass
class SchemeSpec:
    name: str
    order_fn: str = "dagps"        # dagps | bfs | cp | random
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)


def scheme(name: str, **overrides) -> SchemeSpec:
    """Preset schemes from §8.1."""
    presets: dict[str, SchemeSpec] = {
        # Tez: breadth-first order on the Capacity Scheduler; knows cores+mem.
        "tez": SchemeSpec(
            "tez", "bfs",
            MatcherConfig(use_packing=False, use_srpt=False, use_overbooking=False,
                          fit_dims=(0, 1), kappa=0.02),
        ),
        "tez+cp": SchemeSpec(
            "tez+cp", "cp",
            MatcherConfig(use_packing=False, use_srpt=False, use_overbooking=False,
                          fit_dims=(0, 1), kappa=0.02),
        ),
        "tez+tetris": SchemeSpec(
            "tez+tetris", "bfs",
            MatcherConfig(use_packing=True, use_srpt=True, use_overbooking=False,
                          use_priority=False, kappa=10.0),  # Tetris: unbounded unfairness
        ),
        "tez+drf": SchemeSpec(
            "tez+drf", "bfs",
            MatcherConfig(use_packing=False, use_srpt=False, use_overbooking=False,
                          fit_dims=(0, 1), kappa=0.02, fairness=drf_fairness),
        ),
        "random": SchemeSpec(
            "random", "random",
            MatcherConfig(use_packing=False, use_srpt=False, use_overbooking=False,
                          kappa=10.0),
        ),
        "dagps": SchemeSpec("dagps", "dagps", MatcherConfig()),
        # ablation: DAGPS order without overbooking
        "dagps-noob": SchemeSpec(
            "dagps-noob", "dagps", MatcherConfig(use_overbooking=False)
        ),
    }
    spec = presets[name]
    if overrides:
        spec = dataclasses.replace(spec, matcher=dataclasses.replace(spec.matcher, **overrides))
    return spec


@dataclasses.dataclass
class SimConfig:
    n_machines: int = 50
    d: int = 4
    seed: int = 0
    expose_per_job: int = 8        # runnable tasks an AM exposes per heartbeat
    build_machines: int | None = None  # m for offline construction (job share)
    straggle_prob: float = 0.0
    straggle_factor: tuple[float, float] = (2.0, 5.0)
    speculate: bool = True
    spec_threshold: float = 1.8
    failure_rate: float = 0.0      # machine-failures per simulated second
    repair_time: float = 120.0
    record_usage: bool = False
    #: record every non-speculative placement as (t, job, task, machine)
    #: in SimResult.placements — the decision stream the service-parity
    #: suite compares bit-for-bit against an inproc scheduler-service run
    record_placements: bool = False
    placement_backend: str | None = None  # engine backend for offline builds
    schedule_cache: bool = True    # memoize identical offline builds (exact)
    #: dagps builds per arrival: 1 = serial in the arrival event; >1 or
    #: None (= host CPU count) submits every arrival's construction to a
    #: core.buildsvc.BuildService worker pool (on ``device``) at run start
    #: and the event loop consumes completed orders — bit-identical
    #: decisions (build_schedule is deterministic and construction is
    #: instantaneous in sim time), wall-clock overlapped
    build_workers: int | None = 1
    #: where the kernel ops run: "cuda" (raises without a card) or "cpu"
    device: str = "cuda"
    #: machine shards for the online matcher (core/shard.py): 1 = one
    #: flat shard; None = auto (ceil(n_machines / REPRO_SHARD_MACHINES,
    #: default 2048/shard)).  Any value yields bit-identical decisions —
    #: sharding changes only how eligibility launches are batched and how
    #: deficit ledgers are bookkept (merged + rebalanced every wave).
    matcher_shards: int | None = None
    #: online wave mode: "exact" (default) is the decision-exact global
    #: wave (`ShardedMatcher.match_wave`, dispatched through the fused
    #: ``match_wave`` kernel op); "routed" is the fully distributed
    #: per-shard wave (`match_wave_routed`) — an explicitly lossy preset:
    #: each shard's own matcher serves its machine slice from routed
    #: candidates, so decisions (and JCT/fairness) deviate from the exact
    #: path, while bounded unfairness survives via the wave-end deficit
    #: handoff.
    matcher_mode: str = "exact"
    profile: bool = False          # collect per-phase wall-clock timings
    #: heartbeat-loss modeling (None disables it — the seed behavior, in
    #: which matching waves are implicit and machines never go silent):
    #: machines emit a heartbeat every `heartbeat_period` sim-seconds; a
    #: machine silent for `hb_suspect_after` (default 2.5 periods) stops
    #: receiving new tasks (suspected), and one silent for `hb_lost_after`
    #: (default 5 periods) is declared lost — its running tasks requeue —
    #: until a later heartbeat gets through and it rejoins (flap-
    #: tolerant).  Distinct from `failure_rate` machine *failures*: a
    #: lost machine's work is intact but unreachable, the paper-level
    #: partition/GC-pause case.  Losses only occur when a `fault_plan`
    #: drops or delays heartbeats; healthy heartbeats are decision-
    #: neutral except for wave timing ties with the finish-drain loop.
    heartbeat_period: float | None = None
    hb_suspect_after: float | None = None
    hb_lost_after: float | None = None
    #: core.faults.FaultPlan (or its parse() spec string) installed for
    #: the duration of the run; None leaves any ambient plan (installed
    #: or REPRO_FAULTS) active
    fault_plan: object | None = None
    #: recovery knobs shared by the sharded matcher and build service
    recovery: faults.RecoveryPolicy | None = None
    #: scripted dynamics (core/dag.py mutation helpers): each entry is
    #: either ``(t, job_idx, mutator)`` — `mutator` maps the job's current
    #: DAG to ``(new_dag, DagDelta)``, applied mid-run if the job is
    #: running (delta rebuild replays untouched partitions) or swapped
    #: under the pending arrival otherwise — or ``(t, "speed", machine,
    #: factor)``, rescaling one machine's (None = every machine's)
    #: effective speed for tasks launched after ``t``.  A mutation whose
    #: touched tasks all finished already, or that targets a completed
    #: job, is counted as a no-op.  Empty/None = seed behavior, bit-exact.
    mutations: Sequence | None = None


@dataclasses.dataclass
class JobResult:
    job_id: int
    group: int
    arrival: float
    finish: float
    n_tasks: int

    @property
    def jct(self) -> float:
        return self.finish - self.arrival


@dataclasses.dataclass
class SimResult:
    jobs: list[JobResult]
    makespan: float
    usage_samples: list[tuple[float, np.ndarray]]
    allocations: list[tuple[float, float, int, float]]  # start, end, group, weight
    speculative_launches: int = 0
    failed_tasks_requeued: int = 0
    #: per-phase wall-clock seconds (build / match / event / total) when
    #: SimConfig.profile is set, else None
    phase_times: dict[str, float] | None = None
    #: sharded-matcher accounting (n_shards / waves / picks / handoffs /
    #: per-shard heartbeat-kernel seconds), always collected
    shard_stats: dict | None = None
    #: degraded-mode accounting, always collected: plan injections fired
    #: during the run, shard launch retries/quarantines, build service
    #: retries/crashes/fallbacks, kernel demotions, heartbeat-loss counts
    fault_stats: dict | None = None
    #: dynamic-DAG accounting when SimConfig.mutations is set, else None:
    #: mutation events applied/no-oped, delta vs full rebuild counts and
    #: the partition/placement reuse they achieved
    mutation_stats: dict | None = None
    #: (t, job, task, machine) per non-speculative launch when
    #: SimConfig.record_placements is set, else None
    placements: list[tuple[float, int, int, int]] | None = None

    def jcts(self) -> np.ndarray:
        return np.array([j.jct for j in self.jobs])

    def jain_index(self, window: float, shares: dict[int, float]) -> float:
        """Mean Jain's index of per-group usage over fixed windows (Table 4)."""
        if not self.allocations:
            return 1.0
        horizon = self.makespan
        total_share = sum(shares.values()) or 1.0
        idxs = []
        t = 0.0
        while t < horizon:
            hi = t + window
            usage = {g: 0.0 for g in shares}
            for (s, e, g, w) in self.allocations:
                ov = max(0.0, min(e, hi) - max(s, t))
                if ov > 0 and g in usage:
                    usage[g] += ov * w
            xs = np.array([usage[g] / (shares[g] / total_share) for g in shares])
            if xs.sum() > 0:
                idxs.append(float(xs.sum() ** 2 / (len(xs) * (xs ** 2).sum())))
            t = hi
        return float(np.mean(idxs)) if idxs else 1.0


# per-job DAG progress state lives in core.online.JobState
_Job = JobState


class ClusterSim:
    """Event-driven simulation of many DAG jobs under a scheme."""

    def __init__(self, cfg: SimConfig, spec: SchemeSpec):
        self.cfg = cfg
        self.spec = spec

    def _build_m(self) -> int:
        """m for offline construction (the job's cluster share)."""
        return self.cfg.build_machines or max(self.cfg.n_machines // 10, 4)

    def _pri_cache_key(self, dag: DAG) -> tuple:
        return (dag_digest(dag), self._build_m(),
                get_backend(self.cfg.placement_backend).name)

    # -- dynamic-DAG (mutations-scripted) schedule bookkeeping ---------

    def _count_rebuild(self, sched, dag: DAG) -> None:
        """Fold one (re)build's partition-reuse accounting into the run's
        mutation stats."""
        ms = self._mut_stats
        info = getattr(sched, "build_info", None)
        if info is None:
            ms["full_builds"] += 1
            return
        ms["delta_builds" if info.reused_parts else "full_builds"] += 1
        ms["parts_reused"] += int(info.reused_parts)
        ms["parts_total"] += int(info.total_parts or 1)
        ms["tasks_reused"] += int(info.reused_tasks)
        ms["tasks_total"] += int(dag.n)

    def _dyn_sched(self, dag: DAG, idx: int | None):
        """Schedule for an arriving job in a dynamic run.

        Dynamic runs bypass the pri-only cross-run cache: they must keep
        the full Schedule (its ``build_info`` carries the content-keyed
        partition map) so later mutations delta-rebuild instead of
        re-searching.  Digest-equal DAGs share one Schedule; a job whose
        DAG was mutated before arrival delta-rebuilds from its base
        digest's Schedule when one was built this run.
        """
        dig = dag_digest(dag)
        delta = self._predeltas.pop(idx, None)
        sched = self._by_digest.get(dig)
        if sched is None:
            handle = self._builds.pop(idx, None)
            if handle is not None:
                sched = handle.result()
            else:
                prev = (self._by_digest.get(delta.base_digest)
                        if delta is not None else None)
                if prev is not None and prev.build_info is not None:
                    sched = rebuild_schedule(
                        prev, dag, backend=self.cfg.placement_backend,
                        device=self.cfg.device)
                else:
                    sched = build_schedule(dag, self._build_m(),
                                           backend=self.cfg.placement_backend,
                                           device=self.cfg.device)
            if idx in self._mut_jobs:
                self._count_rebuild(sched, dag)
            self._by_digest[dig] = sched
        if idx is not None:
            self._scheds[idx] = sched
        return sched

    def _dyn_sched_mut(self, k: int, new_dag: DAG):
        """Re-plan job k after a mid-run mutation: delta rebuild from its
        retained Schedule when possible, full construction otherwise."""
        prev = self._scheds.get(k)
        if prev is not None and prev.build_info is not None:
            sched = rebuild_schedule(prev, new_dag,
                                     backend=self.cfg.placement_backend,
                                     device=self.cfg.device)
        else:
            sched = build_schedule(new_dag, self._build_m(),
                                   backend=self.cfg.placement_backend,
                                   device=self.cfg.device)
        self._count_rebuild(sched, new_dag)
        self._by_digest[dag_digest(new_dag)] = sched
        self._scheds[k] = sched
        return sched

    def _make_pri(self, dag: DAG, rng: np.random.Generator,
                  idx: int | None = None) -> np.ndarray:
        kind = self.spec.order_fn
        if kind == "dagps":
            if getattr(self, "_dynamic", False):
                return self._dyn_sched(dag, idx).pri_score
            use_cache = self.cfg.schedule_cache
            key = self._pri_cache_key(dag) if use_cache else None
            if use_cache:
                pri = _PRI_CACHE.get(key)
                if pri is not None:
                    return pri
            # prefetched by the build service at run start: consuming the
            # handle blocks only until that job's construction finishes —
            # later arrivals' builds keep running on the pool meanwhile
            handle = getattr(self, "_builds", {}).pop(idx, None)
            if handle is not None:
                pri = handle.result().pri_score
            else:
                pri = build_schedule(
                    dag, self._build_m(), backend=self.cfg.placement_backend,
                    device=self.cfg.device).pri_score
            if use_cache:
                if len(_PRI_CACHE) >= _PRI_CACHE_CAP:
                    _PRI_CACHE.pop(next(iter(_PRI_CACHE)))
                _PRI_CACHE[key] = pri
            return pri
        if kind == "bfs":
            order = bfs_order(dag)
        elif kind == "cp":
            order = cp_order(dag)
        else:
            order = random_order(dag, int(rng.integers(1 << 31)))
        rank = np.empty(dag.n)
        rank[order] = np.arange(dag.n)
        return 1.0 - rank / max(dag.n, 1)

    # ------------------------------------------------------------------
    def run(self, arrivals: Sequence[tuple[float, DAG, int]]) -> SimResult:
        with kernels.use_device(self.cfg.device):
            plan = faults.coerce(self.cfg.fault_plan)
            if plan is None:
                return self._run(arrivals)
            with faults.scope(plan):
                return self._run(arrivals)

    def _run(self, arrivals: Sequence[tuple[float, DAG, int]]) -> SimResult:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        M, d = cfg.n_machines, cfg.d
        avail = np.ones((M, d), dtype=np.float64)
        alive = np.ones(M, dtype=bool)
        groups = sorted({g for (_, _, g) in arrivals})
        shares = {g: 1.0 for g in groups}
        mcfg = self.spec.matcher
        if cfg.matcher_mode not in ("exact", "routed"):
            raise ValueError(f"unknown matcher_mode {cfg.matcher_mode!r}; "
                             "have ('exact', 'routed')")
        smatcher = ShardedMatcher(mcfg, M, shares,
                                  n_shards=cfg.matcher_shards,
                                  capacity=float(M),
                                  recovery=cfg.recovery)
        matcher = smatcher.matcher
        # degraded-mode accounting baselines (kernel demotions are sticky
        # process state; injection stats accumulate on a reused plan)
        ap = faults.active_plan()
        inj0 = ap.snapshot() if ap is not None else {}
        dem0 = kernels.demotions_snapshot()

        jobs: dict[int, _Job] = {}
        pool = TaskPool(d=d, expose=cfg.expose_per_job)
        counter = itertools.count()
        events: list[tuple[float, int, int, int]] = []
        for k, (t, _dag, _g) in enumerate(arrivals):
            heapq.heappush(events, (float(t), next(counter), _ARRIVAL, k))
        if cfg.failure_rate > 0:
            t_fail = float(rng.exponential(1.0 / cfg.failure_rate))
            heapq.heappush(events, (t_fail, next(counter), _FAIL, 0))

        # scripted dynamics (SimConfig.mutations).  DAG mutations make the
        # run "dynamic": dagps jobs keep their full Schedule (not just the
        # pri vector) so mutations delta-rebuild, and the cross-run pri
        # cache is bypassed.  `speed` is the sim-level machine-speed edit:
        # 1.0 everywhere is bit-exact seed behavior (never divided by).
        muts = list(cfg.mutations or ())
        self._dynamic = any(
            not (len(mu) > 1 and mu[1] == "speed") for mu in muts)
        self._by_digest: dict[bytes, object] = {}
        self._scheds: dict[int, object] = {}
        self._predeltas: dict[int, object] = {}
        self._mut_jobs: set[int] = set()
        mut_stats = {"events": 0, "applied": 0, "noops": 0, "pre_arrival": 0,
                     "speed_changes": 0, "delta_builds": 0, "full_builds": 0,
                     "parts_reused": 0, "parts_total": 0,
                     "tasks_reused": 0, "tasks_total": 0}
        self._mut_stats = mut_stats
        speed = np.ones(M, dtype=np.float64)
        if muts:
            arrivals = list(arrivals)   # pre-arrival mutations swap entries
            for i, mu in enumerate(muts):
                heapq.heappush(events, (float(mu[0]), next(counter), _MUT, i))

        # heartbeat-loss state (disabled by default: no events scheduled,
        # no rng consumed, both masks stay all-False — bit-identical to
        # the implicit-heartbeat seed behavior)
        hb_period = cfg.heartbeat_period
        hb_on = hb_period is not None and hb_period > 0
        suspected = np.zeros(M, dtype=bool)
        hb_lost = np.zeros(M, dtype=bool)
        hb_stats = {"beats": 0, "dropped": 0, "delayed": 0, "suspects": 0,
                    "losses": 0, "rejoins": 0, "requeued": 0,
                    "forced_rejoins": 0}
        if hb_on:
            hb_suspect = cfg.hb_suspect_after or 2.5 * hb_period
            hb_lost_after = cfg.hb_lost_after or 5.0 * hb_period
            last_seen = np.zeros(M, dtype=np.float64)
            beat_no = np.zeros(M, dtype=np.int64)
            hb_forced = np.zeros(M, dtype=bool)
            for m in range(M):
                heapq.heappush(events, (hb_period, next(counter), _HB, m))
                # arm the silence check up front: a machine whose beats
                # never arrive at all must still be detected
                heapq.heappush(events, (hb_suspect, next(counter), _HBCHK, m))

        runs = _RunTable()
        task_active: dict[tuple[int, int], list[int]] = {}  # (job,task) -> run_ids
        results: list[JobResult] = []
        usage_samples: list[tuple[float, np.ndarray]] = []
        allocations: list[tuple[float, float, int, float]] = []
        placements: list[tuple[float, int, int, int]] | None = \
            [] if cfg.record_placements else None
        spec_launches = 0
        requeued = 0
        pending_arrivals = len(arrivals)
        incomplete_jobs = 0
        t_now = 0.0
        prof = {"build": 0.0, "match": 0.0} if cfg.profile else None
        t_run0 = time.perf_counter() if cfg.profile else 0.0
        # heartbeat-kernel accounting: seconds spent inside the dispatched
        # heartbeat eligibility ops (a subset of the match phase), so the
        # bench rows can attribute matcher time to the kernel layer
        kprof0 = kernels.profile_snapshot() if cfg.profile else None

        def timed(key, fn, *args):
            if prof is None:
                return fn(*args)
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                prof[key] += time.perf_counter() - t0

        def start_task(job: _Job, tid: int, m: int, now: float, speculative: bool = False) -> None:
            nonlocal spec_launches
            dem = job.dag.demand[tid]
            avail[m] -= dem
            base = float(job.dag.duration[tid])
            dur = base
            if not speculative and cfg.straggle_prob > 0 and rng.random() < cfg.straggle_prob:
                lo, hi = cfg.straggle_factor
                dur = base * float(rng.uniform(lo, hi))
            # implicit/explicit overload on fungible dims slows this task down
            dur_eff = dur * overload_factor(avail[m])
            if speed[m] != 1.0:   # machine-speed mutations: future launches
                dur_eff = dur_eff / speed[m]
            rid = runs.append(job.job_id, tid, m, now, base)
            task_active.setdefault((job.job_id, tid), []).append(rid)
            if not speculative:
                job.task_started(tid)
                pool.mark_dirty(job.job_id)
                if placements is not None:
                    placements.append((now, job.job_id, tid, m))
            else:
                spec_launches += 1
            heapq.heappush(events, (now + dur_eff, next(counter), _FINISH, rid))
            if cfg.speculate and not speculative:
                chk = now + cfg.spec_threshold * base
                heapq.heappush(events, (chk, next(counter), _SPEC, rid))
            allocations.append((now, now + dur_eff, job.group, float(np.abs(dem).sum())))

        def free_run(rid: int) -> None:
            if not runs.dead[rid]:
                runs.dead[rid] = True
                avail[runs.machine[rid]] += \
                    jobs[int(runs.job[rid])].dag.demand[runs.task[rid]]

        def requeue_machine(m: int) -> int:
            """Kill every live run on a machine and requeue its tasks
            (shared by hard failures and declared heartbeat losses)."""
            cnt = 0
            for rid in runs.live_on(m):
                rid = int(rid)
                free_run(rid)
                job = jobs[int(runs.job[rid])]
                job.task_requeued(int(runs.task[rid]))
                pool.mark_dirty(job.job_id)
                cnt += 1
            return cnt

        def settle_finish(rid: int, now: float) -> None:
            """One task-copy completion: free it, kill speculative siblings,
            advance the DAG, retire the job when done."""
            nonlocal incomplete_jobs
            job = jobs[int(runs.job[rid])]
            tid = int(runs.task[rid])
            free_run(rid)
            for sib in task_active.get((job.job_id, tid), ()):
                if sib != rid and not runs.dead[sib]:
                    free_run(sib)
            # exposure only depends on the runnable set: task_done changes
            # it when it unlocks children OR when the task was requeued
            # (machine failure) and a surviving speculative copy finished —
            # then task_done itself pulls it back out of runnable.  srpt
            # always moves; the pool patches that one column without
            # re-sorting clean jobs.
            was_runnable = tid in job.runnable
            if job.task_done(tid) or was_runnable:
                pool.mark_dirty(job.job_id)
            pool.set_srpt(job.job_id, job.srpt)
            if job.complete and job.finish is None:
                job.finish = now
                results.append(JobResult(job.job_id, job.group, job.arrival,
                                         now, job.dag.n))
                pool.remove_job(job.job_id)
                incomplete_jobs -= 1

        def matchable() -> np.ndarray:
            """Machines a wave may serve: alive, and (with heartbeats on)
            neither suspected nor declared lost."""
            if not hb_on:
                return alive
            return alive & ~suspected & ~hb_lost

        def match_machine(m: int, now: float) -> None:
            if not alive[m] or suspected[m] or hb_lost[m]:
                return
            batch = pool.refresh()
            if batch is None or len(batch) == 0:
                return
            picks = matcher.match_batch(m, avail[m], batch)
            for i, _over in picks:
                start_task(jobs[int(batch.job[i])], int(batch.tid[i]), m, now)
                smatcher.record_allocation(m, int(batch.grp[i]),
                                           mcfg.fairness(batch.dem[i]))

        # concurrent multi-job construction (core/buildsvc.py): submit every
        # arrival's build up front and let the event loop consume completed
        # priority orders — per-job builds are independent (own DAG, Space,
        # memo) and build_schedule is deterministic, so decisions stay
        # bit-identical to the serial path; only wall-clock overlap changes.
        svc = None
        self._builds = {}
        if self.spec.order_fn == "dagps" and (
                cfg.build_workers is None or cfg.build_workers > 1):
            svc = BuildService(workers=cfg.build_workers,
                               recovery=cfg.recovery, device=cfg.device)
            m_build = self._build_m()
            for k, (_t, dag, _g) in enumerate(arrivals):
                # dynamic runs prefetch everything (the pri cache is
                # bypassed; the service dedups identical DAGs itself)
                if (cfg.schedule_cache and not self._dynamic
                        and self._pri_cache_key(dag) in _PRI_CACHE):
                    continue
                self._builds[k] = svc.submit(
                    dag, m_build, backend=cfg.placement_backend)

        def hb_arrive(m: int, now: float) -> None:
            """One heartbeat reaches the scheduler: refresh the machine's
            silence clock, rejoin it if suspected/lost, arm the next
            silence check."""
            if not alive[m] or now <= last_seen[m]:
                return                      # dead machine / stale delayed beat
            last_seen[m] = now
            if hb_lost[m]:
                # rejoin on flap: the machine is fresh capacity again (its
                # requeued tasks may already be running elsewhere)
                hb_lost[m] = False
                suspected[m] = False
                avail[m] = 1.0
                hb_stats["rejoins"] += 1
                timed("match", match_machine, m, now)
            elif suspected[m]:
                suspected[m] = False
                timed("match", match_machine, m, now)
            heapq.heappush(events, (now + hb_suspect, next(counter),
                                    _HBCHK, m))

        def match_all(now: float) -> None:
            batch = pool.refresh()
            if batch is None or len(batch) == 0:
                return
            # one heartbeat wave through the sharded matcher: the exact
            # mode pins decisions to the single global matcher (the wave
            # dispatches through the fused match_wave kernel op and is
            # bit-identical for any shard count and implementation); the
            # routed mode is the distributed lossy preset.  Either way the
            # pick stream is consumed through start_task via start_cb.
            wave = (smatcher.match_wave_routed
                    if cfg.matcher_mode == "routed" else smatcher.match_wave)
            wave(avail, matchable(), batch,
                 lambda gi, m: start_task(jobs[int(batch.job[gi])],
                                          int(batch.tid[gi]), m, now))

        def mutate_job(k: int, mutator, now: float) -> None:
            """Apply one scripted DAG mutation (a core.dag helper curried
            over its arguments) to job k and repair its schedule."""
            nonlocal incomplete_jobs
            job = jobs.get(k)
            if job is None:
                # pre-arrival: swap the DAG under the pending arrival; a
                # prefetched construction is resubmitted as a delta so the
                # worker pool replays the old build's untouched partitions;
                # without one the arrival delta-rebuilds from the old DAG's
                # schedule
                t_a, old_dag, g = arrivals[k]
                new_dag, delta = mutator(old_dag)
                arrivals[k] = (t_a, new_dag, g)
                self._predeltas[k] = delta
                self._mut_jobs.add(k)
                mut_stats["pre_arrival"] += 1
                h = self._builds.get(k)
                if svc is not None and h is not None:
                    self._builds[k] = svc.resubmit(h, new_dag, delta)
                return
            if job.complete:
                mut_stats["noops"] += 1
                return
            new_dag, delta = mutator(job.dag)
            old_n = job.dag.n
            idm = delta.id_map
            identity = new_dag.n == old_n and bool(
                np.array_equal(idm, np.arange(old_n)))
            if identity and len(delta.touched) and all(
                    int(x) in job.done for x in delta.touched):
                # every touched task already finished — re-prioritizing
                # completed work cannot change any remaining decision
                mut_stats["noops"] += 1
                return
            for x in np.flatnonzero(idm < 0):
                if int(x) in job.running:
                    raise ValueError(
                        f"mutation drops running task {int(x)} of job {k}")
            # re-plan: delta rebuild from the retained Schedule when the
            # scheme builds one, else recompute the baseline order
            if self.spec.order_fn == "dagps":
                pri = self._dyn_sched_mut(k, new_dag).pri_score
            else:
                pri = self._make_pri(new_dag, rng)
            # remap live state through the delta's id map, then rebuild
            # the derived per-job arrays against the new graph
            if not identity:
                sel = np.flatnonzero(runs.job[: runs.n] == k)
                runs.task[sel] = idm[runs.task[sel]]  # dead dropped -> -1
                for key in [key for key in task_active if key[0] == k]:
                    lst = task_active.pop(key)
                    nt = int(idm[key[1]])
                    if nt >= 0:
                        task_active[(k, nt)] = lst
                job.done = {int(idm[x]) for x in job.done if idm[x] >= 0}
                job.running = {int(idm[x]) for x in job.running}
            job.dag = new_dag
            job.pri = pri
            job._work = new_dag.duration * np.abs(new_dag.demand).sum(axis=1)
            job.pending_parents = np.array(
                [sum(1 for p in new_dag.parents[i] if int(p) not in job.done)
                 for i in range(new_dag.n)])
            job.runnable = {i for i in range(new_dag.n)
                            if i not in job.done and i not in job.running
                            and job.pending_parents[i] == 0}
            mask = np.ones(new_dag.n, dtype=bool)
            if job.done:
                mask[list(job.done)] = False
            job.srpt = float(job._work[mask].sum())
            mut_stats["applied"] += 1
            pool.remove_job(k)
            if job.complete and job.finish is None:
                # a shrink can retire the job outright
                job.finish = now
                results.append(JobResult(k, job.group, job.arrival, now,
                                         new_dag.n))
                incomplete_jobs -= 1
                return
            pool.add_job(k, job.group, new_dag.demand, pri, job.runnable,
                         job.srpt)
            match_all(now)

        try:
            while events:
                t_now, _, kind, arg = heapq.heappop(events)
                if kind == _ARRIVAL:
                    _t_arr, dag, g = arrivals[arg]
                    pri = timed("build", self._make_pri, dag, rng, arg)
                    job = _Job(arg, dag, t_now, g, pri)
                    jobs[arg] = job
                    pool.add_job(arg, g, dag.demand, pri, job.runnable, job.srpt)
                    pending_arrivals -= 1
                    if not job.complete:    # zero-task jobs never finish events
                        incomplete_jobs += 1
                    timed("match", match_all, t_now)
                elif kind == _FINISH:
                    if runs.dead[arg]:
                        continue
                    settle_finish(arg, t_now)
                    if cfg.record_usage:
                        usage_samples.append((t_now, (1.0 - avail[alive]).sum(axis=0)))
                    # drain simultaneous finishes before re-matching
                    while events and events[0][2] == _FINISH and events[0][0] <= t_now + 1e-9:
                        _, _, _, rid2 = heapq.heappop(events)
                        if runs.dead[rid2]:
                            continue
                        settle_finish(rid2, t_now)
                    timed("match", match_all, t_now)
                elif kind == _SPEC:
                    if runs.dead[arg]:
                        continue
                    job = jobs[int(runs.job[arg])]
                    tid = int(runs.task[arg])
                    # only speculate if some machine can host a copy right now
                    dem = job.dag.demand[tid]
                    fit = np.nonzero(matchable() & packing.fits_mask(avail, dem))[0]
                    if len(fit):
                        start_task(job, tid, int(fit[0]), t_now, speculative=True)
                elif kind == _FAIL:
                    m = int(rng.integers(M))
                    if alive[m]:
                        alive[m] = False
                        requeued += requeue_machine(m)
                        avail[m] = 0.0
                        heapq.heappush(events, (t_now + cfg.repair_time,
                                                next(counter), _JOIN, m))
                    if cfg.failure_rate > 0 and (incomplete_jobs > 0
                                                 or pending_arrivals > 0):
                        nxt = t_now + float(rng.exponential(1.0 / cfg.failure_rate))
                        heapq.heappush(events, (nxt, next(counter), _FAIL, 0))
                elif kind == _JOIN:
                    alive[arg] = True
                    avail[arg] = 1.0
                    timed("match", match_machine, arg, t_now)
                elif kind == _MUT:
                    mu = muts[arg]
                    mut_stats["events"] += 1
                    if len(mu) > 1 and mu[1] == "speed":
                        _t_mu, _sp, mm, factor = mu
                        if mm is None:
                            speed[:] = float(factor)
                        else:
                            speed[int(mm)] = float(factor)
                        mut_stats["speed_changes"] += 1
                    else:
                        timed("build", mutate_job, int(mu[1]), mu[2], t_now)
                elif kind == _HB:
                    m = arg
                    beat = int(beat_no[m])
                    beat_no[m] += 1
                    if incomplete_jobs == 0 and pending_arrivals == 0:
                        continue        # workload done: drain the clock
                    hb_stats["beats"] += 1
                    force = False
                    if (pending_arrivals == 0
                            and not (~runs.dead[:runs.n]).any()
                            and not any(ev[2] not in (_HB, _HBA, _HBCHK)
                                        for ev in events)):
                        # nothing running, nothing arriving, nothing ahead
                        # but heartbeats: only a machine recovery can still
                        # unblock the workload.
                        if matchable().all():
                            # every machine already serves, so no beat can
                            # change state — stop the clock; like the
                            # no-heartbeat path, unplaceable work ends the
                            # run with those jobs unfinished
                            continue
                        # some machine is unreachable: force its beats
                        # through even if the plan would swallow them (the
                        # operator-intervention analogue), so partitioned
                        # clusters always recover and the sim terminates
                        force = True
                    heapq.heappush(events, (t_now + hb_period,
                                            next(counter), _HB, m))
                    if not alive[m]:
                        continue        # hard-failed machines emit nothing
                    sp = None if hb_forced[m] \
                        else faults.query("heartbeat", machine=m, beat=beat)
                    if sp is not None and force:
                        # sticky: a forced machine's link counts as repaired
                        # — without this, re-losing it before any task
                        # longer than hb_lost_after completes would
                        # livelock a fully partitioned cluster
                        hb_forced[m] = True
                        hb_stats["forced_rejoins"] += 1
                        sp = None
                    if sp is None:
                        hb_arrive(m, t_now)
                    elif sp.kind == "delay":
                        hb_stats["delayed"] += 1
                        heapq.heappush(events,
                                       (t_now + max(sp.delay, 0.0),
                                        next(counter), _HBA, m))
                    else:               # drop (and any other kind)
                        hb_stats["dropped"] += 1
                elif kind == _HBA:
                    hb_arrive(arg, t_now)
                elif kind == _HBCHK:
                    m = arg
                    if incomplete_jobs == 0 and pending_arrivals == 0:
                        continue    # workload done: silence is expected
                    if not alive[m] or hb_lost[m]:
                        continue
                    silent = t_now - last_seen[m]
                    if silent + 1e-9 >= hb_lost_after:
                        # declared lost: unreachable, not dead — requeue
                        # its work and stop counting its capacity until a
                        # heartbeat gets through again
                        hb_lost[m] = True
                        suspected[m] = True
                        n_req = requeue_machine(m)
                        hb_stats["requeued"] += n_req
                        hb_stats["losses"] += 1
                        avail[m] = 0.0
                        if n_req:
                            timed("match", match_all, t_now)
                    elif silent + 1e-9 >= hb_suspect:
                        if not suspected[m]:
                            suspected[m] = True
                            hb_stats["suspects"] += 1
                        heapq.heappush(events,
                                       (last_seen[m] + hb_lost_after,
                                        next(counter), _HBCHK, m))

        finally:
            self._by_digest = {}
            self._builds = {}
            self._scheds = {}
            self._predeltas = {}
            smatcher.close()
            if svc is not None:
                svc.shutdown(wait=False)
        makespan = max((j.finish for j in results), default=0.0)
        # recovery seconds: shard-launch retries/backoff accrue inside the
        # match phase, build-retry backoff inside the build phase — pull
        # both out into their own key so degraded runs don't silently
        # inflate the phases they happen to block
        rec_shard = smatcher.recovery_secs
        rec_build = float(svc.stats["recovery_secs"]) if svc is not None \
            else 0.0
        phase_times = None
        if prof is not None:
            total = time.perf_counter() - t_run0
            build_t = max(prof["build"] - rec_build, 0.0)
            match_t = max(prof["match"] - rec_shard, 0.0)
            phase_times = {"build": build_t, "match": match_t,
                           "recovery": rec_shard + rec_build,
                           "event": max(total - prof["build"] - prof["match"], 0.0),
                           "total": total}
            kprof1 = kernels.profile_snapshot()
            # seconds inside the dispatched heartbeat eligibility ops
            hb = sum(sec - kprof0.get(key, (0, 0.0))[1]
                     for key, (_calls, sec) in kprof1.items()
                     if key.startswith(("machines_with_candidates.",
                                        "heartbeat_masks.")))
            phase_times["heartbeat"] = hb
        sstats = smatcher.stats()
        ap1 = faults.active_plan()
        inj1 = ap1.snapshot() if ap1 is not None else {}
        dem1 = kernels.demotions_snapshot()
        fault_stats = {
            "injections": {k: v - inj0.get(k, 0) for k, v in inj1.items()
                           if v - inj0.get(k, 0)},
            "shard": {k: sstats[k] for k in
                      ("launch_retries", "launch_failures", "quarantines",
                       "quarantined_shards", "quarantined_launches",
                       "probe_recoveries")},
            "build": {k: svc.stats[k] for k in
                      ("retries", "worker_crashes", "quarantined_digests",
                       "inline_fallbacks", "resubmits", "resubmit_deduped")}
            if svc is not None else {},
            "kernel_demotions": {k: v - dem0.get(k, 0)
                                 for k, v in dem1.items()
                                 if v - dem0.get(k, 0)},
            "heartbeat": hb_stats,
            "recovery_secs": round(rec_shard + rec_build, 6),
        }
        return SimResult(results, makespan, usage_samples, allocations,
                         spec_launches, requeued, phase_times,
                         sstats, fault_stats,
                         mut_stats if muts else None,
                         placements)


def run_workload(
    dags: Sequence[DAG],
    scheme_name: str,
    n_machines: int = 50,
    interarrival: float = 25.0,
    n_groups: int = 1,
    seed: int = 0,
    device: str = "cuda",
    **cfg_overrides,
) -> SimResult:
    """Poisson arrivals (§8.1: avg 25s apart), even group assignment.

    ``device`` is where the kernel ops run ("cuda" raises without a card;
    "cpu" runs their plain torch versions)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    arrivals = []
    for k, dag in enumerate(dags):
        arrivals.append((t, dag, k % n_groups))
        t += float(rng.exponential(interarrival))
    sim_fields = {f.name for f in dataclasses.fields(SimConfig)}
    matcher_fields = {f.name for f in dataclasses.fields(MatcherConfig)}
    sim_kwargs = {k: v for k, v in cfg_overrides.items() if k in sim_fields}
    matcher_kwargs = {k: v for k, v in cfg_overrides.items() if k in matcher_fields}
    unknown = set(cfg_overrides) - sim_fields - matcher_fields
    if unknown:
        raise TypeError(f"unknown overrides: {unknown}")
    cfg = SimConfig(n_machines=n_machines, seed=seed, device=device,
                    **sim_kwargs)
    return ClusterSim(cfg, scheme(scheme_name, **matcher_kwargs)).run(arrivals)
