"""The central scheduler process.

`SchedulerCore` is a synchronous, deterministic state machine over the
existing scheduling stack — `build_schedule`/`BuildService` for offline
construction, `TaskPool` + `ShardedMatcher` for online waves, and
`JobState` (shared with `ClusterSim`) for per-job DAG progress.  It
never reads a wall clock: every transition takes the caller's ``now``,
so a virtual-time driver replaying a simulator workload through it
produces **bit-identical placements and JCTs** to `ClusterSim`
(tests/test_service.py parity suite).  The parity-critical rules it
mirrors from the simulator's event loop:

  * the scheduler owns ``avail`` — agents never report float resource
    state over the wire, so there is nothing to drift;
  * a lease's effective duration is computed at grant time with the
    simulator's exact overload formula (`core.online.overload_factor`);
  * waves fire only when job/cluster state changed (submit, settle,
    requeue, rejoin) — exactly the simulator's match_all trigger set —
    and one pump settles every already-delivered completion before it
    waves, the simulator's drain-simultaneous-finishes rule.

Placements are **leases**: a grant is owed either a `task_done` or a
reclaim.  A machine silent past ``hb_lost_after`` is declared lost, its
leases are reclaimed and requeued (the simulator's suspicion/lost/rejoin
ladder, now driven by real agent heartbeats through the same
``heartbeat`` seam), and a `task_done` for a reclaimed lease is a
counted no-op — so every task has exactly one *effective* placement no
matter how the chaos plan interleaves crashes, partitions and
retransmissions.

`SchedulerService` is the process wrapper: it owns the listener, one
reliable `Channel` per connection, and routes wire messages into the
core.  ``pump`` is one synchronous step (drain every connection ->
apply -> check silence -> wave -> push new leases), callable either
from a virtual-time driver or from ``serve_in_thread`` on the wall
clock.

Device rule: `ServiceConfig.device` (default "cuda") is where the core's
kernel ops run — the builder's scan in ``_make_pri`` (inline or in the
build service's workers) and the heartbeat wave.  Asking for cuda
without a card raises when the core is made; "cpu" runs the kernels'
plain torch versions.  The device choice is per thread
(`kernels.use_device`), so the core owns it: it enters its device
around each wave, whichever thread pumps it, and hands it to every
build.  The fault plan, by contrast, is process-wide
(`faults.scope` sets one global), so the serving and agent threads see
the plan their caller scoped, as in the reference.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np

from ..core import faults
from ..core.baselines import bfs_order, cp_order, random_order
from ..core.builder import build_schedule
from ..core.buildsvc import BuildService
from ..core.dag import DAG, dag_digest
from ..core.engine import get_backend, kernels
from ..core.online import JobState, TaskPool, overload_factor
from ..core.shard import ShardedMatcher
from . import wire
from .comm import Channel, listen


@dataclasses.dataclass
class ServiceConfig:
    """Scheduler-service knobs (the SimConfig analogue)."""

    n_machines: int = 8
    d: int = 4
    seed: int = 0
    expose_per_job: int = 8
    build_machines: int | None = None
    placement_backend: str | None = None
    build_workers: int | None = 1   # >1/None -> BuildService worker pool
    matcher_shards: int | None = None
    schedule_cache: bool = True
    #: fairness groups known up front (the simulator derives them from
    #: the whole arrival list; a streaming service must be told)
    groups: tuple = (0,)
    #: agent heartbeat cadence and the silence ladder (sim defaults:
    #: suspected after 2.5 periods, declared lost after 5)
    heartbeat_period: float = 1.0
    hb_suspect_after: float | None = None
    hb_lost_after: float | None = None
    recovery: faults.RecoveryPolicy | None = None
    #: where the kernel ops run: "cuda" (raises without a card) or "cpu"
    device: str = "cuda"

    @property
    def suspect_after(self) -> float:
        return self.hb_suspect_after or 2.5 * self.heartbeat_period

    @property
    def lost_after(self) -> float:
        return self.hb_lost_after or 5.0 * self.heartbeat_period


@dataclasses.dataclass
class Lease:
    """One granted placement, owed a task_done or a reclaim."""

    lease_id: int
    job: int
    task: int
    machine: int
    t: float           # grant time
    expected: float    # effective duration at grant (overload-adjusted)


class SchedulerCore:
    """Deterministic scheduler state machine (no clock, no I/O)."""

    def __init__(self, cfg: ServiceConfig, spec):
        self.cfg = cfg
        self.spec = spec   # sim.cluster.SchemeSpec
        self.device = kernels.check_device(cfg.device)
        M, d = cfg.n_machines, cfg.d
        self.avail = np.ones((M, d), dtype=np.float64)
        self.registered = np.zeros(M, dtype=bool)
        self.suspected = np.zeros(M, dtype=bool)
        self.lost = np.zeros(M, dtype=bool)
        self.last_seen = np.zeros(M, dtype=np.float64)
        self.pool = TaskPool(d=d, expose=cfg.expose_per_job)
        shares = {g: 1.0 for g in cfg.groups}
        self.smatcher = ShardedMatcher(spec.matcher, M, shares,
                                       n_shards=cfg.matcher_shards,
                                       capacity=float(M),
                                       recovery=cfg.recovery)
        self.jobs: dict[int, JobState] = {}
        self.leases: dict[int, Lease] = {}
        self._lease_ids = itertools.count(1)
        self._job_ids = itertools.count()
        self._rng = np.random.default_rng(cfg.seed)
        self._dirty = False
        self.incomplete = 0
        self.placements: list[tuple[float, int, int, int]] = []
        #: (job, task) -> effective completions; the exactly-once
        #: invariant chaos tests assert (every value is exactly 1)
        self.effective: dict[tuple[int, int], int] = {}
        self.stats = {"submits": 0, "placements": 0, "completions": 0,
                      "lease_reclaims": 0, "stale_done": 0, "beats": 0,
                      "suspects": 0, "losses": 0, "rejoins": 0}
        self._pri_cache: dict[tuple, np.ndarray] = {}
        self._buildsvc: BuildService | None = None
        if spec.order_fn == "dagps" and (
                cfg.build_workers is None or cfg.build_workers > 1):
            self._buildsvc = BuildService(workers=cfg.build_workers,
                                          recovery=cfg.recovery,
                                          device=self.device)
        # degraded-mode accounting baselines (mirrors ClusterSim._run)
        ap = faults.active_plan()
        self._inj0 = ap.snapshot() if ap is not None else {}
        self._dem0 = kernels.demotions_snapshot()

    # -- offline construction (mirrors ClusterSim._make_pri) -----------

    def _build_m(self) -> int:
        return self.cfg.build_machines or max(self.cfg.n_machines // 10, 4)

    def _make_pri(self, dag: DAG) -> np.ndarray:
        kind = self.spec.order_fn
        if kind == "dagps":
            key = (dag_digest(dag), self._build_m(),
                   get_backend(self.cfg.placement_backend).name)
            if self.cfg.schedule_cache and key in self._pri_cache:
                return self._pri_cache[key]
            if self._buildsvc is not None:
                pri = self._buildsvc.submit(
                    dag, self._build_m(),
                    backend=self.cfg.placement_backend).result().pri_score
            else:
                pri = build_schedule(
                    dag, self._build_m(),
                    backend=self.cfg.placement_backend,
                    device=self.device).pri_score
            if self.cfg.schedule_cache:
                self._pri_cache[key] = pri
            return pri
        if kind == "bfs":
            order = bfs_order(dag)
        elif kind == "cp":
            order = cp_order(dag)
        else:
            order = random_order(dag, int(self._rng.integers(1 << 31)))
        rank = np.empty(dag.n)
        rank[order] = np.arange(dag.n)
        return 1.0 - rank / max(dag.n, 1)

    # -- transitions ----------------------------------------------------

    def register(self, machine: int, now: float) -> None:
        m = int(machine)
        self.registered[m] = True
        self.last_seen[m] = now
        self._dirty = True

    def submit(self, dag: DAG, group: int, now: float) -> int:
        job_id = next(self._job_ids)
        pri = self._make_pri(dag)
        job = JobState(job_id, dag, now, group, pri)
        self.jobs[job_id] = job
        self.pool.add_job(job_id, group, dag.demand, pri, job.runnable,
                          job.srpt)
        if not job.complete:
            self.incomplete += 1
        self.stats["submits"] += 1
        self._dirty = True
        return job_id

    def heartbeat(self, machine: int, t: float) -> None:
        """One beat reaches the scheduler (mirrors the sim's hb_arrive:
        stale/duplicate beats — retransmits, reorders — are no-ops via
        the monotone last_seen guard)."""
        m = int(machine)
        if not self.registered[m] or t <= self.last_seen[m]:
            return
        self.stats["beats"] += 1
        self.last_seen[m] = t
        if self.lost[m]:
            # rejoin on flap: fresh capacity again (its reclaimed tasks
            # may already run elsewhere under new leases)
            self.lost[m] = False
            self.suspected[m] = False
            self.avail[m] = 1.0
            self.stats["rejoins"] += 1
            self._dirty = True
        elif self.suspected[m]:
            self.suspected[m] = False
            self._dirty = True

    def task_done(self, lease_id: int, t: float) -> list[JobState]:
        """Settle one completion; returns jobs it retired.

        Exactly-once by construction: the channel's SeqGate already
        collapsed retransmits, and a reclaimed (requeued) lease is gone
        from the table — its late completion is a counted no-op, never a
        second effective placement.
        """
        lease = self.leases.pop(int(lease_id), None)
        if lease is None:
            self.stats["stale_done"] += 1
            return []
        key = (lease.job, lease.task)
        self.effective[key] = self.effective.get(key, 0) + 1
        job = self.jobs[lease.job]
        self.avail[lease.machine] += job.dag.demand[lease.task]
        was_runnable = lease.task in job.runnable
        if job.task_done(lease.task) or was_runnable:
            self.pool.mark_dirty(job.job_id)
        self.pool.set_srpt(job.job_id, job.srpt)
        self.stats["completions"] += 1
        self._dirty = True
        if job.complete and job.finish is None:
            job.finish = t
            self.pool.remove_job(job.job_id)
            self.incomplete -= 1
            return [job]
        return []

    def check_silence(self, now: float) -> list[Lease]:
        """Advance the suspicion/lost ladder; returns reclaimed leases
        (the service notifies their agents with revoke messages)."""
        reclaimed: list[Lease] = []
        lost_after, suspect_after = self.cfg.lost_after, self.cfg.suspect_after
        for m in np.flatnonzero(self.registered & ~self.lost):
            silent = now - self.last_seen[m]
            if silent + 1e-9 >= lost_after:
                self.lost[m] = True
                self.suspected[m] = True
                self.avail[m] = 0.0
                self.stats["losses"] += 1
                for lid, lease in list(self.leases.items()):
                    if lease.machine == m:
                        del self.leases[lid]
                        job = self.jobs[lease.job]
                        job.task_requeued(lease.task)
                        self.pool.mark_dirty(job.job_id)
                        self.stats["lease_reclaims"] += 1
                        reclaimed.append(lease)
                if reclaimed:
                    self._dirty = True
            elif silent + 1e-9 >= suspect_after and not self.suspected[m]:
                self.suspected[m] = True
                self.stats["suspects"] += 1
        return reclaimed

    def wave(self, now: float) -> list[Lease]:
        """One heartbeat wave, iff state changed since the last one —
        exactly the simulator's match_all trigger set, so healthy runs
        wave at identical times with identical pool/avail state."""
        if not self._dirty:
            return []
        self._dirty = False
        batch = self.pool.refresh()
        if batch is None or len(batch) == 0:
            return []
        matchable = self.registered & ~self.suspected & ~self.lost
        granted: list[Lease] = []

        def start_cb(gi: int, m: int) -> None:
            job = self.jobs[int(batch.job[gi])]
            tid = int(batch.tid[gi])
            self.avail[m] -= job.dag.demand[tid]
            expected = float(job.dag.duration[tid]) \
                * overload_factor(self.avail[m])
            lease = Lease(next(self._lease_ids), job.job_id, tid, int(m),
                          now, expected)
            self.leases[lease.lease_id] = lease
            job.task_started(tid)
            self.pool.mark_dirty(job.job_id)
            self.placements.append((now, job.job_id, tid, int(m)))
            self.stats["placements"] += 1
            granted.append(lease)

        with kernels.use_device(self.device):
            self.smatcher.match_wave(self.avail, matchable, batch, start_cb)
        return granted

    # -- accounting -----------------------------------------------------

    def fault_stats(self) -> dict:
        """SimResult.fault_stats-shaped accounting, behind the service
        API."""
        ap = faults.active_plan()
        inj1 = ap.snapshot() if ap is not None else {}
        dem1 = kernels.demotions_snapshot()
        sstats = self.smatcher.stats()
        return {
            "injections": {k: v - self._inj0.get(k, 0) for k, v in
                           inj1.items() if v - self._inj0.get(k, 0)},
            "shard": {k: sstats[k] for k in
                      ("launch_retries", "launch_failures", "quarantines",
                       "quarantined_shards", "quarantined_launches",
                       "probe_recoveries")},
            "build": {k: self._buildsvc.stats[k] for k in
                      ("retries", "worker_crashes", "quarantined_digests",
                       "inline_fallbacks", "resubmits", "resubmit_deduped")}
            if self._buildsvc is not None else {},
            "kernel_demotions": {k: v - self._dem0.get(k, 0)
                                 for k, v in dem1.items()
                                 if v - self._dem0.get(k, 0)},
            "heartbeat": {k: self.stats[k] for k in
                          ("beats", "suspects", "losses", "rejoins")},
            "service": {k: self.stats[k] for k in
                        ("submits", "placements", "completions",
                         "lease_reclaims", "stale_done")},
            "recovery_secs": round(
                self.smatcher.recovery_secs
                + (float(self._buildsvc.stats["recovery_secs"])
                   if self._buildsvc is not None else 0.0), 6),
        }

    def close(self) -> None:
        if self._buildsvc is not None:
            self._buildsvc.shutdown(wait=False)
        self.smatcher.close()


class SchedulerService:
    """Process wrapper: listener + per-connection reliable channels."""

    def __init__(self, core: SchedulerCore, addr: str = "inproc://sched",
                 clock=time.monotonic):
        self.core = core
        self._clock = clock
        self._lock = threading.Lock()
        self._conns: list[Channel] = []
        self._agents: dict[int, Channel] = {}
        #: job_id -> (client channel, client-side submission id)
        self._job_src: dict[int, tuple[Channel, int]] = {}
        self.listener = listen(addr, self._on_connect)
        self.addr = getattr(self.listener, "addr", addr)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _on_connect(self, comm) -> None:
        ch = Channel(comm, "sched", self.core.cfg.recovery, self._clock)
        with self._lock:
            self._conns.append(ch)

    # -- one synchronous step -------------------------------------------

    def pump(self, now: float | None = None) -> None:
        """Drain every connection, apply, check silence, wave, push."""
        now = self._clock() if now is None else now
        with self._lock:
            conns = list(self._conns)
        dones: list[tuple[int, float]] = []
        for ch in conns:
            for msg in ch.poll(now):
                if msg.kind == wire.TASK_DONE:
                    dones.append((int(msg.payload["lease"]),
                                  float(msg.payload["t"])))
                else:
                    self._handle(ch, msg, now)
        # settle completions in lease-grant order, not delivery order:
        # lease ids increase in grant (= simulator start) order, so float
        # accumulation (avail rows, per-job srpt) runs in the simulator's
        # finish-heap order no matter how connections/retransmits
        # interleaved the task_done messages — a parity requirement and
        # what makes settle order a pure function of the message *set*
        for lease_id, t in sorted(dones):
            for job in self.core.task_done(lease_id, t):
                src = self._job_src.get(job.job_id)
                if src is not None:
                    src[0].send(wire.JOB_DONE, sub=src[1], job=job.job_id,
                                group=job.group, arrival=job.arrival,
                                t=job.finish, n_tasks=job.dag.n)
        for lease in self.core.check_silence(now):
            ch = self._agents.get(lease.machine)
            if ch is not None:
                ch.send(wire.REVOKE, lease=lease.lease_id)
        for lease in self.core.wave(now):
            ch = self._agents.get(lease.machine)
            if ch is not None:
                ch.send(wire.PLACE, lease=lease.lease_id, job=lease.job,
                        task=lease.task, machine=lease.machine,
                        t=lease.t, expected=lease.expected)

    def _handle(self, ch: Channel, msg: wire.Msg, now: float) -> None:
        p = msg.payload
        if msg.kind == wire.HEARTBEAT:
            self.core.heartbeat(p["machine"], float(p["t"]))
        elif msg.kind == wire.REGISTER:
            m = int(p["machine"])
            self._agents[m] = ch
            self.core.register(m, float(p.get("t", now)))
        elif msg.kind == wire.SUBMIT:
            job_id = self.core.submit(p["dag"], int(p.get("group", 0)),
                                      float(p.get("t", now)))
            self._job_src[job_id] = (ch, int(p["sub"]))
        elif msg.kind == wire.STATS_REQ:
            fs = self.core.fault_stats()
            fs["comm"] = self.comm_stats()
            ch.cast(wire.STATS, fault_stats=fs, mutation_stats=None)

    # -- accounting -----------------------------------------------------

    def comm_stats(self) -> dict:
        """Comm/channel reliability counters, summed over connections."""
        agg = {"retransmits": 0, "acked": 0, "dups": 0, "reorders": 0,
               "sent": 0, "dropped": 0, "duped": 0, "delayed": 0}
        with self._lock:
            conns = list(self._conns)
        for ch in conns:
            agg["retransmits"] += ch.stats["retransmits"]
            agg["acked"] += ch.stats["acked"]
            agg["dups"] += ch.gate.stats["dups"]
            agg["reorders"] += ch.gate.stats["reorders"]
            for k in ("sent", "dropped", "duped", "delayed"):
                agg[k] += ch.comm.stats[k]
        return agg

    # -- wall-clock serving ---------------------------------------------

    def serve_in_thread(self, poll_interval: float = 0.005) -> None:
        def _loop():
            while not self._stop.is_set():
                self.pump()
                self._stop.wait(poll_interval)

        self._thread = threading.Thread(target=_loop, name="repro-sched",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.listener.close()
        with self._lock:
            conns = list(self._conns)
        for ch in conns:
            ch.close()
        self.core.close()
