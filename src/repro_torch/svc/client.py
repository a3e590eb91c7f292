"""Client API + the virtual-time workload driver.

`Client` is the streaming submission handle: ``submit(dag) -> handle``
over a reliable channel, completions delivered as ``job_done`` messages,
and ``fault_stats``/``mutation_stats`` fetchable over the wire, as
`SimResult` carries them for the simulator.

`run_service_workload` replays a simulator workload — the same
``(t, dag, group)`` arrival list `ClusterSim.run` takes — through a real
inproc service: one `SchedulerService`, one `VirtualAgent` per machine,
one `Client`, all stepped by a single virtual-time event heap that
mirrors the simulator's (arrival events first, then per-machine
heartbeat clocks; simultaneous completions drain as one batch before the
wave).  On a healthy run the resulting placements and JCTs are
bit-identical to `ClusterSim` (tests/test_service.py locks this with a
golden); under a chaos plan the run instead asserts liveness — every
job completes, each task exactly once.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time

import numpy as np

from ..core import faults
from ..sim.cluster import JobResult
from . import wire
from .agent import VirtualAgent
from .comm import Channel, connect
from .scheduler import SchedulerCore, SchedulerService, ServiceConfig

_RUN_IDS = itertools.count()


class JobHandle:
    """One submission: filled in when its job_done arrives."""

    def __init__(self, sub: int):
        self.sub = sub
        self.job_id: int | None = None
        self.result: JobResult | None = None

    @property
    def done(self) -> bool:
        return self.result is not None


class Client:
    """Streaming submission client over one comm."""

    def __init__(self, comm, name: str = "client",
                 recovery: faults.RecoveryPolicy | None = None,
                 clock=time.monotonic):
        self.ch = Channel(comm, name, recovery, clock)
        self._sub_ids = itertools.count()
        self._subs: dict[int, JobHandle] = {}
        self._stats: list[dict] = []

    def submit(self, dag, group: int = 0, t: float = 0.0) -> JobHandle:
        handle = JobHandle(next(self._sub_ids))
        self._subs[handle.sub] = handle
        self.ch.send(wire.SUBMIT, sub=handle.sub, dag=dag, group=group, t=t)
        return handle

    def poll(self, now: float | None = None) -> list[JobHandle]:
        """Drain the channel; returns handles that just completed."""
        finished = []
        for msg in self.ch.poll(now):
            p = msg.payload
            if msg.kind == wire.JOB_DONE:
                handle = self._subs[int(p["sub"])]
                handle.job_id = int(p["job"])
                handle.result = JobResult(int(p["job"]), int(p["group"]),
                                          float(p["arrival"]), float(p["t"]),
                                          int(p["n_tasks"]))
                finished.append(handle)
            elif msg.kind == wire.STATS:
                self._stats.append(p)
        return finished

    @property
    def pending(self) -> int:
        return sum(1 for h in self._subs.values() if not h.done)

    def request_stats(self) -> None:
        self.ch.cast(wire.STATS_REQ)

    def take_stats(self) -> dict | None:
        return self._stats.pop() if self._stats else None

    def stats(self, timeout: float = 5.0, poll_interval: float = 0.01,
              sleep=time.sleep) -> dict:
        """Blocking wall-clock stats fetch (service must be serving)."""
        self.request_stats()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll()
            got = self.take_stats()
            if got is not None:
                return got
            sleep(poll_interval)
        raise TimeoutError("no stats reply from scheduler service")


@dataclasses.dataclass
class ServiceResult:
    """`SimResult`'s service twin (same jcts()/jobs shape the bench and
    example harnesses consume)."""

    jobs: list[JobResult]
    makespan: float
    placements: list[tuple[float, int, int, int]]
    fault_stats: dict | None = None
    mutation_stats: dict | None = None
    #: (job, task) -> effective completion count (chaos invariant: all 1)
    effective: dict | None = None
    phase_times: dict | None = None   # parity with SimResult consumers

    def jcts(self) -> np.ndarray:
        return np.array([j.jct for j in self.jobs])


class _VClock:
    """Mutable virtual clock shared by every channel in a driven run."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# driver event codes, mirroring the simulator's heap discipline:
# arrivals pushed first at init (so they outrank same-time runtime
# events), completions drain as a batch, heartbeats tick per machine
_ARR, _DONE, _HB, _HBA = range(4)


def run_service_workload(arrivals, cfg: ServiceConfig, spec,
                         fault_plan=None, addr: str | None = None,
                         max_steps: int = 2_000_000) -> ServiceResult:
    """Replay a simulator arrival list through an inproc service run.

    ``spec`` is a `sim.cluster.SchemeSpec` (use `sim.cluster.scheme`).
    Healthy runs are decision-parity territory: configure the matching
    `SimConfig` with ``speculate=False`` and the same seed/machines/
    shards/device, and placements + JCTs match `ClusterSim` bit-for-bit.
    The run's kernel ops go to ``cfg.device`` ("cuda" by default; raises
    without a card).
    """
    plan = faults.coerce(fault_plan)
    if plan is None:
        return _run(arrivals, cfg, spec, addr, max_steps)
    with faults.scope(plan):
        return _run(arrivals, cfg, spec, addr, max_steps)


def _run(arrivals, cfg: ServiceConfig, spec, addr, max_steps):
    arrivals = list(arrivals)
    groups = tuple(sorted({g for (_, _, g) in arrivals})) or (0,)
    if tuple(cfg.groups) != groups:
        cfg = dataclasses.replace(cfg, groups=groups)
    vt = _VClock()
    addr = addr or f"inproc://svc-run-{next(_RUN_IDS)}"
    core = SchedulerCore(cfg, spec)
    svc = SchedulerService(core, addr, clock=vt)
    try:
        agents = [VirtualAgent(m, connect(addr), cfg.recovery, clock=vt)
                  for m in range(cfg.n_machines)]
        for a in agents:
            a.register(0.0)
        client = Client(connect(addr), recovery=cfg.recovery, clock=vt)
        svc.pump(0.0)

        counter = itertools.count()
        events: list[tuple[float, int, int, object]] = []
        for k, (t, _dag, _g) in enumerate(arrivals):
            heapq.heappush(events, (float(t), next(counter), _ARR, k))
        period = cfg.heartbeat_period
        for m in range(cfg.n_machines):
            heapq.heappush(events, (period, next(counter), _HB, m))

        handles: dict[int, JobHandle] = {}
        results: list[JobResult] = []
        n_jobs = len(arrivals)
        steps = 0
        while events and len(results) < n_jobs:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"service workload did not complete in {max_steps} "
                    f"steps ({len(results)}/{n_jobs} jobs done)")
            t_now, _, code, arg = heapq.heappop(events)
            vt.t = t_now
            if code == _ARR:
                t_a, dag, g = arrivals[arg]
                handles[arg] = client.submit(dag, group=g, t=t_now)
            elif code == _DONE:
                m, lease = arg
                agents[m].complete(lease, t_now)
                # drain simultaneous completions before the wave — the
                # simulator's finish-drain rule (stop at the first
                # non-completion event, exactly like its heap scan)
                while events and events[0][2] == _DONE \
                        and events[0][0] <= t_now + 1e-9:
                    _, _, _, arg2 = heapq.heappop(events)
                    m2, lease2 = arg2
                    agents[m2].complete(lease2, t_now)
            elif code == _HB:
                delayed = agents[arg].heartbeat(t_now)
                if delayed is not None:
                    heapq.heappush(events, (delayed[1], next(counter),
                                            _HBA, arg))
                heapq.heappush(events, (t_now + period, next(counter),
                                        _HB, arg))
            elif code == _HBA:
                agents[arg].send_beat(t_now)
            svc.pump(t_now)
            for a in agents:
                for t_done, lease in a.poll(t_now):
                    heapq.heappush(events, (t_done, next(counter), _DONE,
                                            (a.machine, lease)))
            for handle in client.poll(t_now):
                results.append(handle.result)

        # fetch the final accounting over the wire (the service client
        # API surface for fault_stats — not a core peek)
        client.request_stats()
        svc.pump(vt.t)
        client.poll(vt.t)
        stats = client.take_stats() or {}
        return ServiceResult(
            jobs=results,
            makespan=max((j.finish for j in results), default=0.0),
            placements=list(core.placements),
            fault_stats=stats.get("fault_stats"),
            mutation_stats=stats.get("mutation_stats"),
            effective=dict(core.effective),
        )
    finally:
        svc.close()
