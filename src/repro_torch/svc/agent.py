"""Worker agents: heartbeats out, leases in.

Two shapes over one protocol:

  * `VirtualAgent` — driver-stepped and clockless, for the virtual-time
    parity/chaos suites.  The driver owns the event heap and calls
    ``heartbeat``/``poll``/``complete`` at simulated times; the agent
    only decides *whether* (fault seams) and *what* to send.
  * `Agent` — a wall-clock thread for real (tcp) deployment: connects
    with capped-backoff retry, registers, beats on a clock-derived
    schedule (a slow poll loop cannot starve beats), executes leases
    and reports completions.

Both emit heartbeats through the simulator's existing ``heartbeat``
fault seam with the same ``(machine, beat)`` context, so one chaos plan
drives the sim and the service identically.  The ``agent`` seam adds
process-level failure: ``crash``
silences the agent forever (its leases get reclaimed after
``hb_lost_after``), ``partition`` pauses all sends *and* receives for
``delay`` simulated seconds — queued traffic, retransmits and the
rejoin ladder then play out on heal.

Reconnect backoff: each
failed connect waits ``min(backoff * 2^attempt, backoff_cap)``, further
capped by ``RecoveryPolicy.probe_secs`` — a scheduler stuck in a long
wave can delay acceptance, but never push the agent's next attempt past
the probe cadence, so rejoin latency is bounded by policy, not by
backoff history.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..core import faults
from . import wire
from .comm import Channel, CommClosed, connect


class VirtualAgent:
    """Driver-stepped agent for virtual-time runs."""

    def __init__(self, machine: int, comm,
                 recovery: faults.RecoveryPolicy | None = None,
                 clock=None):
        self.machine = int(machine)
        self.ch = Channel(comm, f"agent-{self.machine}", recovery,
                          clock or (lambda: 0.0))
        self.beat_no = 0
        self.crashed = False
        self.partition_until = -float("inf")
        #: lease_id -> (job, task, t_done) of accepted, unrevoked leases
        self.active: dict[int, tuple[int, int, float]] = {}
        self._deferred: list[tuple[int, float]] = []  # partition backlog

    def register(self, t: float) -> None:
        self.ch.send(wire.REGISTER, machine=self.machine, t=t)

    def _partitioned(self, t: float) -> bool:
        return t < self.partition_until

    def heartbeat(self, t: float) -> tuple[str, float] | None:
        """One beat tick.  Returns ``("delay", t_arrive)`` when the
        heartbeat seam delays this beat — the driver schedules a
        `send_beat` then — else None (sent, dropped, or agent down)."""
        beat = self.beat_no
        self.beat_no += 1
        if self.crashed:
            return None
        sp = faults.query("agent", machine=self.machine, beat=beat)
        if sp is not None:
            if sp.kind == "crash":
                self.crashed = True
                self.active.clear()
                self._deferred.clear()
                return None
            if sp.kind == "partition":
                self.partition_until = t + max(sp.delay, 0.0)
        if self._partitioned(t):
            return None
        self._flush_deferred()
        sp = faults.query("heartbeat", machine=self.machine, beat=beat)
        if sp is not None:
            if sp.kind == "delay":
                return ("delay", t + max(sp.delay, 0.0))
            return None                                      # drop
        self.send_beat(t)
        return None

    def send_beat(self, t: float) -> None:
        """Emit one beat unconditionally (delayed-beat arrivals)."""
        if self.crashed or self._partitioned(t):
            return
        self.ch.cast(wire.HEARTBEAT, machine=self.machine, t=t)

    def poll(self, t: float) -> list[tuple[float, int]]:
        """Drain placements; returns new ``(t_done, lease_id)`` events
        for the driver to schedule."""
        if self.crashed or self._partitioned(t):
            return []
        self._flush_deferred()
        due: list[tuple[float, int]] = []
        for msg in self.ch.poll(t):
            p = msg.payload
            if msg.kind == wire.PLACE:
                t_done = float(p["t"]) + float(p["expected"])
                self.active[int(p["lease"])] = (int(p["job"]),
                                                int(p["task"]), t_done)
                due.append((t_done, int(p["lease"])))
            elif msg.kind == wire.REVOKE:
                self.active.pop(int(p["lease"]), None)
        return due

    def complete(self, lease_id: int, t: float) -> None:
        """The lease's work finished locally: report it (or queue the
        report until a partition heals)."""
        if self.crashed or lease_id not in self.active:
            return
        del self.active[lease_id]
        if self._partitioned(t):
            self._deferred.append((lease_id, t))
            return
        self.ch.send(wire.TASK_DONE, lease=lease_id, t=t)

    def _flush_deferred(self) -> None:
        for lease_id, t in self._deferred:
            self.ch.send(wire.TASK_DONE, lease=lease_id, t=t)
        self._deferred.clear()


class Agent:
    """Wall-clock worker agent (tcp deployment shape).

    ``clock``/``sleep``/``connector`` are injectable for the
    monkeypatched-clock regression tests; ``time_scale`` compresses
    lease durations (a lease for 30 simulated seconds occupies the
    agent for ``30 * time_scale`` wall seconds before it reports
    completion at the *simulated* finish time).
    """

    def __init__(self, addr: str, machine: int, period: float = 0.5,
                 recovery: faults.RecoveryPolicy | None = None,
                 time_scale: float = 0.0, clock=time.monotonic,
                 sleep=time.sleep, connector=connect):
        self.addr = addr
        self.machine = int(machine)
        self.period = period
        self.recovery = recovery or faults.RecoveryPolicy()
        self.time_scale = time_scale
        self._clock = clock
        self._sleep = sleep
        self._connector = connector
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._done_q: deque = deque()       # (lease, t_done) from timers
        self.reconnect_delays: list[float] = []
        self.beats: list[float] = []
        self.completed: list[int] = []

    # -- reconnect backoff (testable in isolation) ----------------------

    def backoff_delay(self, attempt: int) -> float:
        rec = self.recovery
        delay = min(rec.backoff * (2.0 ** attempt), rec.backoff_cap)
        if rec.probe_secs is not None:
            delay = min(delay, rec.probe_secs)
        return delay

    def connect_with_retry(self, max_attempts: int | None = None):
        attempt = 0
        while not self._stop.is_set():
            try:
                return self._connector(self.addr)
            except (CommClosed, OSError):
                if max_attempts is not None and attempt + 1 >= max_attempts:
                    raise
                delay = self.backoff_delay(attempt)
                self.reconnect_delays.append(delay)
                self._sleep(delay)
                attempt += 1
        return None

    # -- the serving loop -----------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run,
                                        name=f"repro-agent-{self.machine}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def run(self) -> None:
        while not self._stop.is_set():
            comm = self.connect_with_retry()
            if comm is None:
                return
            ch = Channel(comm, f"agent-{self.machine}", self.recovery,
                         self._clock)
            ch.send(wire.REGISTER, machine=self.machine, t=self._clock())
            next_beat = self._clock()
            while not self._stop.is_set() and not comm.closed:
                next_beat = self.step(ch, next_beat)
                self._sleep(min(self.period / 4.0, 0.02))
            comm.close()
            # connection gone: fall through to the reconnect loop

    def step(self, ch: Channel, next_beat: float) -> float:
        """One poll-loop iteration; returns the updated beat deadline.

        The deadline advances off the *clock*, not the iteration count:
        however long a poll (or a scheduler wave on the other side)
        takes, the next beat is due ``period`` after the last one fired.
        """
        now = self._clock()
        if now >= next_beat:
            beat = len(self.beats)
            self.beats.append(now)
            if faults.query("heartbeat", machine=self.machine,
                            beat=beat) is None:
                ch.cast(wire.HEARTBEAT, machine=self.machine, t=now)
            next_beat = now + self.period
        for msg in ch.poll(now):
            p = msg.payload
            if msg.kind == wire.PLACE:
                self._execute(int(p["lease"]), float(p["expected"]),
                              float(p["t"]) + float(p["expected"]))
            elif msg.kind == wire.REVOKE:
                self._done_q = deque((lz, tz) for lz, tz in self._done_q
                                     if lz != int(p["lease"]))
        while self._done_q:
            lease, t_done = self._done_q.popleft()
            ch.send(wire.TASK_DONE, lease=lease, t=t_done)
            self.completed.append(lease)
        return next_beat

    def _execute(self, lease: int, expected: float, t_done: float) -> None:
        """Run one lease: occupy ``expected * time_scale`` wall seconds,
        then report completion at the simulated finish time."""
        if self.time_scale > 0.0:
            timer = threading.Timer(expected * self.time_scale,
                                    self._done_q.append,
                                    args=((lease, t_done),))
            timer.daemon = True
            timer.start()
        else:
            self._done_q.append((lease, t_done))
