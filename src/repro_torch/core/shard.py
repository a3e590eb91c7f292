"""Sharded online matcher: heartbeat matching at 10k+ machines.

The single flat matcher loop (`sim/cluster.py` heartbeats over one global
candidate pool) tops out around a thousand machines: every wave pays one
Python pass over all machines and one eligibility evaluation whose cost
grows with m.  This module partitions the machine axis across N scheduler
shards while keeping the paper's §5 guarantees:

  * **Eligibility fan-out** — a wave's machine-eligibility test runs as
    one batched kernel launch *per shard* (`core/engine/kernels.py`
    heartbeat ops), fanned out over a thread pool.  The launches release
    the GIL, so shards overlap on multicore hosts, and each shard's
    launch runs the device's sound-superset eligibility kernel on its own
    machine slice.  Eligibility
    columns are per-machine independent, so the block-concatenated
    result is exactly what one global launch would produce — the sharded
    wave stays **bit-identical** to the single-shard path for any shard
    count (tests/test_online_parity.py).

  * **Exposure routing** — `route_exposure` splits a `CandidateBatch`
    into disjoint per-shard slices: each job's exposed candidates are
    divided across shards proportionally to shard capacity (largest
    remainder, deterministic), so a job spanning shards offers every
    shard a proportional slice of its work.  `match_wave_routed` is the
    fully distributed mode built on it: each shard's own `Matcher`
    serves only its machine slice from its routed candidates.  That mode
    trades decision identity for locality (documented, opt-in); the
    simulator default is the decision-exact `match_wave`.

  * **Deficit handoff** — bounded unfairness composes across shards
    because deficit counters are additive: for *any* routing of
    allocations to shards, the per-group sum of shard deficits equals
    the deficit a single global counter would hold (``allocated`` adds
    ``share_g * w`` to every group and subtracts ``w`` from the served
    group — both terms route with the allocation).  `deficit_handoff`
    merges the per-group deficits and rebalances them proportionally to
    shard capacity (``d_sg = merged_g * C_s / C``), which makes each
    shard's local ``must_serve`` trigger (threshold ``kappa * C_s``)
    fire exactly when the global trigger (``kappa * C``) would at
    handoff points, and nets out opposite-sign shard deficits that
    would otherwise fire spurious must-serves.  Property-tested against
    the single-shard oracle in tests/test_shard.py.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

from . import faults
from .engine import kernels
from .engine import wave as wave_mod
from .online import CandidateBatch, Matcher, MatcherConfig

#: env var overriding the target machines-per-shard used by `auto_shards`
SHARD_MACHINES_ENV = "REPRO_SHARD_MACHINES"
_DEFAULT_SHARD_MACHINES = 2048


def shard_machines() -> int:
    """Target machines per shard for automatic shard-count selection."""
    raw = os.environ.get(SHARD_MACHINES_ENV, "")
    if raw:
        return max(int(raw), 1)
    return _DEFAULT_SHARD_MACHINES


def auto_shards(n_machines: int) -> int:
    """Shard count for a cluster size: ceil(m / shard_machines())."""
    per = shard_machines()
    return max((int(n_machines) + per - 1) // per, 1)


class ShardPlan:
    """Contiguous balanced partition of the machine axis into N shards.

    Shard s owns machines [offsets[s], offsets[s + 1]); the first
    ``m % n_shards`` shards are one machine larger.  Contiguity keeps a
    shard's avail rows a view (no gather) and makes the concatenation of
    per-shard eligibility columns line up with global machine ids.
    """

    def __init__(self, n_machines: int, n_shards: int | None = None):
        if n_machines < 1:
            raise ValueError("need at least one machine")
        if n_shards is None:
            n_shards = auto_shards(n_machines)
        n_shards = max(min(int(n_shards), n_machines), 1)
        base, extra = divmod(n_machines, n_shards)
        sizes = np.full(n_shards, base, dtype=np.int64)
        sizes[:extra] += 1
        self.n_machines = int(n_machines)
        self.n_shards = int(n_shards)
        self.sizes = sizes
        self.offsets = np.concatenate(([0], np.cumsum(sizes)))
        self.fracs = sizes / float(n_machines)

    def slices(self) -> list[slice]:
        return [slice(int(self.offsets[s]), int(self.offsets[s + 1]))
                for s in range(self.n_shards)]

    def shard_of(self, machine: int) -> int:
        """Owning shard of a global machine id."""
        return int(np.searchsorted(self.offsets, machine, side="right") - 1)


def route_exposure(batch: CandidateBatch, plan: ShardPlan) -> list[np.ndarray]:
    """Disjoint per-shard row indices: proportional slices per job.

    Walks contiguous runs of equal job id (the order `TaskPool.refresh`
    emits) and splits each run across shards proportionally to shard
    capacity via largest remainder (ties broken toward lower shard
    index), preserving within-job candidate order inside each slice.
    The result is a partition of ``range(len(batch))``: every candidate
    lands on exactly one shard, and a job spanning shards offers each a
    slice sized to that shard's capacity share.
    """
    n = len(batch)
    if plan.n_shards == 1:
        return [np.arange(n, dtype=np.int64)]
    rows: list[list[np.ndarray]] = [[] for _ in range(plan.n_shards)]
    job = batch.job
    fracs = plan.fracs
    start = 0
    while start < n:
        end = start + 1
        while end < n and job[end] == job[start]:
            end += 1
        r = end - start
        exact = fracs * r
        quota = np.floor(exact).astype(np.int64)
        short = r - int(quota.sum())
        if short:
            order = np.argsort(-(exact - quota), kind="stable")
            quota[order[:short]] += 1
        pos = start
        for s in range(plan.n_shards):
            q = int(quota[s])
            if q:
                rows[s].append(np.arange(pos, pos + q, dtype=np.int64))
                pos += q
        start = end
    return [np.concatenate(r) if r else np.empty(0, dtype=np.int64)
            for r in rows]


class ShardedMatcher:
    """Per-shard matchers + deficit ledgers behind one wave interface.

    ``match_wave`` is the simulator's heartbeat path: eligibility fans
    out one batched kernel launch per shard (thread pool), decisions run
    through a single global `Matcher` so picks, EMA observations and
    deficit updates stay bit-identical to the unsharded loop, and every
    pick is mirrored into the owning shard's ledger; the wave ends with
    a `deficit_handoff`.  ``match_wave_routed`` is the fully distributed
    variant (per-shard matchers over routed candidate slices).
    """

    def __init__(self, cfg: MatcherConfig, n_machines: int,
                 shares: dict[int, float], n_shards: int | None = None,
                 capacity: float | None = None,
                 recovery: faults.RecoveryPolicy | None = None):
        self.plan = ShardPlan(n_machines, n_shards)
        self.cfg = cfg
        self.recovery = recovery or faults.RecoveryPolicy()
        capacity = float(n_machines) if capacity is None else float(capacity)
        self.capacity = capacity
        #: global decision matcher — the single source of pick order
        self.matcher = Matcher(cfg, capacity=capacity, shares=shares)
        #: per-shard matchers: ledgers for the exact path, full matchers
        #: for the distributed path (capacity = this shard's slice of C)
        self.shard_matchers = [
            Matcher(cfg, capacity=capacity * float(f), shares=shares)
            for f in self.plan.fracs
        ]
        self.waves = 0
        self.handoffs = 0
        self.picks = 0
        #: per-shard seconds inside the heartbeat eligibility kernels
        self.kernel_secs = [0.0] * self.plan.n_shards
        self._pool: ThreadPoolExecutor | None = None
        # -- degraded-mode state (core/faults.py): per-shard launch health
        n = self.plan.n_shards
        self.quarantined = [False] * n
        self._consec_fail = [0] * n
        self._probe_wait = [0] * n
        #: wall-clock of the last probe (or quarantine entry) per shard —
        #: the probe_secs trigger, so long waves cannot starve probes
        self._probe_stamp = [0.0] * n
        self._any_quarantined = False
        self.launch_retries = 0      # retried attempts that got another try
        self.launch_failures = 0     # launches that exhausted every attempt
        self.quarantine_events = 0
        self.quarantined_launches = 0  # waves served by the all-eligible mask
        self.probe_recoveries = 0
        #: wall-seconds in failed attempts + backoff sleeps + probes
        #: (phase_recovery in the simulator, not phase_match)
        self.recovery_secs = 0.0

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ShardedMatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            workers = min(self.plan.n_shards,
                          max(os.cpu_count() or 1, 2))
            self._pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="shard-elig")
        return self._pool

    # -- eligibility fan-out --------------------------------------------

    def _launch(self, s: int, avail_rows: np.ndarray, dem: np.ndarray,
                attempt: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """One shard's batched eligibility launch (timed per shard)."""
        faults.maybe_fail("shard_launch", shard=s, wave=self.waves,
                          attempt=attempt)
        cfg = self.cfg
        fd, rigid, fung = self.matcher.fit_dim_split()
        t0 = time.perf_counter()
        out = kernels.machines_with_candidates(
            avail_rows, dem, fd, rigid, fung, cfg.max_overbook - 1.0,
            cfg.use_overbooking)
        self.kernel_secs[s] += time.perf_counter() - t0
        return out

    def _launch_on(self, device: str, s: int, avail_rows: np.ndarray,
                   dem: np.ndarray, attempt: int = 0):
        """`_launch` on an executor thread, on the caller's device (the
        device choice is per thread, `kernels.current_device`)."""
        with kernels.use_device(device):
            return self._launch(s, avail_rows, dem, attempt)

    @staticmethod
    def _conservative(avail_rows: np.ndarray,
                      dem: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The all-eligible fallback mask for one shard's machine slice.

        A sound superset of any real eligibility result — the masks only
        ever *skip* machines that provably cannot pick (see the kernels
        exactness contract), so all-True makes the wave visit every
        machine in the slice and decide identically, just slower.
        """
        n = np.atleast_2d(np.asarray(dem)).shape[0]
        m = avail_rows.shape[0]
        eligible = np.ones((n, m), dtype=bool)
        return eligible, eligible.any(axis=0)

    def _timed_attempt(self, s: int, avail_rows: np.ndarray,
                       dem: np.ndarray, attempt: int):
        """One guarded attempt, bounded by the policy's launch timeout.

        Runs on the shard executor so a hung launch (thread stuck in a
        kernel) is abandoned by timeout instead of blocking the wave; an
        abandoned thread eventually finishes or permanently occupies one
        pool slot — either way later attempts/waves keep moving, and
        repeated timeouts land the shard in quarantine.
        """
        timeout = self.recovery.launch_timeout
        if timeout is None:
            return self._launch(s, avail_rows, dem, attempt)
        fut = self._executor().submit(self._launch_on,
                                      kernels.current_device(), s,
                                      avail_rows, dem, attempt)
        return fut.result(timeout=timeout)

    def _guarded_launch(self, s: int, avail_rows: np.ndarray,
                        dem: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Degraded-mode launch: retry w/ capped backoff, quarantine after
        repeated failure, probe-recover on a wave-count OR wall-clock
        cadence (probe_every waves / probe_secs seconds, whichever trips
        first; at least one wave always passes between probes)."""
        rec = self.recovery
        if self.quarantined[s]:
            self._probe_wait[s] += 1
            due = self._probe_wait[s] >= max(rec.probe_every, 1)
            if not due and rec.probe_secs is not None:
                due = (time.monotonic() - self._probe_stamp[s]
                       >= rec.probe_secs)
            if due:
                self._probe_wait[s] = 0
                self._probe_stamp[s] = time.monotonic()
                t0 = time.perf_counter()
                try:
                    out = self._timed_attempt(s, avail_rows, dem, attempt=0)
                except Exception:
                    out = None
                self.recovery_secs += time.perf_counter() - t0
                if out is not None:
                    self.quarantined[s] = False
                    self._consec_fail[s] = 0
                    self.probe_recoveries += 1
                    self._any_quarantined = any(self.quarantined)
                    return out
            self.quarantined_launches += 1
            return self._conservative(avail_rows, dem)
        for attempt in range(rec.launch_retries + 1):
            t0 = time.perf_counter()
            try:
                out = self._timed_attempt(s, avail_rows, dem, attempt)
            except Exception:
                self.recovery_secs += time.perf_counter() - t0
                if attempt < rec.launch_retries:
                    self.launch_retries += 1
                    delay = min(rec.backoff * (2.0 ** attempt),
                                rec.backoff_cap)
                    if delay > 0:
                        time.sleep(delay)
                        self.recovery_secs += delay
            else:
                self._consec_fail[s] = 0
                return out
        self.launch_failures += 1
        self._consec_fail[s] += 1
        if self._consec_fail[s] >= max(rec.quarantine_after, 1):
            self.quarantined[s] = True
            self._probe_wait[s] = 0
            self._probe_stamp[s] = time.monotonic()
            self.quarantine_events += 1
            self._any_quarantined = True
        self.quarantined_launches += 1
        return self._conservative(avail_rows, dem)

    def eligibility(self, avail: np.ndarray,
                    dem: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Sound-superset (eligible (n, m), machine_any (m,)) for a wave.

        One kernel launch per shard, fanned out over the thread pool when
        there is more than one shard.  Columns are per-machine
        independent, so concatenating the per-shard blocks reproduces a
        single global launch exactly.

        With a fault plan active (core/faults.py) or any shard in
        quarantine, launches route through the guarded path — per-attempt
        timeout, capped-backoff retry, quarantine to the conservative
        all-eligible mask — which is decision-exact by the superset
        argument.  Without either, the healthy fast path below runs
        unchanged.

        Only the numpy wave (`engine/wave.py` ``match_wave_numpy``) calls
        this method; the routed wave calls `_launch`, the seam without the
        guard, as the reference does.  The device wave (``cuda`` and its
        plain ``torch`` twin) tests eligibility inside its own walk and
        never passes ``shard_launch``, exactly like the reference's device
        wave; the reference reaches the seam at small clusters only
        because it runs the numpy loop below 1536 machines, which the port
        selects with ``REPRO_KERNELS=match_wave=numpy``.
        """
        plan = self.plan
        slices = plan.slices()
        if faults.active_plan() is not None or self._any_quarantined:
            parts = [self._guarded_launch(s, avail[slices[s]], dem)
                     for s in range(plan.n_shards)]
        elif plan.n_shards == 1:
            return self._launch(0, avail, dem)
        else:
            dev = kernels.current_device()
            parts = list(self._executor().map(
                lambda s: self._launch_on(dev, s, avail[slices[s]], dem),
                range(plan.n_shards)))
        if plan.n_shards == 1:
            return parts[0]
        eligible = np.concatenate([p[0] for p in parts], axis=1)
        machine_any = np.concatenate([p[1] for p in parts])
        return eligible, machine_any

    # -- deficit bookkeeping --------------------------------------------

    def record_allocation(self, machine: int, group: int,
                          weight: float) -> None:
        """Mirror one allocation into the owning shard's ledger."""
        s = self.plan.shard_of(machine)
        self.shard_matchers[s].deficits.allocated(group, weight)

    def merged_deficits(self) -> dict[int, float]:
        """Per-group sum of shard deficits (== the global counter)."""
        merged: dict[int, float] = {}
        for sm in self.shard_matchers:
            for g, v in sm.deficits.deficit.items():
                merged[g] = merged.get(g, 0.0) + v
        return merged

    def deficit_handoff(self) -> dict[int, float]:
        """Merge per-group deficits and rebalance by shard capacity.

        After the handoff shard s holds ``merged_g * C_s / C`` for every
        group, so its local ``must_serve`` trigger (``kappa * C_s``) is
        equivalent to the global one (``kappa * C``), and opposite-sign
        deficits accumulated on different shards cancel instead of
        firing spurious must-serves.  Returns the merged deficits.
        """
        merged = self.merged_deficits()
        for sm, frac in zip(self.shard_matchers, self.plan.fracs):
            led = sm.deficits.deficit
            for g in led:
                led[g] = merged.get(g, 0.0) * float(frac)
        self.handoffs += 1
        return merged

    # -- decision-exact wave (simulator path) ---------------------------

    def match_wave(self, avail: np.ndarray, alive: np.ndarray,
                   batch: CandidateBatch,
                   start_cb: Callable[[int, int], None]) -> int:
        """One heartbeat wave, bit-identical to the unsharded loop.

        ``start_cb(row, machine)`` is invoked for every pick (in pick
        order) and must apply the start's side effects — including the
        ``avail[machine] -= demand`` update the next machine's matcher
        call observes.  Returns the number of tasks started.

        The wave body dispatches through the ``match_wave`` kernel op
        (`engine/wave.py`): the numpy impl is the historical host loop;
        the cuda kernel (and its plain torch version on the CPU) runs the
        whole wave in one launch over the resident matcher state,
        replaying the pick stream through ``start_cb`` — bit-identical on
        every path.
        """
        ctx = wave_mod.WaveContext(sm=self, avail=avail, alive=alive,
                                   batch=batch, start_cb=start_cb)
        n_picks = kernels.match_wave(ctx)
        self.waves += 1
        self.picks += n_picks
        if self.plan.n_shards > 1:
            self.deficit_handoff()
        return n_picks

    # -- distributed wave (routed exposure, per-shard decisions) --------

    def match_wave_routed(self, avail: np.ndarray, alive: np.ndarray,
                          batch: CandidateBatch,
                          start_cb: Callable[[int, int], None]) -> int:
        """Fully distributed wave: shard-local matchers, routed slices.

        Each shard serves only its machine slice from its proportional
        candidate slice (`route_exposure`), using its own `Matcher` (own
        EMA + deficit state).  Eligibility is still one batched launch
        per shard; the Python pick loops run sequentially because
        ``start_cb`` mutates shared simulator state.  Decisions are NOT
        identical to the global wave (candidate visibility differs) —
        bounded unfairness is preserved by the wave-end handoff instead
        (property-tested).  Returns the number of tasks started.
        """
        routed = route_exposure(batch, self.plan)
        n_picks = 0
        for s, sl in enumerate(self.plan.slices()):
            idx = routed[s]
            if len(idx) == 0:
                continue
            sub = batch.take(idx)
            eligible, machine_any = self._launch(s, avail[sl], sub.dem)
            active = np.ones(len(sub), dtype=bool)
            n_active = len(sub)
            lo = int(self.plan.offsets[s])
            local = np.argsort(-avail[sl].sum(axis=1))
            ok = (alive[sl][local] & (avail[sl][local] > 1e-9).any(axis=1)
                  & machine_any[local])
            shard_matcher = self.shard_matchers[s]
            for lm in local[ok].tolist():
                if n_active == 0:
                    break
                if not (eligible[:, lm] & active).any():
                    continue
                picks = shard_matcher.match_batch(
                    lo + lm, avail[lo + lm], sub, active=active)
                for i, _over in picks:
                    start_cb(int(idx[i]), lo + lm)
                    active[i] = False
                n_active -= len(picks)
                n_picks += len(picks)
        self.waves += 1
        self.picks += n_picks
        if self.plan.n_shards > 1:
            self.deficit_handoff()
        return n_picks

    # -- accounting -----------------------------------------------------

    def stats(self) -> dict:
        """Wave/handoff/kernel accounting for bench rows."""
        return {
            "n_shards": self.plan.n_shards,
            "waves": self.waves,
            "picks": self.picks,
            "handoffs": self.handoffs,
            "kernel_secs": [round(s, 6) for s in self.kernel_secs],
            "launch_retries": self.launch_retries,
            "launch_failures": self.launch_failures,
            "quarantines": self.quarantine_events,
            "quarantined_shards": [i for i, q in enumerate(self.quarantined)
                                   if q],
            "quarantined_launches": self.quarantined_launches,
            "probe_recoveries": self.probe_recoveries,
            "recovery_secs": round(self.recovery_secs, 6),
        }
